"""Launch geometry that the kernels' plans share: the card's SM count, the
dynamic shared memory a block may have, and the split of rows into chunks
that fill whole waves of blocks."""

from __future__ import annotations

import functools

import torch

SMS = 132  # streaming multiprocessors of an H100 SXM
SMEM_LIMIT = 232_448  # dynamic shared memory a block may have on an H100
WAVES = 4  # waves of blocks a split launch may take (one resident an SM)


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def split(rows: int, granule: int, blocks_per_chunk: int, sms: int) -> tuple:
    """(chunk rows, chunks): whole granules a chunk, the `blocks_per_chunk`
    tiles of every chunk one block each, one block resident an SM. Of the
    counts that fit WAVES waves, the one whose waves times granules a
    block is least (the fewest chunks on a tie): a last wave that is mostly
    idle costs a whole wave."""
    granules = -(-rows // granule)
    best = None
    most = min(granules, max(1, WAVES * sms // blocks_per_chunk))
    for want in range(1, most + 1):
        per = -(-granules // want)
        chunks = -(-granules // per)
        cost = -(-chunks * blocks_per_chunk // sms) * per
        if best is None or cost < best[0]:
            best = (cost, per * granule, chunks)
    return best[1], best[2]
