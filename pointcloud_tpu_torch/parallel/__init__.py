"""Parallelism over torch.distributed: process groups, data-parallel
training, ring collectives (port of pointcloud_tpu/parallel).

`data_mesh`, `replicate`, `shard_batch` (the train harness's) and the ring
functions load on first use: the ops import `parallel.distributed`, and the
harness and the ring import the ops.
"""

from pointcloud_tpu_torch.parallel.distributed import (
    global_mesh,
    initialize,
    process_local_batch_slice,
)

__all__ = [
    "data_mesh",
    "replicate",
    "shard_batch",
    "ring_chamfer",
    "ring_sinkhorn_match",
    "initialize",
    "global_mesh",
    "process_local_batch_slice",
]

_LAZY = {
    "data_mesh": "mesh",
    "replicate": "mesh",
    "shard_batch": "mesh",
    "ring_chamfer": "ring",
    "ring_sinkhorn_match": "ring",
}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"), name)
