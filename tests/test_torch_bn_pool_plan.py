"""`bn_pool_plan` and the pool kernel's merge order, on the CPU.

csrc/mlp_chain.cu's bn_pool_kernel gives a thread 8 channels of one group
(16-byte loads; one channel where the width is no multiple of 8 or a base
is not 16-byte aligned) over a slice of the group's rows: rows y, y +
slices, ... A slice keeps its first row and takes a later one on a strictly
larger value; the slices then merge in slice order, taking the other
slice's (value, row) on a larger value or an equal value at a lower row.
Held here: the plan at every driven shape (PointNet2's SA1 / SA2 / SA3 at
B=256, PointMLP's and Elite's four stages at B=32, the MSG group-all level
at B=32); over a sweep of shapes, that the blocks cover every (group,
channel) once with at most 256 threads and a row for every slice; shapes
no launch takes raise. `pool_model` mirrors the slices and the merge; with
planted ties (equal values at several rows, across slices and within
one), a group with every row masked and rows that are all equal, it gives
the plain version's max, row and h at that row exactly.
"""

import numpy as np
import pytest
import torch

from pointcloud_tpu_torch.ops import bn_pool, bn_pool_plan, bn_pool_reference
from pointcloud_tpu_torch.ops.preextract_fused import RES_BNRELU, RES_DENSE, RES_NONE

BF, F32 = torch.bfloat16, torch.float32

# name: (groups, C, pool, dtype, res_mode) -> (vec, strips, slices, rows,
# per_block, threads, blocks)
DRIVEN = {
    "PointNet2 SA1": ((256 * 512, 128, 32, BF, RES_NONE),
                      (8, 16, 1, 32, 16, 256, (8192, 1))),
    "PointNet2 SA2": ((256 * 128, 256, 64, BF, RES_NONE),
                      (8, 32, 1, 64, 8, 256, (4096, 1))),
    "PointNet2 SA3": ((256, 1024, 128, BF, RES_NONE),
                      (8, 32, 2, 64, 4, 256, (64, 4))),
    "PointMLP stage 1": ((32 * 1024, 128, 24, BF, RES_DENSE),
                         (8, 16, 1, 24, 16, 256, (2048, 1))),
    "PointMLP stage 4": ((32 * 128, 1024, 24, BF, RES_DENSE),
                         (8, 32, 1, 24, 8, 256, (512, 4))),
    "Elite stage 1": ((32 * 1024, 64, 24, BF, RES_BNRELU),
                      (8, 8, 1, 24, 32, 256, (1024, 1))),
    "Elite stage 4": ((32 * 128, 256, 24, BF, RES_BNRELU),
                      (8, 32, 1, 24, 8, 256, (512, 1))),
    "MSG group-all": ((32, 1024, 128, BF, RES_NONE),
                      (8, 32, 8, 16, 1, 256, (32, 4))),
}


@pytest.mark.parametrize("name", DRIVEN)
def test_driven_shapes_take_their_launch(name):
    shape, want = DRIVEN[name]
    assert tuple(bn_pool_plan(*shape)) == want


@pytest.mark.parametrize("groups", [1, 3, 256, 100000])
@pytest.mark.parametrize("C", [1, 7, 8, 40, 130, 256, 1024, 1032])
@pytest.mark.parametrize("pool", [1, 4, 24, 128])
@pytest.mark.parametrize("dtype,res", [(BF, RES_NONE), (F32, RES_BNRELU), (BF, RES_DENSE)])
def test_geometry_covers_every_group_and_channel_once(groups, C, pool, dtype, res):
    p = bn_pool_plan(groups, C, pool, dtype, res)
    assert p.vec == (8 if C % 8 == 0 else 1)
    lanes = C // p.vec
    assert p.threads == p.strips * p.slices * p.per_block <= 256
    assert (p.blocks[0] - 1) * p.per_block < groups <= p.blocks[0] * p.per_block
    assert (p.blocks[1] - 1) * p.strips < lanes <= p.blocks[1] * p.strips
    assert 1 <= p.slices <= pool and p.slices & (p.slices - 1) == 0
    assert p.rows == -(-pool // p.slices)
    assert bn_pool_plan(groups, C, pool, dtype, res, aligned=False).vec == 1


@pytest.mark.parametrize("groups,C,pool,res", [(0, 8, 4, 0), (2, 0, 4, 0), (2, 8, 0, 0),
                                               (2, 8, 4, 3)])
def test_shapes_no_launch_takes_are_refused(groups, C, pool, res):
    with pytest.raises(ValueError):
        bn_pool_plan(groups, C, pool, BF, res)
    with pytest.raises(TypeError):
        bn_pool_plan(2, 8, 4, torch.float16, 0)


def pool_model(v, h, slices):
    """The kernel's pool of v (G, pool, C) fp32 with h (G, pool, C): each
    slice y keeps its best of rows y, y + slices, .. by a strict >, then
    slice 0 merges slices 1, 2, .. in order (a larger value, or an equal
    one at a lower row). Returns (maxv, amax, hsel)."""
    G, pool, C = v.shape
    best = np.empty((G, C), np.float32)
    arg = np.empty((G, C), np.int64)
    for g in range(G):
        for c in range(C):
            kept = []
            for y in range(min(slices, pool)):
                bv, bi = None, None
                for r in range(y, pool, slices):
                    if bv is None or v[g, r, c] > bv:
                        bv, bi = v[g, r, c], r
                kept.append((bv, bi))
            bv, bi = kept[0]
            for ov, oi in kept[1:]:
                if ov > bv or (ov == bv and oi < bi):
                    bv, bi = ov, oi
            best[g, c], arg[g, c] = bv, bi
    return best, arg, np.take_along_axis(h, arg[:, None], 1)[:, 0]


@pytest.mark.parametrize("slices", [1, 2, 4, 8, 32])
@pytest.mark.parametrize("res", [None, "bnrelu", "dense"])
def test_pool_model_matches_the_plain_version_on_ties(slices, res):
    """Values planted equal at rows 3, 5 and 17 of group 0 (across and
    within slices) and at every row of group 1; group 2 fully masked."""
    rng = np.random.default_rng(slices)
    B, G, pool, C = 1, 4, 32, 16
    h = rng.standard_normal((B, G * pool, C)).astype(np.float32)
    h = torch.from_numpy(h).bfloat16().float().numpy()  # bf16-representable
    h[0, [3, 5, 17]] = h[0, 40]
    h[0, pool:2 * pool] = h[0, pool]
    sc = torch.from_numpy(np.stack([rng.standard_normal(C), rng.random(C) + 0.5,
                                    rng.standard_normal(C),
                                    np.ones(C)]).astype(np.float32))
    pen = np.zeros((B, G * pool), np.float32)
    pen[0, 2 * pool:3 * pool] = 1e9
    pen[0, 9] = 1e9
    th = torch.from_numpy(h)
    rres = {None: None, "dense": torch.from_numpy(np.tile(h[:, :1], (1, G * pool, 1))),
            "bnrelu": (torch.from_numpy(np.tile(h[:, :1], (1, G * pool, 1))), sc)}[res]
    out, maxv, amax, hsel = bn_pool_reference(th, sc, torch.from_numpy(pen), pool,
                                              res=rres)
    v = (th - sc[0]) * sc[1] + sc[2]
    if res == "dense":
        v = v + rres
    elif res == "bnrelu":
        v = v + torch.where((rres[0] - sc[0]) * sc[1] + sc[2] > 0,
                            (rres[0] - sc[0]) * sc[1] + sc[2], 0.0)
    v = (v - torch.from_numpy(pen)[..., None]).numpy().reshape(G, pool, C)
    best, arg, sel = pool_model(v, h.reshape(G, pool, C), slices)
    np.testing.assert_array_equal(best, maxv.numpy()[0])
    np.testing.assert_array_equal(arg, amax.numpy()[0])
    np.testing.assert_array_equal(sel, hsel.numpy()[0])
    assert (amax[0, 1] == 0).all()  # a group of equal rows: the first
    assert (out[0, 2] == -1e9).all()  # no valid row


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(5)
    h = torch.from_numpy(rng.standard_normal((2, 48, 24)).astype(np.float32))
    sc = torch.from_numpy(np.stack([np.zeros(24), np.ones(24), np.zeros(24),
                                    np.ones(24)]).astype(np.float32))
    before = bn_pool.launches
    got = bn_pool(h, sc, None, 4)
    want = bn_pool_reference(h, sc, None, 4)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert bn_pool.launches == before
