"""`nn_plan` and the operand split of csrc/nn_sweep.cu, on the CPU.

The kernel forms every pair's cost |q|^2 + |t|^2 - 2 q.t as one bf16
tensor-core product of depth K = 6C + 6 (padded to 16): each fp32 value
split three ways into bf16, six cross products a dimension, the norms as
three columns each against 1s, both clouds centred on a valid point
(`nn_centre`). `nn_operands` is that split's plain mirror. Held here: the
plan's depth, shared memory (within the card's 227 KB at every C), chunks
and splits at the driven shapes, a ragged shape and the shapes no plan
takes; the centre's choice; the mirror's float64 products against direct
differences within the split's bound, also beside a masked point 1e3 out;
and the expansion's first argmin against the direct one wherever the
direct runner-up is farther than twice that bound.
"""

import numpy as np
import pytest
import torch

from pointcloud_tpu_torch.ops import nn_plan
from pointcloud_tpu_torch.ops._launch import SMEM_LIMIT
from pointcloud_tpu_torch.ops.geometry import pairwise_sqdist
from pointcloud_tpu_torch.ops.nn_sweep import nn_centre, nn_depth, nn_operands

# the split drops products below 2^-22 of |q||t| a dimension and rounds each
# norm's last part: |expansion - direct| <= 2^-21 (|q - r|^2 + |t - r|^2)
SPLIT_BOUND = 2.0 ** -21


@pytest.mark.parametrize("C", range(1, 9))
def test_depth_is_six_columns_a_dimension_and_six_for_the_norms(C):
    K = nn_depth(C)
    assert K % 16 == 0 and 6 * C + 6 <= K < 6 * C + 6 + 16
    plan = nn_plan(512, 2048, 2048, C)
    assert plan.depth == K


@pytest.mark.parametrize("C", range(1, 9))
@pytest.mark.parametrize("N,M", [(2048, 2048), (1000, 2500), (1, 1), (50_000, 70_000)])
def test_shared_memory_fits_and_chunks_cover_the_longer_cloud(C, N, M):
    """The resident chunk is whole 128-column products, as long as fits
    beside the four warpgroups' query tiles; the chunks cover the longer
    cloud once; the bytes are the kernel's own layout."""
    plan = nn_plan(3, N, M, C)
    K = plan.depth
    assert plan.smem <= SMEM_LIMIT
    assert plan.smem == plan.chunk * 2 * K + 4 * 64 * 2 * K + plan.chunk // 128 * 16 + 1024
    assert plan.chunk % 128 == 0
    assert (plan.chunks - 1) * plan.chunk < max(N, M) <= plan.chunks * plan.chunk
    # one more product would not fit, unless the cloud needs no more
    more = plan.smem + 128 * 2 * K + 16
    assert more > SMEM_LIMIT or plan.chunk >= max(N, M)


@pytest.mark.parametrize("C,chunk", [(1, 6912), (3, 3328), (6, 2048), (7, 2048),
                                     (8, 1536)])
def test_largest_chunk_per_depth(C, chunk):
    assert nn_plan(1, 100_000, 100_000, C).chunk == chunk


# (B, N, M, C): (chunk, chunks, splits, blocks)
DRIVEN = {
    "PointNet eval": ((512, 2048, 2048, 6), (2048, 1, 1, 1024)),
    "PointNet / PointNet2 train": ((256, 2048, 2048, 6), (2048, 1, 1, 512)),
    "PointMLP / MSG": ((32, 2048, 2048, 6), (2048, 1, 2, 128)),
    "card vs CPU": ((2, 2048, 2048, 6), (2048, 1, 8, 32)),
    "ragged, C = 8": ((3, 1000, 2500, 8), (1536, 2, 10, 60)),
}


@pytest.mark.parametrize("name", DRIVEN)
def test_driven_shapes(name):
    shape, (chunk, chunks, splits, blocks) = DRIVEN[name]
    plan = nn_plan(*shape)
    assert (plan.chunk, plan.chunks, plan.splits, plan.blocks) == (chunk, chunks, splits,
                                                                   blocks)
    # every block of a split has a query tile of its own
    tiles = -(-max(shape[1], shape[2]) // 64)
    assert (splits - 1) * 4 < tiles


@pytest.mark.parametrize("shape", [(0, 10, 10, 3), (2, 0, 10, 3), (2, 10, 0, 3),
                                   (2, 10, 10, 0), (2, 10, 10, 9), (65536, 10, 10, 3),
                                   (2, (1 << 30) + 1, 10, 3)])
def test_shapes_no_plan_takes_are_refused(shape):
    with pytest.raises(ValueError):
        nn_plan(*shape)


def clouds(seed, B, N, M, C):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.random((B, N, C), dtype=np.float32)),
            torch.from_numpy(rng.random((B, M, C), dtype=np.float32)))


@pytest.mark.parametrize("C", range(1, 9))
def test_split_products_reproduce_direct_differences(C):
    """Unit-cube clouds: the mirror's operands, multiplied in float64,
    within 2^-21 of the centred norms' sum of the direct (float64) squared
    distance of the same fp32 points."""
    x, y = clouds(C, 2, 300, 451, C)
    ref = nn_centre(x, y)
    assert torch.equal(ref, x[:, 0])  # no masks: x's first point
    A, T = nn_operands(x, y, ref)
    assert A.dtype == torch.bfloat16 and A.shape == (2, 300, nn_depth(C))
    cost = A.double() @ T.double().transpose(1, 2)
    direct = pairwise_sqdist(x.double(), y.double(), method="direct")
    scale = (((x - ref[:, None]) ** 2).sum(-1).double()[:, :, None]
             + ((y - ref[:, None]) ** 2).sum(-1).double()[:, None, :])
    assert float(((cost - direct).abs() / scale).max()) <= SPLIT_BOUND


@pytest.mark.parametrize("C", [1, 3, 6, 8])
def test_split_layout(C):
    """A query row: -2v split as (h, h, h, m, m, l) a dimension, then the
    norm's three parts and three 1s; a target row: (h, m, l, h, m, h), then
    three 1s and the norm's parts; zeros to K. h + m + l is v within 2^-24
    of |v|, and the query's parts are -2 times the target-side split of the
    same value."""
    x, _ = clouds(10 + C, 1, 64, 1, C)
    ref = torch.zeros((1, C))
    A, T = nn_operands(x, x, ref)
    K = nn_depth(C)
    a, t = A.float()[0], T.float()[0]
    for c in range(C):
        h, m, lo = t[:, 6 * c], t[:, 6 * c + 1], t[:, 6 * c + 2]
        assert torch.equal(t[:, 6 * c + 3], h) and torch.equal(t[:, 6 * c + 4], m)
        assert torch.equal(t[:, 6 * c + 5], h)
        v = x[0, :, c].double()
        assert float(((h.double() + m.double() + lo.double()) - v).abs().max()) \
            <= 2.0 ** -24 * float(v.abs().max())
        assert torch.equal(a[:, 6 * c], -2 * h) and torch.equal(a[:, 6 * c + 1], -2 * h)
        assert torch.equal(a[:, 6 * c + 3], -2 * m) and torch.equal(a[:, 6 * c + 5], -2 * lo)
    o = 6 * C
    assert bool((a[:, o + 3:o + 6] == 1).all()) and bool((t[:, o:o + 3] == 1).all())
    assert torch.equal(a[:, o:o + 3], t[:, o + 3:o + 6])  # the same norm, split once
    assert bool((a[:, o + 6:K] == 0).all()) and bool((t[:, o + 6:K] == 0).all())


@pytest.mark.parametrize("C", [3, 6, 8])
def test_expansion_argmin_matches_direct_off_near_ties(C):
    """The first argmin over the mirror's costs equals the direct one for
    every query whose direct runner-up is farther than twice the split's
    bound, and such queries are the rule, not the exception."""
    x, y = clouds(20 + C, 2, 500, 700, C)
    A, T = nn_operands(x, y, nn_centre(x, y))
    cost = A.double() @ T.double().transpose(1, 2)
    direct = pairwise_sqdist(x.double(), y.double(), method="direct")
    scale = (((x - x[:, :1]) ** 2).sum(-1).double()[:, :, None]
             + ((y - x[:, :1]) ** 2).sum(-1).double()[:, None, :])
    top = torch.topk(direct, 2, dim=2, largest=False)
    slack = 2 * SPLIT_BOUND * float(scale.max())
    clear = top.values[..., 1] - top.values[..., 0] > slack
    assert float(clear.float().mean()) > 0.9
    assert bool((torch.argmin(cost, dim=2) == top.indices[..., 0])[clear].all())


def split_error(x, y, ref):
    """|float64 products of the mirror's operands - direct| of every pair."""
    A, T = nn_operands(x, y, ref)
    cost = A.double() @ T.double().transpose(1, 2)
    return (cost - pairwise_sqdist(x.double(), y.double(), method="direct")).abs()


@pytest.mark.parametrize("case", ["no masks", "x[0] masked", "x all masked",
                                  "both all masked"])
def test_centre_is_the_first_valid_point(case):
    """x's first valid point, else y's first valid point, else x's first."""
    x, y = clouds(30, 2, 40, 50, 3)
    xm = torch.ones((2, 40), dtype=torch.bool)
    ym = torch.ones((2, 50), dtype=torch.bool)
    want = x[:, 0].clone()
    if case == "x[0] masked":
        xm[0, :3] = False
        xm[1, 0] = False
        want = torch.stack([x[0, 3], x[1, 1]])
    elif case == "x all masked":
        xm[:] = False
        ym[0, :7] = False
        want = torch.stack([y[0, 7], y[1, 0]])
    elif case == "both all masked":
        xm[:] = False
        ym[:] = False
    masks = (None, None) if case == "no masks" else (xm, ym)
    assert torch.equal(nn_centre(x, y, *masks), want)


@pytest.mark.parametrize("C", [1, 3, 6, 8])
def test_a_masked_point_far_out_is_no_centre(C):
    """x point 0 masked and 1e3 out in every dimension: centred on
    `nn_centre`'s valid point, the split's products of the valid pairs stay
    within its bound of the unit cube's norms (far inside the checks' 1e-5);
    centred on x point 0 they would pass 1e-5."""
    x, y = clouds(40 + C, 2, 200, 300, C)
    x[:, 0] = 1e3
    xm = torch.ones((2, 200), dtype=torch.bool)
    xm[:, 0] = False
    valid = xm[:, :, None].expand(-1, -1, 300)
    good = split_error(x, y, nn_centre(x, y, xm, None))[valid]
    assert float(good.max()) <= SPLIT_BOUND * 2 * C  # centred norms <= C each
    bad = split_error(x, y, x[:, 0])[valid]
    assert float(bad.max()) > 1e-5
