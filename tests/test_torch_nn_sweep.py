"""The port's nearest-neighbour sweep (pointcloud_tpu_torch.ops.nn_sweep)
against the JAX package: its plain version vs the TPU kernel in interpret
mode and vs the dense path of chamfer._nn_forward, on the CPU.

The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_utils import to_np

from pointcloud_tpu.ops.chamfer import _nn_forward
from pointcloud_tpu.ops.pallas_kernels import nearest_neighbor_pallas
from pointcloud_tpu_torch.ops import nn_sweep, nn_sweep_reference

BIG = 1e10


def clouds(seed, C, masked, B=2, N=128, M=96):
    """Unit-cube clouds with exact ties: target 50 duplicates target 10 and
    query 5 sits on it; x point 70 duplicates x point 20 and y point 3 sits
    on it. With masks ~10% of points are masked, never the tied ones."""
    rng = np.random.default_rng(seed)
    x = rng.random((B, N, C), dtype=np.float32)
    y = rng.random((B, M, C), dtype=np.float32)
    y[:, 50] = y[:, 10]
    x[:, 5] = y[:, 10]
    x[:, 70] = x[:, 20]
    y[:, 3] = x[:, 20]
    xm = ym = None
    if masked:
        xm = rng.random((B, N)) > 0.1
        ym = rng.random((B, M)) > 0.1
        xm[:, [5, 20, 70]] = True
        ym[:, [3, 10, 50]] = True
    return x, y, xm, ym


def port(x, y, xm, ym):
    t = (lambda a: None if a is None else torch.from_numpy(a))
    return [to_np(o) for o in nn_sweep_reference(t(x), t(y), t(xm), t(ym))]


CASES = [(C, masked) for C in (3, 6) for masked in (False, True)]


@pytest.mark.parametrize("C,masked", CASES)
def test_reference_matches_dense_path(C, masked):
    """Values agree where the query is valid, argmins are equal, masked
    queries are >= 1e10. Both sides build the same fp32 matmul expansion
    s2 - 2<x,y> + d2; only the BLAS summation order differs, which moves s2,
    d2 and the cross term by an ulp or two. Their largest term is
    |x|^2 + |y|^2 <= 2C for unit-cube clouds, so the tolerance is 2 ulp of
    2C (an fp32 ulp of v is at most v * 2^-23): 1.4e-6 at C=3, 2.9e-6 at
    C=6."""
    x, y, xm, ym = clouds(C, C, masked)
    ones = lambda a, n: np.ones(a.shape[:2], np.float32) if n is None \
        else n.astype(np.float32)
    want = [np.asarray(o) for o in _nn_forward(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(ones(x, xm)),
        jnp.asarray(ones(y, ym)))]
    got = port(x, y, xm, ym)
    atol = 2 * (2 * C) * 2.0 ** -23
    xv = np.ones(x.shape[:2], bool) if xm is None else xm
    yv = np.ones(y.shape[:2], bool) if ym is None else ym
    np.testing.assert_allclose(got[0][xv], want[0][xv], atol=atol, rtol=0)
    np.testing.assert_allclose(got[2][yv], want[2][yv], atol=atol, rtol=0)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[3], want[3])
    assert (got[0][~xv] >= BIG).all() and (got[2][~yv] >= BIG).all()
    assert got[1].dtype == np.int32 and got[3].dtype == np.int32


@pytest.mark.parametrize("C,masked", CASES)
def test_reference_matches_pallas_kernel(C, masked):
    """vs nearest_neighbor_pallas in interpret mode: the TPU kernel builds
    its cross term from split-bf16 operands (~3e-5 error), so values agree
    to 1e-4 and argmins on >= 99% of valid points; masked rows are >= 1e10
    on both sides."""
    x, y, xm, ym = clouds(10 + C, C, masked)
    j = (lambda a: None if a is None else jnp.asarray(a))
    want = [np.asarray(o) for o in nearest_neighbor_pallas(
        j(x), j(y), j(xm), j(ym), interpret=True)]
    got = port(x, y, xm, ym)
    for (v, i), valid in (((0, 1), xm), ((2, 3), ym)):
        valid = np.ones(got[v].shape, bool) if valid is None else valid
        assert np.abs(got[v] - want[v])[valid].max() <= 1e-4
        assert (got[i] == want[i])[valid].mean() >= 0.99
        assert (got[v][~valid] >= BIG).all() and (want[v][~valid] >= BIG).all()


@pytest.mark.parametrize("C", [3, 6])
def test_first_index_wins_ties(C):
    x, y, xm, ym = clouds(20 + C, C, masked=True)
    min_x, amin_x, min_y, amin_y = port(x, y, xm, ym)
    np.testing.assert_array_equal(amin_x[:, 5], [10, 10])
    np.testing.assert_array_equal(amin_y[:, 3], [20, 20])
    # zero up to the expansion's round-off
    assert (min_x[:, 5] <= 1e-6).all() and (min_y[:, 3] <= 1e-6).all()


def test_no_valid_target_gives_big_and_index_zero():
    """A batch element whose targets are all masked: every query gets 1e10
    and index 0, as the dense path's where(mask, d, BIG) gives."""
    x, y, _, _ = clouds(3, 3, masked=False)
    xm = np.ones(x.shape[:2], bool)
    ym = np.ones(y.shape[:2], bool)
    ym[1] = False
    min_x, amin_x, min_y, _ = port(x, y, xm, ym)
    assert (min_x[1] == BIG).all() and (amin_x[1] == 0).all()
    assert (min_x[0] < 1).all() and (min_y[0] < 1).all()
    assert (min_y[1] >= BIG).all()  # the masked y points are queries too


def test_cpu_tensors_take_plain_version_without_launch():
    x, y, xm, ym = clouds(4, 6, masked=True)
    t = [torch.from_numpy(a) for a in (x, y, xm, ym)]
    before = nn_sweep.launches
    got = [to_np(o) for o in nn_sweep(*t)]
    assert nn_sweep.launches == before
    for g, w in zip(got, port(x, y, xm, ym)):
        np.testing.assert_array_equal(g, w)


def test_rejects_bad_shapes_and_masks():
    x = torch.rand(2, 16, 3)
    with pytest.raises(ValueError):
        nn_sweep(x, torch.rand(3, 16, 3))  # batch mismatch
    with pytest.raises(ValueError):
        nn_sweep(x, torch.rand(2, 16, 4))  # dims mismatch
    with pytest.raises(ValueError):
        nn_sweep(x, x, x_mask=torch.ones(2, 16))  # float mask
    with pytest.raises(ValueError):
        nn_sweep(x, x, y_mask=torch.ones(2, 15, dtype=torch.bool))
