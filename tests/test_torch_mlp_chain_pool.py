"""The port's MLPChainPool and bias-free DenseBNMaxPool against
pointcloud_tpu.models.pointnet on the CPU, on the same random flax
variables converted by interop: eval (running statistics) and train mode
(batch statistics: the output, the gradients of a fixed random projection
of it to the input and every parameter, and the running statistics after
the step), with final_relu both ways, a mask, and a cloud whose every point
is masked (-1e9 in both packages; its points still feed the batch
statistics, and so the gradient, as in the JAX package).

The JAX MLPChainPool takes its XLA reference chain on the CPU
(mlp_pool_reference), the port's its plain chain; both are the same
function (tests/test_torch_mlp_chain.py holds the chains' passes against
the interpret-mode Pallas kernels). fp32, sums in other orders: outputs
1e-5 absolute and relative, gradients and statistics 1e-4 of each tensor's
largest entry. The whole-cloud pools of these seeds keep their best row
3e-6 above the runner-up (record_pool_gaps), so both packages send a
pooled gradient to the same row.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_utils import jax_variables, record_pool_gaps, to_np, train_mode_pair

from pointcloud_tpu.models import pointnet as jpn
from pointcloud_tpu_torch.interop import load_flax_variables
from pointcloud_tpu_torch.models import pointnet as tpn

FEATS = (16, 24, 32)
B, N, CIN = 3, 40, 6
TOL = dict(atol=1e-5, rtol=1e-5)


def inputs(seed, masked):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, N, CIN)).astype(np.float32)
    mask = None
    if masked:
        mask = rng.random((B, N)) > 0.25
        mask[2] = False  # a cloud without a valid point
    return x, mask


def modules(kind, final_relu):
    if kind == "chain":
        return (jpn.MLPChainPool(FEATS, final_relu=final_relu),
                tpn.MLPChainPool(CIN, FEATS, final_relu=final_relu))
    return (jpn.DenseBNMaxPool(FEATS[-1], final_relu=final_relu, use_bias=False),
            tpn.DenseBNMaxPool(CIN, FEATS[-1], final_relu=final_relu, use_bias=False))


def loaded(kind, final_relu, x, seed):
    jm, tm = modules(kind, final_relu)
    v = jax_variables(jm, x, seed)
    load_flax_variables(tm, v)
    return jm, tm, v


def grads_close(got, want, what):
    for k, w in want.items():
        top = float(np.abs(w).max())
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-4 * top + 1e-12,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("kind", ["chain", "dense"])
@pytest.mark.parametrize("final_relu", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_eval_matches_jax(kind, final_relu, masked):
    x, mask = inputs(0, masked)
    jm, tm, v = loaded(kind, final_relu, x, 1)
    kw = {} if mask is None else {"mask": jnp.asarray(mask)}
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False, **kw))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x), train=False,
                 mask=None if mask is None else torch.from_numpy(mask))
    assert got.shape == (B, FEATS[-1])
    np.testing.assert_allclose(to_np(got), want, **TOL)
    if masked:
        assert (to_np(got)[2] == -1e9).all()


@pytest.mark.parametrize("kind", ["chain", "dense"])
@pytest.mark.parametrize("final_relu", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_train_mode_matches_jax(kind, final_relu, masked, monkeypatch):
    gaps = record_pool_gaps(monkeypatch)
    x, mask = inputs(2, masked)
    jm, tm, v = loaded(kind, final_relu, x, 3)
    kw = {} if mask is None else {"mask": mask}
    pair = train_mode_pair(jm, tm, v, x, 4, **kw)
    (jout, jg, js, jdx), (tout, tg, ts, tdx) = pair["jax"], pair["port"]
    if kind == "chain":
        assert gaps and min(gaps) > 3e-6
    assert tout.shape == (B, FEATS[-1])
    np.testing.assert_allclose(tout, jout, **TOL)
    if masked:  # the empty cloud: the sentinel
        assert (tout[2] == -1e9).all()
    grads_close(tg, jg, "gradient")
    grads_close(ts, js, "statistics")
    # the empty cloud's rows still reach the gradient through the batch
    # statistics, in both packages
    np.testing.assert_allclose(tdx, jdx, rtol=1e-4, atol=1e-4 * np.abs(jdx).max())


def test_bias_free_dense_registers_no_bias():
    _, tm = modules("dense", False)
    assert tm.bias is None and "bias" not in tm.state_dict()
    assert set(tm.state_dict()) == {"weight", "scale", "offset", "mean", "var"}
    chain = modules("chain", False)[1]
    assert set(chain.state_dict()) == {f"{n}{i}" for i in range(3)
                                       for n in ("w", "scale", "offset", "mean", "var")}


@pytest.mark.parametrize("train", [False, True])
def test_chain_is_pointwise_mlp_then_bias_free_dense_pool(train):
    """MLPChainPool == PointwiseMLP(features[:-1]) + DenseBNMaxPool(last,
    use_bias=False) in the port, as in the JAX package's test: same values
    on the same weights (the composition's Dense biases at zero)."""
    x, mask = inputs(5, True)
    chain = tpn.MLPChainPool(CIN, FEATS, final_relu=True)
    from pointcloud_tpu_torch.models.layers import init_flax_

    init_flax_(chain, torch.Generator().manual_seed(0))
    mlp = tpn.PointwiseMLP(CIN, FEATS[:-1])
    pool = tpn.DenseBNMaxPool(FEATS[1], FEATS[2], final_relu=True, use_bias=False)
    init_flax_(mlp, torch.Generator().manual_seed(1))
    init_flax_(pool, torch.Generator().manual_seed(2))
    with torch.no_grad():
        for i in range(2):
            getattr(mlp, f"Dense_{i}").weight.copy_(getattr(chain, f"w{i}").t())
            getattr(mlp, f"Dense_{i}").bias.zero_()
            getattr(mlp, f"BatchNorm_{i}").scale.copy_(getattr(chain, f"scale{i}"))
        pool.weight.copy_(chain.w2.t())
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    got = chain(xt, train=train, mask=mt)
    want = pool(mlp(xt, train=train), train=train, mask=mt)
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=3e-5, atol=3e-5)
