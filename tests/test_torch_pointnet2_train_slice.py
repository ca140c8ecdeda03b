"""The PointNet2 train slice as a whole against the JAX package's, on the
CPU, through the real entry points: `create_model("Autoencoder",
"PointNet2", "Cube", loss_override="chamfer")` at the scene's 2048 points,
B=2 distinct clouds, both packages starting from the same flax init
converted by interop, and `pointcloud_tpu.train.harness.make_train_step(spec,
optax.adam(1e-3))` against the port's `make_train_step(spec,
make_optimizer(spec))`. Off the TPU the JAX package trains its
set-abstraction levels through the XLA oracle of the fused chain.

The rules are those of tests/test_torch_train_slice.py (its module docstring
derives them): the first step's loss 1e-5 relative; the first step's update
of every parameter 1e-3 relative wherever the gradient is above noise; after
three steps the parameters within 2 lr per step; and the two planted
optimizer faults are rejected. After three steps the running statistics are
held to 5e-3 absolute plus 1e-3 relative (measured 2.3e-3 on values of order
1; the first step's are held to 1e-5 in tests/test_torch_pointnet2_train.py):
steps 2 and 3 take their batch statistics under weights that already differ
by the round-off entries' Adam steps. The losses of steps
2 and 3 are held to 3e-3 relative (measured 1.3e-3 at step 3, against 4e-4
on PointNet): Adam's first step moves every entry whose gradient is
round-off by about lr in a direction that differs between the packages, and
here the loss more than doubles from step 1 to step 2 (0.126 to 0.304), so
the later steps are that sensitive to the first update. The first step's gradients follow `close_grads` of
tests/test_torch_pointnet2_train.py (1e-3 relative plus 1e-3 of the tensor's
largest entry, with its stated slack for ReLU gates within round-off of 0).
PointNet2 has no Dense bias in front of a BatchNorm, so no gradient is a
round-off trap here.

The seed keeps every squared distance more than 1e-5 (relative) away from
r^2 at both levels (tests/test_torch_pointnet2.py), and every pool's best
row more than 3e-6 above its runner-up. A closer pair lets the two packages
send a pooled gradient to different rows, and with only 256 groups per
channel at the second level one such row is several percent of that
level's last weight gradient: moving the input by 2e-7 moved the port's own
gradients by 6e-2 of the largest entry there and by 1e-2 below, on a seed
with a tied pair.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_pointnet2_train import close_grads, largest
from test_torch_train_slice import (
    LR,
    STEPS,
    check_first_update,
    jax_first_step,
    params_np,
    port_params,
)
from torch_port_utils import ball_margin as margin
from torch_port_utils import fps_centroids as centroids
from torch_port_utils import raw_clouds, record_pool_gaps, to_np

from pointcloud_tpu.train import harness as jharness
from pointcloud_tpu_torch.interop import flax_to_state_dict, load_flax_variables
from pointcloud_tpu_torch.train import harness as tharness
from pointcloud_tpu_torch.train.harness import zero_gradient_biases

MARGIN = 1e-5
POOL_GAP = 3e-6
SEED = 49


def port_spec(v):
    tspec = tharness.create_model("Autoencoder", "PointNet2", "Cube",
                                  loss_override="chamfer", device="cpu")
    load_flax_variables(tspec.model, v)
    return tspec


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX package's three steps from its flax init on one batch of two
    clouds, with the first step's loss, gradients and parameters."""
    jspec, _ = jharness.create_model("Autoencoder", "PointNet2", "Cube",
                                     loss_override="chamfer")
    x = raw_clouds(np.random.default_rng(SEED), jspec.scene, 2, 2048)
    y = raw_clouds(np.random.default_rng(1), jspec.scene, 2, 2048)
    v = jax.tree_util.tree_map(np.array, jspec.model.init(
        jax.random.PRNGKey(0), jnp.asarray(x[:1]), train=False))
    loss0, grads = jax_first_step(jspec, v, x, y)
    tx = optax.adam(LR)
    params, stats = v["params"], v["batch_stats"]
    opt_state = tx.init(params)
    jstep = jharness.make_train_step(jspec, tx)
    losses = []
    for i in range(STEPS):
        params, stats, opt_state, loss, _ = jstep(
            params, stats, opt_state, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(loss))
        if i == 0:
            after1 = params_np(params)
    final = {k: np.array(to_np(a)) for k, a in flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray,
                               {"params": params, "batch_stats": stats})).items()}
    return {"x": x, "y": y, "v": v, "loss0": loss0, "grads": grads,
            "init": params_np(v["params"]), "after1": after1,
            "losses": losses, "final": final}


def test_three_train_steps_match_jax(jax_steps, monkeypatch):
    j = jax_steps
    tspec = port_spec(j["v"])
    gaps = record_pool_gaps(monkeypatch)
    xyz = to_np(tspec.in_transform(torch.from_numpy(j["x"]))[0])[..., :3].copy()
    c1 = centroids(xyz, 512)
    assert margin(xyz, c1, 0.2) > MARGIN
    assert margin(c1, centroids(c1, 128), 0.4) > MARGIN
    assert not zero_gradient_biases(tspec.model)

    x, y = torch.from_numpy(j["x"]), torch.from_numpy(j["y"])
    step = tharness.make_train_step(tspec, tharness.make_optimizer(tspec))
    tlosses = []
    for i in range(STEPS):
        loss, logs = step(x, y)
        tlosses.append(loss.item())
        if i == 0:
            assert len(gaps) == 3 and min(gaps) > POOL_GAP
            assert logs == {} and loss.shape == ()
            assert abs(tlosses[0] - j["loss0"]) <= 1e-5 * j["loss0"]
            tgrads = {k: to_np(p.grad) for k, p in tspec.model.named_parameters()}
            assert set(tgrads) == set(j["grads"])
            top = largest(j["grads"].values())
            for k, w in j["grads"].items():
                close_grads(tgrads[k], w, k, top)
            check_first_update(port_params(tspec), j["after1"], j["init"],
                               j["grads"], set())
    assert abs(tlosses[0] - j["losses"][0]) <= 1e-5 * j["losses"][0]
    np.testing.assert_allclose(tlosses, j["losses"], rtol=3e-3)
    assert all(np.isfinite(tlosses))

    got = tspec.model.state_dict()
    assert set(got) == set(j["final"])
    n_stats = 0
    for k, w in j["final"].items():
        if k.rsplit(".", 1)[-1].rstrip("0123456789") in ("mean", "var"):
            n_stats += 1
            assert not np.allclose(w, 0.0) and not np.allclose(w, 1.0)  # it moved
            np.testing.assert_allclose(to_np(got[k]), w, atol=5e-3, rtol=1e-3,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(to_np(got[k]), w, atol=2 * STEPS * LR,
                                       err_msg=k)
    assert n_stats == 18  # 3 levels x 3 layers x (mean, var)


@pytest.mark.parametrize("fault", ["step_skipped", "lr_negated"])
def test_first_update_rejects_planted_fault(jax_steps, fault):
    """check_first_update must reject an optimizer that does not step or
    steps the wrong way, also on this model's parameters."""
    j = jax_steps
    tspec = port_spec(j["v"])
    opt = tharness.make_optimizer(tspec)
    if fault == "step_skipped":
        opt.step = lambda closure=None: None
    else:
        for group in opt.param_groups:
            group["lr"] = -LR
    tharness.make_train_step(tspec, opt)(torch.from_numpy(j["x"]),
                                         torch.from_numpy(j["y"]))
    after1 = port_params(tspec)
    for k, w in after1.items():  # within the three-step bound all the same
        assert np.abs(w - j["after1"][k]).max() <= 2 * STEPS * LR, k
    with pytest.raises(AssertionError):
        check_first_update(after1, j["after1"], j["init"], j["grads"], set())
