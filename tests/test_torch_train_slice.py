"""The port's train step as a whole against the JAX package's, on the CPU,
through the real entry points: `create_model("Autoencoder", "PointNet",
"Cube", loss_override="chamfer")` at the scene's 2048 points, B=2, both
packages starting from the same flax init converted by interop, and
`pointcloud_tpu.train.harness.make_train_step(spec, optax.adam(1e-3))`
against the port's `make_train_step(spec, make_optimizer(spec))`.

Compared: the loss of each of three steps, the first step's gradients, the
first step's update of every parameter, and the parameters and running
statistics after the three steps. fp32 on both sides; the sums run in
different orders. These effects set the tolerances:

  * The STN heads normalise (B, 512) and (B, 256) features over the batch
    alone. Over two distinct clouds, a channel whose two values nearly
    coincide has a batch variance far below eps, and BatchNorm multiplies
    their round-off by up to 1/sqrt(eps) ~ 300. At the flax init the heads'
    last Dense is zero, so this reaches only the gradient of that Dense's
    weight (its input is the normalised features). The first test holds it
    on 98% of its entries and every other gradient to 1e-3 relative plus
    3e-3 of the tensor's largest entry (a BatchNorm bias's gradient sums
    4096 rows that can cancel to 1% of their size);
    tests/test_torch_pointnet_train.py holds the heads at B=8 and B=16.
  * The trap: the bias of a Dense layer that feeds a train-mode BatchNorm
    (`zero_gradient_biases`) has a true gradient of exactly 0, as the batch
    mean removes it. Both packages leave round-off there; the tests check
    that it is round-off (below 1e-4 of the largest gradient).
  * Adam's first step moves an entry by lr * g / (|g| + eps): -lr * sign(g)
    wherever the gradient is above noise. There (|g| above 1% of its
    tensor's largest entry and above 1e-6) the first step's update of every
    parameter but the trap biases is held to 1e-3 relative (the update
    carries one fp32 rounding of the parameter, 1.2e-4 of lr for |p| <= 1);
    a skipped or sign-flipped step fails it
    (test_first_update_rejects_planted_fault). Entries whose gradient is
    round-off step by about lr in a direction that differs between the
    packages, and the later steps' gradients inherit that difference: after
    three steps, updates differ by more than lr even where the first-step
    gradient is above noise, so no tight rule holds there. So the
    three-step test repeats one cloud (the heads' batch variance is then
    exactly 0 on both sides and their round-off is not amplified), holds
    the losses to 1e-3 relative (measured 4e-4 at step 3), the running
    statistics to 1e-3, and the parameters after three steps to 2 lr per
    step, the most that Adam steps of opposite sign can put between two
    copies.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_port_utils import to_np

from pointcloud_tpu.train import harness as jharness
from pointcloud_tpu_torch.interop import flax_to_state_dict, load_flax_variables
from pointcloud_tpu_torch.train import harness as tharness
from pointcloud_tpu_torch.train.harness import zero_gradient_biases

LR = 1e-3
STEPS = 3
SCENE = jharness.scene_config("Cube")


def raw_clouds(rng, sc, B, N):
    """Clouds in the scene's bbox coordinates (xyz) with rgb in [0, 1]."""
    bbox = np.asarray(sc.bbox, np.float32)
    xyz = bbox[:, 0] + rng.random((B, N, 3), dtype=np.float32) * (
        bbox[:, 1] - bbox[:, 0])
    return np.concatenate([xyz, rng.random((B, N, 3), dtype=np.float32)], -1)


def setup(x):
    """The JAX spec and its flax init, copied to numpy."""
    jspec, _ = jharness.create_model("Autoencoder", "PointNet", "Cube",
                                     loss_override="chamfer")
    return jspec, jax.tree_util.tree_map(np.array, jspec.model.init(
        jax.random.PRNGKey(0), jnp.asarray(x[:1]), train=False))


def port_spec(v):
    """The port's spec holding the flax variables `v`."""
    tspec = tharness.create_model("Autoencoder", "PointNet", "Cube",
                                  loss_override="chamfer", device="cpu")
    load_flax_variables(tspec.model, v)
    return tspec


def params_np(tree):
    """state_dict-keyed copies of a flax params tree."""
    return {k: np.array(to_np(a)) for k, a in flax_to_state_dict(
        {"params": jax.tree_util.tree_map(np.asarray, tree)}).items()}


def port_params(tspec):
    return {k: to_np(p).copy() for k, p in tspec.model.named_parameters()}


def jax_first_step(jspec, v, x, y):
    """(loss, state_dict-keyed gradients) of the JAX package's train-mode
    forward + loss at the initial variables."""
    xn = jharness._apply_tf(jspec.in_transform, jnp.asarray(x))
    yn = jharness._apply_tf(jspec.out_transform, jnp.asarray(y))
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jharness._forward_loss(
        jspec, p, v["batch_stats"], xn, yn, True)[0]))(v["params"])
    return float(loss), params_np(grads)


def check_first_step_grads(got, want, rel, zero, head_weights_frac=None):
    assert set(got) == set(want)
    top = max(float(np.abs(a).max()) for a in want.values())
    for k, w in want.items():
        g = got[k]
        if k in zero:
            assert np.abs(g).max() <= 1e-4 * top, k
            assert np.abs(w).max() <= 1e-4 * top, k
            continue
        atol = 3 * rel * float(np.abs(w).max())
        if head_weights_frac is not None and k.endswith("stn.Dense_2.weight"):
            ok = np.abs(g - w) <= rel * np.abs(w) + atol
            assert ok.mean() >= head_weights_frac, k
            continue
        np.testing.assert_allclose(g, w, rtol=rel, atol=atol, err_msg=k)


def check_first_update(got, want, init, grads, zero):
    """The first step's update (parameter after minus before) of the port,
    `got`, against JAX's, `want`: 1e-3 relative wherever the first-step
    gradient is above noise (see the module docstring), at most 2 lr apart
    elsewhere. Every tensor with a gradient above noise must have entries
    held to the tight rule."""
    for k, g in grads.items():
        ut, uj = got[k] - init[k], want[k] - init[k]
        assert np.abs(ut - uj).max() <= 2 * LR, k
        if k in zero:
            continue
        sig = (np.abs(g) > 1e-2 * np.abs(g).max()) & (np.abs(g) > 1e-6)
        assert sig.any() or np.abs(g).max() <= 1e-6, k
        np.testing.assert_allclose(ut[sig], uj[sig], rtol=1e-3, err_msg=k)


@pytest.fixture(scope="module")
def jax_steps():
    """One cloud repeated (B=2): the JAX package's three steps from its flax
    init, with the first step's gradients and parameters."""
    rng = np.random.default_rng(1)
    x = np.repeat(raw_clouds(rng, SCENE, 1, SCENE.sample_points), 2, axis=0)
    y = np.repeat(raw_clouds(rng, SCENE, 1, SCENE.sample_points), 2, axis=0)
    jspec, v = setup(x)
    _, grads = jax_first_step(jspec, v, x, y)
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
    return {"x": x, "y": y, "v": v, "grads": grads,
            "init": params_np(v["params"]), "after1": after1,
            "losses": losses, "final": final}


def test_first_train_step_matches_jax():
    """Two distinct clouds: the first step's loss and gradients."""
    rng = np.random.default_rng(0)
    x = raw_clouds(rng, SCENE, 2, SCENE.sample_points)
    y = raw_clouds(rng, SCENE, 2, SCENE.sample_points)
    jspec, v = setup(x)
    tspec = port_spec(v)
    jloss, jgrads = jax_first_step(jspec, v, x, y)
    step = tharness.make_train_step(tspec, tharness.make_optimizer(tspec))
    loss, logs = step(torch.from_numpy(x), torch.from_numpy(y))
    assert logs == {} and loss.shape == ()
    assert abs(loss.item() - jloss) <= 1e-5 * jloss
    tgrads = {k: to_np(p.grad) for k, p in tspec.model.named_parameters()}
    check_first_step_grads(tgrads, jgrads, 1e-3, zero_gradient_biases(tspec.model),
                           head_weights_frac=0.98)


def test_three_train_steps_match_jax(jax_steps):
    """One cloud repeated (B=2): three steps, the first step's update, then
    parameters and running statistics."""
    j = jax_steps
    x, y = torch.from_numpy(j["x"]), torch.from_numpy(j["y"])
    tspec = port_spec(j["v"])
    step = tharness.make_train_step(tspec, tharness.make_optimizer(tspec))
    zero = zero_gradient_biases(tspec.model)
    tlosses = []
    for i in range(STEPS):
        tlosses.append(step(x, y)[0].item())
        if i == 0:
            check_first_step_grads(
                {k: to_np(p.grad) for k, p in tspec.model.named_parameters()},
                j["grads"], 1e-3, zero)
            check_first_update(port_params(tspec), j["after1"], j["init"],
                               j["grads"], zero)
    jlosses = j["losses"]
    assert abs(tlosses[0] - jlosses[0]) <= 1e-5 * jlosses[0]
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-3)
    assert all(np.isfinite(tlosses))

    final = j["final"]
    got = tspec.model.state_dict()
    assert set(got) == set(final)
    for k, w in final.items():
        if k.endswith((".mean", ".var")):
            np.testing.assert_allclose(to_np(got[k]), w, atol=1e-3,
                                       rtol=1e-3, err_msg=k)
        else:
            np.testing.assert_allclose(to_np(got[k]), w,
                                       atol=2 * STEPS * LR, err_msg=k)


@pytest.mark.parametrize("fault", ["step_skipped", "lr_negated"])
def test_first_update_rejects_planted_fault(jax_steps, fault):
    """check_first_update must reject an optimizer that does not step or
    steps the wrong way; the three-step bound of 2 lr per step alone would
    pass both."""
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
        check_first_update(after1, j["after1"], j["init"], j["grads"],
                           zero_gradient_biases(tspec.model))
