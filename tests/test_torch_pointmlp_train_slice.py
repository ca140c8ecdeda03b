"""The PointMLP train slice as a whole against the JAX package's, on the CPU,
through the real entry points: `create_model("Autoencoder", "PointMLP",
"Cube", loss_override="chamfer")` and `create_model("Autoencoder",
"PointMLPE", "Cube")` (its default EMD loss), B=2 distinct clouds of 384
points (the decoder emits the scene's 2048), both packages starting from the
same flax init converted by interop, and
`pointcloud_tpu.train.harness.make_train_step(spec, optax.adam(1e-3))`
against the port's `make_train_step(spec, make_optimizer(spec))`; then one
train step of `create_model("Segmenter", "PointMLPE", "Cube")`. Off the TPU
the JAX package trains PreExtraction through its XLA oracle, the port's CPU
tensors through the plain residual chain.

What bounds the comparison. The two packages' train-mode forwards differ
by round-off that grows through the stages (BatchNorm over the few rows of
a late PosExtraction amplifies it; a one-ulp move of the input moves the
port's own PosExtraction outputs by 2e-5 at stage 1 and 3e-4 at stage 4,
measured), while each PreExtraction pool of 24 rows over 2 x 96 to 2 x 12
groups x 128 to 1024 channels has best-to-runner-up gaps of a few 1e-6:
from stage 2 on some pools pick another row in the other package and
route their gradient there. So, unlike the PointNet and PointNet2 slices,
the encoder's first-step gradients agree entry by entry only in the bulk,
and after Adam's first update (every entry moves by ~lr, the other way
where the signs differ) the trajectories part. The rules, from
tests/test_torch_train_slice.py adapted to that:
  * the first loss 1e-5 relative and the first step's running statistics
    1e-4 absolute and relative (a forward from equal weights);
  * the decoder's first-step gradients 1e-3 relative plus 1e-3 of the
    tensor's largest entry; of all gradient entries at least 90% within
    1e-3 relative plus 3e-2 of their tensor's largest entry plus 1e-4 of
    the model's largest (measured 93.4% PointMLP, 99.7% Elite);
  * the first update (`check_update`): every entry within 2 lr of the JAX
    package's (plus 1e-6, the parameters' fp32 roundings); the decoder's 1e-3 relative wherever its gradient is above
    noise (above 1% of its tensor's largest entry); every entry Adam's
    first step on the port's own gradient, -lr g / (|g| + eps), to 1e-3
    relative (plus 1e-3 lr). The encoder's updates are not held to the JAX
    package's entry by entry: its own first-step gradient, compiled once
    more inside its train step, already differs in sign from
    `jax_first_step`'s at entries of 20% of their tensor's largest; the two
    planted optimizer faults are rejected;
  * three steps: the losses finite and within 0.5 relative of the JAX
    package's (measured 0.15 at step 3), every parameter within 2 lr per
    step (the most Adam steps of opposite sign can put between two copies).
Seeds: every stage keeps each centroid's 24th and 25th float64 distances
1e-5 apart (relative) and every PreExtraction pool its best row 1e-6 above
its runner-up in the port's first forward (`record_pool_gaps`). EMD: the
matching is an argmax (tests/test_torch_emd_slice.py); these seeds flip no
row, so the EMD losses meet the same 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_train_slice import LR, STEPS, jax_first_step, params_np, port_params
from torch_port_utils import raw_clouds, record_pool_gaps, stage_margins, to_np

from pointcloud_tpu.train import harness as jharness
from pointcloud_tpu_torch.interop import flax_to_state_dict, load_flax_variables
from pointcloud_tpu_torch.train import harness as tharness

N_POINTS = 384
MARGIN = 1e-5
POOL_GAP = 1e-6
CONFIGS = {"PointMLP": ("Autoencoder", "chamfer", 21),
           "PointMLPE": ("Autoencoder", None, 21)}


def batch(model_type, sc, seed):
    rng = np.random.default_rng(seed)
    x = raw_clouds(rng, sc, 2, N_POINTS)
    y = raw_clouds(np.random.default_rng(1), sc, 2, N_POINTS)
    if model_type == "Segmenter":  # xyz + a class label
        labels = rng.integers(0, len(sc.classes), (2, N_POINTS, 1))
        y = np.concatenate([y[..., :3], labels.astype(np.float32)], -1)
    return x, y


def stats_np(tree):
    return {k: np.array(to_np(a)) for k, a in flax_to_state_dict(
        {"batch_stats": jax.tree_util.tree_map(np.asarray, tree)}).items()}


def port_spec(model_type, backbone, loss_override, v):
    tspec = tharness.create_model(model_type, backbone, "Cube",
                                  loss_override=loss_override, device="cpu")
    load_flax_variables(tspec.model, v)
    return tspec


def jax_run(model_type, backbone, loss_override, seed, steps):
    """The JAX package's `steps` train steps from its flax init, with the
    first step's loss, gradients, parameters and running statistics."""
    jspec, _ = jharness.create_model(model_type, backbone, "Cube",
                                     loss_override=loss_override)
    x, y = batch(model_type, jspec.scene, seed)
    v = jax.tree_util.tree_map(np.array, jspec.model.init(
        jax.random.PRNGKey(0), jnp.asarray(x[:1]), train=False))
    loss0, grads = jax_first_step(jspec, v, x, y)
    tx = optax.adam(LR)
    params, stats = v["params"], v["batch_stats"]
    opt_state = tx.init(params)
    jstep = jharness.make_train_step(jspec, tx)
    losses = []
    for i in range(steps):
        params, stats, opt_state, loss, _ = jstep(
            params, stats, opt_state, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(loss))
        if i == 0:
            after1, stats1 = params_np(params), stats_np(stats)
    return {"x": x, "y": y, "v": v, "loss0": loss0, "grads": grads,
            "init": params_np(v["params"]), "after1": after1, "stats1": stats1,
            "losses": losses, "final": params_np(params),
            "scene": jspec.scene}


def check_update(got, j, tgrads):
    """The first update (parameters after minus before) against the JAX
    package's and Adam's rule: the module docstring's rule, with `tgrads`
    the port's first-step gradients."""
    n_sig = 0
    for k, g in j["grads"].items():
        ut, uj = got[k] - j["init"][k], j["after1"][k] - j["init"][k]
        assert np.abs(ut - uj).max() <= 2 * LR + 1e-6, k  # + the fp32 roundings of p
        adam = -LR * tgrads[k] / (np.abs(tgrads[k]) + 1e-8)
        np.testing.assert_allclose(ut, adam, rtol=1e-3, atol=1e-3 * LR, err_msg=k)
        if k.startswith("decoder."):
            sig = (np.abs(g) > 1e-2 * np.abs(g).max()) & (np.abs(g) > 1e-6)
            n_sig += int(sig.sum())
            np.testing.assert_allclose(ut[sig], uj[sig], rtol=1e-3, err_msg=k)
    assert n_sig > 0


def port_grads(tspec):
    return {k: to_np(p.grad) for k, p in tspec.model.named_parameters()}


def check_first_step(tspec, j, tloss, gaps):
    """The first loss, the PreExtraction pools' margins, the first-step
    gradients, running statistics and update."""
    assert len(gaps) == 4 and min(gaps) > POOL_GAP, gaps
    assert abs(tloss - j["loss0"]) <= 1e-5 * j["loss0"]
    tgrads = port_grads(tspec)
    assert set(tgrads) == set(j["grads"])
    top = max(float(np.abs(g).max()) for g in j["grads"].values())
    n = n_ok = 0
    for k, w in j["grads"].items():
        big = float(np.abs(w).max())
        if k.startswith("decoder."):
            np.testing.assert_allclose(tgrads[k], w, rtol=1e-3, atol=1e-3 * big,
                                       err_msg=k)
        ok = np.abs(tgrads[k] - w) <= 1e-3 * np.abs(w) + 3e-2 * big + 1e-4 * top
        n, n_ok = n + ok.size, n_ok + int(ok.sum())
    assert n_ok >= 0.9 * n, n_ok / n
    stats = {k: to_np(b) for k, b in tspec.model.named_buffers()}
    assert set(stats) == set(j["stats1"])
    for k, w in j["stats1"].items():
        np.testing.assert_allclose(stats[k], w, atol=1e-4, rtol=1e-4, err_msg=k)
    check_update(port_params(tspec), j, tgrads)


@pytest.fixture(scope="module", params=list(CONFIGS))
def jax_steps(request):
    model_type, loss_override, seed = CONFIGS[request.param]
    return {"backbone": request.param, "loss_override": loss_override,
            **jax_run(model_type, request.param, loss_override, seed, STEPS)}


def test_three_train_steps_match_jax(jax_steps, monkeypatch):
    j = jax_steps
    tspec = port_spec("Autoencoder", j["backbone"], j["loss_override"], j["v"])
    xyz = to_np(tspec.in_transform(torch.from_numpy(j["x"]))[0])[..., :3].copy()
    assert min(stage_margins(xyz)) > MARGIN
    gaps = record_pool_gaps(monkeypatch, distinct=True)
    x, y = torch.from_numpy(j["x"]), torch.from_numpy(j["y"])
    step = tharness.make_train_step(tspec, tharness.make_optimizer(tspec))
    tlosses = []
    for i in range(STEPS):
        loss, logs = step(x, y)
        tlosses.append(loss.item())
        if i == 0:
            assert loss.shape == ()
            want_logs = set() if j["loss_override"] else {"train_loss/EMD",
                                                          "train_loss/feature"}
            assert set(logs) == want_logs
            check_first_step(tspec, j, tlosses[0], gaps)
    assert all(np.isfinite(tlosses))
    np.testing.assert_allclose(tlosses, j["losses"], rtol=0.5)
    got = port_params(tspec)
    assert set(got) == set(j["final"])
    for k, w in j["final"].items():
        np.testing.assert_allclose(got[k], w, atol=2 * STEPS * LR, err_msg=k)


@pytest.mark.parametrize("fault", ["step_skipped", "lr_negated"])
def test_first_update_rejects_planted_fault(jax_steps, fault):
    """check_update must reject an optimizer that does not step or steps the
    wrong way; the three-step bound of 2 lr per step alone would pass
    both."""
    j = jax_steps
    tspec = port_spec("Autoencoder", j["backbone"], j["loss_override"], j["v"])
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
        check_update(after1, j, port_grads(tspec))


def test_segmenter_first_train_step_matches_jax(monkeypatch):
    """create_model("Segmenter", "PointMLPE", "Cube") (EMD with class
    weights): the first step's loss, gradients, statistics and update."""
    j = jax_run("Segmenter", "PointMLPE", None, 21, 1)
    tspec = port_spec("Segmenter", "PointMLPE", None, j["v"])
    gaps = record_pool_gaps(monkeypatch, distinct=True)
    loss, logs = tharness.make_train_step(tspec, tharness.make_optimizer(tspec))(
        torch.from_numpy(j["x"]), torch.from_numpy(j["y"]))
    assert set(logs) == {"train_loss/EMD", "train_loss/feature",
                         "train_loss/cross_entropy", "train_loss/kl_divergence"}
    check_first_step(tspec, j, loss.item(), gaps)
