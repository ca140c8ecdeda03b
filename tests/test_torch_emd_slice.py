"""The EMD slice as a whole against the JAX package's, on the CPU, through
the real entry points: `create_model("Autoencoder", backbone, "Cube")` with
its default Earth Mover's Distance loss and `create_model("Segmenter",
"PointNet", "Cube")`, at the scene's 2048 points, B=2 distinct clouds, with
`make_eval_step` (randomised interop-converted weights) and the first
`make_train_step` (from the flax init, against
`pointcloud_tpu.train.harness.make_train_step(spec, optax.adam(1e-3))`).

The matching is discontinuous (tests/test_torch_emd.py): among the 4,096
rows of a batch a few have their two best scores within round-off (measured:
smallest gap 2e-9 to 1e-7 over eight seeds), and the two packages form the
cost differently (off the TPU the JAX package uses the matmul expansion,
the port direct differences), so 0 to 2 rows go to another target (measured
over those seeds). A margin cannot be asserted at this size, so the rule is
flip-tolerant, in three parts that together pin the loss:

  * the outputs agree (1e-4, as tests/test_torch_ae_slice.py);
  * the two matchings, each package's own on its own output, agree on at
    least 99.5% of the rows, and on every other row the JAX package's
    target scores within 1e-6 of the port's best (float64 scores from the
    port's potentials);
  * each package's loss and logged sub-losses equal, to 1e-5, the loss
    formula evaluated in float64 on its own output and its own matching
    (`emd_loss_np`), and where no row flipped the two losses agree to 1e-5
    directly.

`pytest -s` prints what each comparison measured.

First-step gradients follow tests/test_torch_train_slice.py: 1e-3 relative
plus 3e-3 of the tensor's largest entry (a flipped row is 1 / 4096 of the
point loss's gradient: 2.4e-4), the STN heads' last weight on 98% of its
entries, zero-gradient biases round-off; the first update 1e-3 relative
where the gradient is above noise, and the two planted optimizer faults are
rejected.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_train_slice import (
    LR,
    check_first_step_grads,
    check_first_update,
    jax_first_step,
    params_np,
    port_params,
)
from torch_port_utils import ball_margin, fps_centroids, jax_variables, raw_clouds, to_np

from pointcloud_tpu.ops import emd as jemd
from pointcloud_tpu.train import harness as jharness
from pointcloud_tpu_torch.interop import load_flax_variables
from pointcloud_tpu_torch.ops import (
    eps_schedule,
    matching_difference,
    nn_sweep,
    sinkhorn_reference,
)
from pointcloud_tpu_torch.train import harness as tharness
from pointcloud_tpu_torch.train.harness import zero_gradient_biases

TOL = dict(atol=1e-4, rtol=1e-4)
LOSS_TOL = 1e-5
FLIP_SHARE = 0.995
FLIP_GAP = 1e-6
SCENE = jharness.scene_config("Cube")
AE_KEYS = {"train_loss/EMD", "train_loss/feature"}
SEG_KEYS = AE_KEYS | {"train_loss/cross_entropy", "train_loss/kl_divergence"}


def batch(model_type, seed, B=2):
    """Raw input clouds and targets: the clouds' own layout for the
    Autoencoder, xyz + a class label drawn over the scene's classes for the
    Segmenter."""
    rng = np.random.default_rng(seed)
    x = raw_clouds(rng, SCENE, B, SCENE.sample_points)
    y = raw_clouds(rng, SCENE, B, SCENE.sample_points)
    if model_type == "Segmenter":
        labels = rng.integers(0, len(SCENE.classes), (B, SCENE.sample_points, 1))
        y = np.concatenate([y[..., :3], labels.astype(np.float32)], -1)
    return x, y


def emd_loss_np(pred, target, assignment, num_classes, feature_weight=0.1):
    """The EMD loss and its logged parts in float64 for a given matching."""
    pred, target = pred.astype(np.float64), target.astype(np.float64)
    a = assignment.astype(np.int64)
    target = np.take_along_axis(target, a[..., None], 1)
    d = ((pred[..., :3] - target[..., :3]) ** 2).sum(-1)
    logs = {}
    w = np.ones_like(d)
    if num_classes is None:
        feature = ((pred[..., 3:] - target[..., 3:]) ** 2).mean()
    else:
        labels = target[..., 3].astype(np.int64)
        dist = np.bincount(labels.ravel(), minlength=num_classes) / labels.size
        cw = 1.0 / (dist + 1e-4)
        w = (cw / cw.sum())[labels]
        logits = pred[..., 3:]
        logp = logits - np.log(np.exp(logits - logits.max(-1, keepdims=True)).sum(
            -1, keepdims=True)) - logits.max(-1, keepdims=True)
        nll = -np.take_along_axis(logp, labels[..., None], -1)[..., 0]
        logs["train_loss/cross_entropy"] = (w * nll).sum() / w.sum()
        feature = feature_weight * logs["train_loss/cross_entropy"]
        pdist = np.bincount(logits.argmax(-1).ravel(), minlength=num_classes) / labels.size
        sd = np.exp(dist) / np.exp(dist).sum()
        lp = pdist - np.log(np.exp(pdist).sum())
        logs["train_loss/kl_divergence"] = (sd * (np.log(sd) - lp)).sum() / num_classes
    logs["train_loss/EMD"] = (np.sqrt(d + 1e-12) * w).sum() / w.sum()
    logs["train_loss/feature"] = feature
    return logs["train_loss/EMD"] + feature, logs


def check_matchings_and_losses(tout, jout, y_norm, num_classes, tloss, tlogs,
                               jloss, jlogs):
    """The second and third parts of the module docstring's rule. Returns
    the number of flipped rows."""
    tp, ty = torch.from_numpy(tout), torch.from_numpy(y_norm)
    *want, f, g = sinkhorn_reference(tp, ty, eps_schedule(0.005, 50))
    ja = np.asarray(jemd.sinkhorn_match(
        jnp.asarray(jout[..., :3]), jnp.asarray(y_norm[..., :3]), 0.005, 50)[1])
    jd = ((jout[..., :3] - np.take_along_axis(
        y_norm[..., :3], ja[..., None].astype(np.int64), 1)) ** 2).sum(-1)
    same, gap, d_err = matching_difference(
        tp, ty, f, g,
        (torch.from_numpy(jd.astype(np.float32)), torch.from_numpy(ja.copy())), want)
    assert same >= FLIP_SHARE and gap <= FLIP_GAP and d_err <= 1e-6, (same, gap, d_err)
    keys = AE_KEYS if num_classes is None else SEG_KEYS
    assert set(tlogs) == set(jlogs) == keys
    for out, a, loss, logs in ((tout, to_np(want[1]), tloss, tlogs),
                               (jout, ja, jloss, jlogs)):
        ref, ref_logs = emd_loss_np(out, y_norm, a, num_classes)
        assert abs(float(loss) - ref) <= LOSS_TOL
        for k in keys:
            assert abs(float(logs[k]) - ref_logs[k]) <= LOSS_TOL, k
    flips = int(round((1 - same) * ja.size))
    if flips == 0:
        assert abs(float(tloss) - float(jloss)) <= LOSS_TOL
    print(f"measured: {flips} of {ja.size} rows flipped, largest score gap "
          f"{gap:.2e}, dists {d_err:.2e}; loss port {float(tloss):.7f} vs JAX "
          f"{float(jloss):.7f}; each vs the float64 formula "
          f"{abs(float(tloss) - emd_loss_np(tout, y_norm, to_np(want[1]), num_classes)[0]):.1e}, "
          f"{abs(float(jloss) - emd_loss_np(jout, y_norm, ja, num_classes)[0]):.1e}")
    return flips


@pytest.fixture(scope="module", params=["Autoencoder", "Segmenter"])
def slice_pair(request):
    """Both packages' specs of one model type with its default loss, and one
    batch."""
    model_type = request.param
    jspec, _ = jharness.create_model(model_type, "PointNet", "Cube")
    tspec = tharness.create_model(model_type, "PointNet", "Cube", device="cpu")
    x, y = batch(model_type, 0)
    y_norm = to_np(tspec.out_transform(torch.from_numpy(y))[0])
    return {"type": model_type, "jspec": jspec, "tspec": tspec, "x": x, "y": y,
            "y_norm": y_norm,
            "C": len(SCENE.classes) if model_type == "Segmenter" else None}


def test_create_model_builds_the_default_losses(slice_pair):
    p = slice_pair
    for spec in (p["jspec"], p["tspec"]):
        loss = spec.loss
        assert type(loss).__name__ == "EarthMoverDistance"
        assert (loss.eps, loss.iterations, loss.anneal_from, loss.method, loss.C,
                loss.feature_weight) == (0.005, 50, None, "sinkhorn", p["C"], 0.1)
    out_dim = 6 if p["C"] is None else 3 + 5
    assert p["tspec"].model.decoder.out_dim == out_dim
    assert p["tspec"].model_type == p["type"]


def test_eval_step_matches_jax(slice_pair):
    p = slice_pair
    v = jax_variables(p["jspec"].model, p["x"], 1)
    load_flax_variables(p["tspec"].model, v)
    jloss, jlogs, jout = jharness.make_eval_step(p["jspec"])(
        v["params"], v["batch_stats"], jnp.asarray(p["x"]), jnp.asarray(p["y"]))
    before = nn_sweep.launches
    tloss, tlogs, tout = tharness.make_eval_step(p["tspec"])(
        torch.from_numpy(p["x"]), torch.from_numpy(p["y"]))
    assert nn_sweep.launches == before and tloss.shape == ()
    assert tout.shape == (2, 2048, 6 if p["C"] is None else 8)
    assert tout.dtype == torch.float32
    np.testing.assert_allclose(to_np(tout), np.asarray(jout), **TOL)
    check_matchings_and_losses(to_np(tout), np.asarray(jout), p["y_norm"], p["C"],
                               tloss, tlogs, jloss, jlogs)


@pytest.fixture(scope="module")
def first_steps(slice_pair):
    """Both packages' first train step from the flax init: losses, logs,
    train-mode outputs, gradients and the parameters after the update."""
    p = slice_pair
    jspec, x, y = p["jspec"], p["x"], p["y"]
    v = jax.tree_util.tree_map(np.array, jspec.model.init(
        jax.random.PRNGKey(0), jnp.asarray(x[:1]), train=False))
    tspec = tharness.create_model(p["type"], "PointNet", "Cube", device="cpu")
    load_flax_variables(tspec.model, v)

    jloss0, jgrads = jax_first_step(jspec, v, x, y)
    xn = jharness._apply_tf(jspec.in_transform, jnp.asarray(x))
    jout, _ = jspec.model.apply(v, xn, train=True, mutable=["batch_stats"])
    tx = optax.adam(LR)
    jstep = jharness.make_train_step(jspec, tx)
    params, _, _, jloss, jlogs = jstep(v["params"], v["batch_stats"],
                                       tx.init(v["params"]), jnp.asarray(x),
                                       jnp.asarray(y))
    assert abs(float(jloss) - jloss0) <= 1e-6

    with torch.no_grad():  # the train-mode output the step's loss will see
        tout = tspec.model(tspec.in_transform(torch.from_numpy(x))[0], train=True)
    init = port_params(tspec)
    step = tharness.make_train_step(tspec, tharness.make_optimizer(tspec))
    tloss, tlogs = step(torch.from_numpy(x), torch.from_numpy(y))
    tlogs = {k: v.detach() for k, v in tlogs.items()}
    return {**p, "v": v, "jloss": float(jloss), "jlogs": jlogs,
            "jout": np.asarray(jout), "jgrads": jgrads,
            "jafter1": params_np(params), "init": init, "tout": to_np(tout),
            "tloss": tloss, "tlogs": tlogs,
            "tgrads": {k: to_np(g.grad) for k, g in tspec.model.named_parameters()},
            "tafter1": port_params(tspec), "zero": zero_gradient_biases(tspec.model)}


def test_first_train_step_loss_matches_jax(first_steps):
    s = first_steps
    assert s["tloss"].shape == () and not s["tloss"].requires_grad
    np.testing.assert_allclose(s["tout"], s["jout"], **TOL)
    for k, w in params_np(s["v"]["params"]).items():
        np.testing.assert_array_equal(s["init"][k], w)
    flips = check_matchings_and_losses(s["tout"], s["jout"], s["y_norm"], s["C"],
                                       s["tloss"], s["tlogs"], s["jloss"], s["jlogs"])
    assert flips <= 4  # measured 0 to 2; each moves the point loss by < 1e-4
    assert abs(float(s["tloss"]) - s["jloss"]) <= 1e-4 * (flips + 0.1)


def test_first_train_step_gradients_match_jax(first_steps):
    s = first_steps
    check_first_step_grads(s["tgrads"], s["jgrads"], 1e-3, s["zero"],
                           head_weights_frac=0.98)
    # the decoder's last layer sees the loss's gradient directly
    k = "decoder.MLP_0.Dense_3.bias"
    assert np.abs(s["jgrads"][k]).max() > 0


def check_update(after1, s):
    """`check_first_update` on every parameter but the STN heads' last
    weights. Over two distinct clouds their gradient carries the heads'
    amplified round-off (tests/test_torch_train_slice.py), so a few of its
    entries step the other way: there the 1e-3 rule must hold on 98% of the
    entries whose gradient is above noise (measured 99.7%), and every entry
    stays within 2 lr."""
    head = [k for k in s["jgrads"] if k.endswith("stn.Dense_2.weight")]
    assert len(head) == 2
    check_first_update(after1, s["jafter1"], s["init"],
                       {k: g for k, g in s["jgrads"].items() if k not in head}, s["zero"])
    for k in head:
        g = s["jgrads"][k]
        ut, uj = after1[k] - s["init"][k], s["jafter1"][k] - s["init"][k]
        assert np.abs(ut - uj).max() <= 2 * LR, k
        sig = (np.abs(g) > 1e-2 * np.abs(g).max()) & (np.abs(g) > 1e-6)
        assert sig.any(), k
        ok = np.abs(ut[sig] - uj[sig]) <= 1e-3 * np.abs(uj[sig])
        assert ok.mean() >= 0.98, k


def test_first_update_matches_jax(first_steps):
    check_update(first_steps["tafter1"], first_steps)


@pytest.mark.parametrize("fault", ["step_skipped", "lr_negated"])
def test_first_update_rejects_planted_fault(first_steps, fault):
    s = first_steps
    tspec = tharness.create_model(s["type"], "PointNet", "Cube", device="cpu")
    load_flax_variables(tspec.model, s["v"])
    opt = tharness.make_optimizer(tspec)
    if fault == "step_skipped":
        opt.step = lambda closure=None: None
    else:
        for group in opt.param_groups:
            group["lr"] = -LR
    tharness.make_train_step(tspec, opt)(torch.from_numpy(s["x"]),
                                         torch.from_numpy(s["y"]))
    with pytest.raises(AssertionError):
        check_update(port_params(tspec), s)


def test_pointnet2_emd_eval_step_matches_jax():
    """The PointNet2 autoencoder with its default loss: one eval step. The
    input seed keeps every squared distance 1e-5 (relative) from r^2 at both
    SA levels, as tests/test_torch_pointnet2_slice.py."""
    jspec, _ = jharness.create_model("Autoencoder", "PointNet2", "Cube")
    tspec = tharness.create_model("Autoencoder", "PointNet2", "Cube", device="cpu")
    x = raw_clouds(np.random.default_rng(13), jspec.scene, 2, 2048)
    y = raw_clouds(np.random.default_rng(1), jspec.scene, 2, 2048)
    xyz = to_np(tspec.in_transform(torch.from_numpy(x))[0])[..., :3].copy()
    c1 = fps_centroids(xyz, 512)
    assert ball_margin(xyz, c1, 0.2) > 1e-5
    assert ball_margin(c1, fps_centroids(c1, 128), 0.4) > 1e-5
    v = jax_variables(jspec.model, x, 1)
    load_flax_variables(tspec.model, v)
    jloss, jlogs, jout = jharness.make_eval_step(jspec)(
        v["params"], v["batch_stats"], jnp.asarray(x), jnp.asarray(y))
    tloss, tlogs, tout = tharness.make_eval_step(tspec)(
        torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(to_np(tout), np.asarray(jout), **TOL)
    y_norm = to_np(tspec.out_transform(torch.from_numpy(y))[0])
    check_matchings_and_losses(to_np(tout), np.asarray(jout), y_norm, None,
                               tloss, tlogs, jloss, jlogs)


@pytest.mark.parametrize("model_type", ["Autoencoder", "Segmenter"])
def test_pointnet2_emd_steps_run(model_type):
    """PointNet2 + EMD through make_eval_step and make_train_step, a check of
    the wiring (the parity of its parts is held elsewhere): the losses are
    finite and logged, and every parameter gets a gradient and moves."""
    tspec = tharness.create_model(model_type, "PointNet2", "Cube", device="cpu")
    keys = AE_KEYS if model_type == "Autoencoder" else SEG_KEYS
    x, y = (torch.from_numpy(a) for a in batch(model_type, 3))
    loss, logs, out = tharness.make_eval_step(tspec)(x, y)
    assert torch.isfinite(loss) and set(logs) == keys
    assert out.shape == (2, 2048, 6 if model_type == "Autoencoder" else 8)
    init = port_params(tspec)
    loss, logs = tharness.make_train_step(tspec, tharness.make_optimizer(tspec))(x, y)
    assert torch.isfinite(loss) and set(logs) == keys
    after = port_params(tspec)
    moved = [k for k in init if np.abs(after[k] - init[k]).max() > 0]
    assert all(p.grad is not None for p in tspec.model.parameters())
    assert len(moved) >= len(init) - 2, sorted(set(init) - set(moved))
