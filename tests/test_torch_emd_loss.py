"""`EarthMoverDistance`, `PCSegmenter` / `SegAE` and the EMD settings of
cfg.py against the JAX package on the CPU, on the same numpy inputs and
interop-converted weights.

Loss cases assert, as tests/test_torch_emd.py does, that their seed keeps
every row's two best matching scores 1e-6 apart, so both packages match the
same targets; then the value and every logged sub-loss agree to 1e-5. The
gradient with respect to the prediction agrees to 1e-5 of its largest entry
on the feature dims. On xyz it is w_i (x_i - y_a) / sqrt(d_i) / sum(w), and
off the TPU the JAX package forms d by the matmul expansion, whose round-off
(~2e-7 on sums of ~3) is up to 1e-3 of a matched distance of 1e-4: the port
is held to JAX there at 2e-3 of the largest entry (measured 3.9e-4) and to
that formula in float64 at 1e-5. Module forwards: 1e-4 absolute and
relative, as tests/test_torch_ae_slice.py. `pytest -s` prints what the loss
cases measured.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_utils import jax_variables, to_np

from pointcloud_tpu import cfg as jcfg
from pointcloud_tpu import losses as jlosses
from pointcloud_tpu.models import SegAE as JSegAE, backbone_factory as jbackbones
from pointcloud_tpu.models.architectures import PCSegmenter as JPCSegmenter
from pointcloud_tpu_torch import cfg as tcfg
from pointcloud_tpu_torch import losses as tlosses
from pointcloud_tpu_torch.interop import flax_to_state_dict, load_flax_variables
from pointcloud_tpu_torch.models import PCSegmenter, SegAE, backbone_factory
from pointcloud_tpu_torch.ops import (
    emd_match,
    eps_schedule,
    sinkhorn_reference,
    top_two_gap,
)

MARGIN = 1e-6
TOL = 1e-5
LOG_KEYS = {"train_loss/EMD", "train_loss/feature"}
CLASS_KEYS = LOG_KEYS | {"train_loss/cross_entropy", "train_loss/kl_divergence"}


def loss_inputs(seed, B, N, num_classes, absent=None):
    """A prediction (xyz in the unit cube + 3 features or C logits) and a
    target (xyz + 3 features, or xyz + a float label; `absent` never
    drawn)."""
    rng = np.random.default_rng(seed)
    pred_xyz = rng.random((B, N, 3), dtype=np.float32)
    targ_xyz = rng.random((B, N, 3), dtype=np.float32)
    if num_classes is None:
        pred = np.concatenate([pred_xyz, rng.random((B, N, 3), dtype=np.float32)], -1)
        targ = np.concatenate([targ_xyz, rng.random((B, N, 3), dtype=np.float32)], -1)
    else:
        labels = rng.integers(0, num_classes, (B, N, 1))
        if absent is not None:
            labels = np.where(labels == absent, (absent + 1) % num_classes, labels)
        pred = np.concatenate(
            [pred_xyz, rng.standard_normal((B, N, num_classes)).astype(np.float32)], -1)
        targ = np.concatenate([targ_xyz, labels.astype(np.float32)], -1)
    return pred, targ


def assert_margin(pred, targ, eps, iters, anneal):
    tp, tt = torch.from_numpy(pred), torch.from_numpy(targ)
    _, _, f, g = sinkhorn_reference(tp, tt, eps_schedule(eps, iters, anneal))
    assert float(top_two_gap(tp, tt, f, g).min()) > MARGIN


def both_losses(pred, targ, **kw):
    """(value, logs, d loss / d pred) of the JAX loss and of the port's."""
    jloss = jlosses.EarthMoverDistance(**kw)
    jval, jgrad = jax.value_and_grad(lambda p: jloss(p, jnp.asarray(targ)))(
        jnp.asarray(pred))
    jlogs = {}  # logged outside the transformation: the hook sees values
    jloss.log = lambda k, v: jlogs.__setitem__(k, float(v))
    jloss(jnp.asarray(pred), jnp.asarray(targ))

    tloss = tlosses.EarthMoverDistance(**kw)
    tlogs = {}
    tloss.log = lambda k, v: tlogs.__setitem__(k, v.item())
    tp = torch.from_numpy(pred).requires_grad_()
    tt = torch.from_numpy(targ).requires_grad_()
    tval = tloss(tp, tt)
    tval.backward()
    assert tt.grad is None or not bool(tt.grad[..., :3].any())
    return (float(jval), jlogs, np.asarray(jgrad)), (tval.item(), tlogs, to_np(tp.grad))


def xyz_gradient(pred, targ, num_classes, kw):
    """d loss / d pred[..., :3] in float64 from the port's own assignment:
    w_i (x_i - y_a(i)) / sqrt(d_i + 1e-12) / sum(w)."""
    x, y = pred[..., :3].astype(np.float64), targ[..., :3].astype(np.float64)
    _, a = emd_match(torch.from_numpy(pred[..., :3]), torch.from_numpy(targ[..., :3]),
                     kw.get("eps", 0.002), kw.get("its", 60),
                     kw.get("method", "sinkhorn"), kw.get("anneal_from", 0.1))
    a = to_np(a).astype(np.int64)
    diff = x - np.take_along_axis(y, a[..., None], 1)
    d = (diff ** 2).sum(-1)
    w = np.ones_like(d)
    if num_classes is not None:
        labels = np.take_along_axis(targ[..., 3], a, 1).astype(np.int64)
        dist = np.bincount(labels.ravel(), minlength=num_classes) / labels.size
        cw = 1.0 / (dist + 1e-4)
        w = (cw / cw.sum())[labels]
    return (w / np.sqrt(d + 1e-12))[..., None] * diff / w.sum()


# (seed, B, N, num_classes, absent class, constructor arguments)
LOSS_CASES = {
    "features-train-point": (0, 2, 128, None, None,
                             dict(eps=0.005, its=50, anneal_from=None)),
    "features-eval-defaults": (1, 2, 96, None, None, {}),
    "classes-train-point": (2, 2, 128, 5, None,
                            dict(eps=0.005, its=50, num_classes=5, anneal_from=None)),
    "classes-absent-class": (3, 2, 128, 5, 3,
                             dict(eps=0.005, its=50, num_classes=5, anneal_from=None)),
    "classes-weight-0.5-auction": (4, 1, 64, 4, None,
                                   dict(eps=0.005, its=100, num_classes=4,
                                        feature_weight=0.5, method="auction",
                                        anneal_from=None)),
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_emd_loss_matches_jax(case):
    seed, B, N, C, absent, kw = LOSS_CASES[case]
    pred, targ = loss_inputs(seed, B, N, C, absent)
    if kw.get("method") != "auction":
        assert_margin(pred, targ, kw.get("eps", jcfg.emd_eval_eps),
                      kw.get("its", jcfg.emd_eval_iterations),
                      kw.get("anneal_from", jcfg.emd_anneal_from))
    if absent is not None:
        assert not (targ[..., 3] == absent).any()
    (jval, jlogs, jgrad), (tval, tlogs, tgrad) = both_losses(pred, targ, **kw)
    assert abs(tval - jval) <= TOL
    assert set(tlogs) == set(jlogs) == (LOG_KEYS if C is None else CLASS_KEYS)
    for k, v in jlogs.items():
        assert abs(tlogs[k] - v) <= TOL, k
    assert abs(tlogs["train_loss/EMD"] + tlogs["train_loss/feature"] - tval) <= 1e-6
    top = float(np.abs(jgrad).max())
    print(f"measured: loss {abs(tval - jval):.1e}, logs "
          f"{max(abs(tlogs[k] - v) for k, v in jlogs.items()):.1e}, gradient / largest "
          f"entry: features {np.abs(tgrad[..., 3:] - jgrad[..., 3:]).max() / top:.1e}, "
          f"xyz {np.abs(tgrad[..., :3] - jgrad[..., :3]).max() / top:.1e}")
    np.testing.assert_allclose(tgrad[..., 3:], jgrad[..., 3:], atol=TOL * top)
    if kw.get("method") == "auction":  # both sides store the same cost
        np.testing.assert_allclose(tgrad[..., :3], jgrad[..., :3], atol=TOL * top)
    else:
        np.testing.assert_allclose(tgrad[..., :3], jgrad[..., :3], atol=2e-3 * top)
        np.testing.assert_allclose(tgrad[..., :3], xyz_gradient(pred, targ, C, kw),
                                   atol=TOL * top)
    assert np.abs(tgrad[..., :3]).max() > 0 and np.abs(tgrad[..., 3:]).max() > 0


def test_emd_loss_defaults_are_the_jax_packages():
    j, t = jlosses.EarthMoverDistance(), tlosses.EarthMoverDistance()
    for name in ("eps", "iterations", "C", "feature_weight", "method", "anneal_from"):
        assert getattr(t, name) == getattr(j, name), name
    assert (t.eps, t.iterations, t.anneal_from, t.method) == (0.002, 60, 0.1, "sinkhorn")
    for name in ("emd_eps", "emd_iterations", "emd_test_eps", "emd_test_iterations",
                 "emd_eval_eps", "emd_eval_iterations", "emd_anneal_from",
                 "emd_method", "debug", "vision_lr"):
        assert getattr(tcfg, name) == getattr(jcfg, name), name


@pytest.mark.parametrize("num_classes", [None, 5])
def test_identical_clouds_give_zero_and_finite_gradients(num_classes):
    """sqrt(d + 1e-12) has slope 5e5 at d = 0 while dx is exactly 0 there:
    the product is 0, not NaN."""
    pred, targ = loss_inputs(5, 1, 64, num_classes)
    pred[..., :3] = targ[..., :3]
    kw = dict(eps=0.002, its=100, num_classes=num_classes, anneal_from=None)
    tp = torch.from_numpy(pred).requires_grad_()
    logs = {}
    loss = tlosses.EarthMoverDistance(**kw)
    loss.log = lambda k, v: logs.__setitem__(k, v.item())
    val = loss(tp, torch.from_numpy(targ))
    val.backward()
    assert torch.isfinite(val) and bool(torch.isfinite(tp.grad).all())
    assert not bool(tp.grad[..., :3].any())
    assert logs["train_loss/EMD"] <= 2e-6  # sqrt(1e-12) per point
    # off the TPU the JAX package forms the cost by the matmul expansion,
    # whose round-off (~1e-7) on a zero distance is ~3e-4 after the square
    # root: only its feature term compares tightly
    jlogs = {}
    jloss = jlosses.EarthMoverDistance(**kw)
    jloss.log = lambda k, v: jlogs.__setitem__(k, float(v))
    jloss(jnp.asarray(pred), jnp.asarray(targ))
    assert abs(logs["train_loss/feature"] - jlogs["train_loss/feature"]) <= TOL
    assert jlogs["train_loss/EMD"] <= 1e-3


def test_debug_checks_print_and_change_nothing(capsys, monkeypatch):
    pred, targ = loss_inputs(6, 1, 32, None)
    pred[0, 0, 0] = 1.5  # outside the unit cube
    loss = tlosses.EarthMoverDistance(eps=0.01, its=10, anneal_from=None)
    quiet = loss(torch.from_numpy(pred), torch.from_numpy(targ))
    assert capsys.readouterr().out == ""
    monkeypatch.setattr(tcfg, "debug", True)
    loud = loss(torch.from_numpy(pred), torch.from_numpy(targ))
    out = capsys.readouterr().out
    assert "pred coords outside [0,1]: True" in out
    assert "target coords outside [0,1]: False" in out
    assert "unassigned ratio" in out
    assert torch.equal(quiet, loud)


def test_pcsegmenter_matches_flax():
    rng = np.random.default_rng(7)
    z = rng.standard_normal((3, 13)).astype(np.float32)
    jm = JPCSegmenter(out_points=24, num_classes=5, hidden_sizes=(32, 48))
    tm = PCSegmenter(13, 24, 5, hidden_sizes=(32, 48))
    v = jax_variables(jm, z, 8)
    load_flax_variables(tm, v)
    want = np.asarray(jm.apply(v, jnp.asarray(z)))
    with torch.inference_mode():
        got = to_np(tm(torch.from_numpy(z)))
    assert got.shape == (3, 24, 8)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    # xyz through the sigmoid, logits raw
    assert got[..., :3].min() > 0 and got[..., :3].max() < 1
    assert got[..., 3:].min() < 0 and np.abs(got[..., 3:]).max() > 1


@pytest.mark.parametrize("backbone", ["PointNet", "PointNet2"])
def test_segae_matches_flax_after_interop(backbone):
    rng = np.random.default_rng(9)
    N = 64 if backbone == "PointNet" else 640
    x = rng.random((2, N, 6), dtype=np.float32)
    jm = JSegAE(jbackbones[backbone](feature_dims=3), num_classes=5, out_points=32,
                bottleneck=13)
    tm = SegAE(backbone_factory[backbone](feature_dims=3), num_classes=5,
               out_points=32, bottleneck=13)
    v = jax_variables(jm, x, 10)
    assert set(flax_to_state_dict(v)) == set(tm.state_dict())
    load_flax_variables(tm, v)
    w = v["params"]["decoder"]["MLP_0"]["Dense_3"]["kernel"]
    assert w.shape == (2048, 32 * 8)
    np.testing.assert_array_equal(to_np(tm.decoder.MLP_0.Dense_3.weight), w.T)
    assert tm.decoder.MLP_0.Dense_3.weight.dtype == torch.float32
    if backbone == "PointNet2":
        return  # its forward parity needs ball margins: the slice test holds it
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    jenc = np.asarray(jm.apply(v, jnp.asarray(x), train=False, method=jm.encode))
    with torch.inference_mode():
        got = to_np(tm(torch.from_numpy(x)))
        tenc = to_np(tm.encode(torch.from_numpy(x)))
    assert got.shape == (2, 32, 8)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tenc, jenc, atol=1e-4, rtol=1e-4)


def test_interop_of_a_segae_tree_stays_total():
    x = np.random.default_rng(11).random((1, 16, 6), dtype=np.float32)
    jm = JSegAE(jbackbones["PointNet"](feature_dims=3), num_classes=5, out_points=8,
                bottleneck=13)
    tm = SegAE(backbone_factory["PointNet"](feature_dims=3), num_classes=5,
               out_points=8, bottleneck=13)
    v = jax_variables(jm, x, 12)
    w = v["params"]["decoder"]["MLP_0"]["Dense_0"]["kernel"]

    def edited(edit):
        tree = jax.tree_util.tree_map(lambda a: a, v)
        edit(tree)
        return tree

    with pytest.raises(KeyError, match="missing"):
        load_flax_variables(tm, edited(
            lambda t: t["params"]["decoder"]["MLP_0"].pop("Dense_3")))
    with pytest.raises(KeyError, match="unknown"):
        load_flax_variables(tm, edited(
            lambda t: t["params"]["decoder"].__setitem__(
                "MLP_1", {"Dense_0": {"kernel": w, "bias": w[0]}})))
    with pytest.raises(KeyError, match="unknown flax leaf"):
        flax_to_state_dict(edited(
            lambda t: t["params"]["decoder"]["MLP_0"]["Dense_0"].__setitem__(
                "logits", w[0])))
    # an AE tree (6 output dims) does not fit the segmenter's 3 + 5
    with pytest.raises(ValueError):
        load_flax_variables(tm, edited(
            lambda t: t["params"]["decoder"]["MLP_0"]["Dense_3"].__setitem__(
                "kernel", np.zeros((2048, 8 * 6), np.float32))))
