"""The port's FilteringChamferDistance, SegmentingChamferDistance and
StatePredictionLoss against pointcloud_tpu.losses on the CPU: values and
gradients (torch autograd against jax.grad) at 1e-6 relative, the
gradients relative to the largest entry of each.

Both packages take the nearest neighbours from the same matmul expansion
of the squared distances (the JAX package's dense path on the CPU, the
port's plain nn_sweep), so they pick the same neighbours and the gradients,
which follow the matched pairs, agree to the order of their sums.

The segmenting loss is held at the Cube scene's expert sizes (21 / 820 /
103 points: Nmax = 820, no multiple of 64, which the JAX package pads to
832 and the port does not), with a target_mask, and with a class absent
from one target cloud: that cloud's predicted points of the class then have
every target masked, each gets 1e10 to target 0, and the loss carries
~1e10 in both packages (held relative to its size), with the gradient
through target 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_utils import to_np

from pointcloud_tpu import losses as jlosses
from pointcloud_tpu import transforms as jtf
from pointcloud_tpu_torch import losses as tlosses
from pointcloud_tpu_torch import transforms as ttf

REL = 1e-6
CUBE = {"cube": (1, 21), "arm": (2, 820), "gripper": (4, 103)}  # label, points


def seg_inputs(seed, B=3, N=600, sizes=CUBE, absent=None, masked=False):
    """pred {name: (B, n, 3)}, target (B, N, 4) with labels in [0, 5) at
    column 3, and a target mask. absent: (cloud, label) made absent."""
    rng = np.random.default_rng(seed)
    pred = {c: rng.random((B, n, 3), dtype=np.float32) for c, (_, n) in sizes.items()}
    target = rng.random((B, N, 4), dtype=np.float32)
    target[..., 3] = rng.integers(0, 5, (B, N)).astype(np.float32)
    if absent is not None:
        b, lab = absent
        target[b, :, 3] = np.where(target[b, :, 3] == lab, (lab + 1) % 5,
                                   target[b, :, 3])
    tmask = rng.random((B, N)) > 0.15 if masked else None
    return pred, target, tmask


def close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=REL, atol=REL * scale, err_msg=what)


def jax_value_and_grads(loss, pred, target, tmask):
    def f(p, t):
        kw = {} if tmask is None else {"target_mask": jnp.asarray(tmask)}
        return loss(p, t, **kw)

    val, (gp, gt) = jax.value_and_grad(f, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in pred.items()}, jnp.asarray(target))
    return float(val), {k: np.asarray(v) for k, v in gp.items()}, np.asarray(gt)


def torch_value_and_grads(loss, pred, target, tmask):
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in pred.items()}
    tt = torch.from_numpy(target).requires_grad_()
    kw = {} if tmask is None else {"target_mask": torch.from_numpy(tmask)}
    val = loss(tp, tt, **kw)
    val.backward()
    return float(val.detach()), {k: to_np(v.grad) for k, v in tp.items()}, to_np(tt.grad)


@pytest.mark.parametrize("absent,masked", [(None, False), (None, True),
                                           ((1, 1), False), ((2, 4), True)])
def test_segmenting_chamfer_matches_jax(absent, masked):
    pred, target, tmask = seg_inputs(0, absent=absent, masked=masked)
    labels = {c: lab for c, (lab, _) in CUBE.items()}
    want = jax_value_and_grads(jlosses.SegmentingChamferDistance(labels), pred,
                               target, tmask)
    got = torch_value_and_grads(tlosses.SegmentingChamferDistance(labels), pred,
                                target, tmask)
    assert abs(got[0] - want[0]) <= REL * abs(want[0])
    if absent is not None:
        assert 1e9 < got[0] < 1e11  # the absent class's 1e10 / B and the rest
    else:
        assert got[0] < 1.0
    for c in CUBE:
        close(got[1][c], want[1][c], c)
    close(got[2][..., :3], want[2][..., :3], "target xyz")
    assert not got[2][..., 3].any()


def test_absent_class_gradient_goes_through_target_0():
    """Cloud 1 lacks the cube: each of its cube points' gradient is
    2 (x - target[1, 0]) / (21 x B) in both packages."""
    pred, target, _ = seg_inputs(1, absent=(1, 1))
    labels = {c: lab for c, (lab, _) in CUBE.items()}
    got = torch_value_and_grads(tlosses.SegmentingChamferDistance(labels), pred,
                                target, None)
    want = 2.0 * (pred["cube"][1] - target[1, 0, :3]) / (21 * 3)
    np.testing.assert_allclose(got[1]["cube"][1], want, rtol=1e-5, atol=1e-9)


def test_segmenting_chamfer_sums_filtering_chamfers():
    """One stacked sweep equals the sum over classes of a
    FilteringChamferDistance each, as in the JAX package's test."""
    pred, target, tmask = seg_inputs(2, masked=True)
    labels = {c: lab for c, (lab, _) in CUBE.items()}
    seg = float(tlosses.SegmentingChamferDistance(labels)(
        {k: torch.from_numpy(v) for k, v in pred.items()}, torch.from_numpy(target),
        target_mask=torch.from_numpy(tmask)))
    parts = sum(float(tlosses.FilteringChamferDistance(ttf.FilterClasses([lab], 3))(
        torch.from_numpy(pred[c]), torch.from_numpy(target),
        target_mask=torch.from_numpy(tmask))) for c, (lab, _) in CUBE.items())
    assert abs(seg - parts) <= REL * parts


def test_peg_in_hole_sizes_match_jax():
    """PegInHole's experts: 820 / 615 / 615 points, labels 0 / 1 / 4."""
    sizes = {"peg_hole": (0, 820), "robot0": (1, 615), "robot1": (4, 615)}
    pred, target, _ = seg_inputs(3, B=2, N=400, sizes=sizes)
    labels = {c: lab for c, (lab, _) in sizes.items()}
    want = jax_value_and_grads(jlosses.SegmentingChamferDistance(labels), pred,
                               target, None)
    got = torch_value_and_grads(tlosses.SegmentingChamferDistance(labels), pred,
                                target, None)
    assert abs(got[0] - want[0]) <= REL * abs(want[0])
    for c in sizes:
        close(got[1][c], want[1][c], c)


@pytest.mark.parametrize("masked", [False, True])
def test_filtering_chamfer_matches_jax(masked):
    rng = np.random.default_rng(4)
    pred = rng.random((3, 150, 3), dtype=np.float32)
    _, target, tmask = seg_inputs(5, masked=masked)
    jl = jlosses.FilteringChamferDistance(jtf.FilterClasses([1, 2], seg_dim=3))
    tl = tlosses.FilteringChamferDistance(ttf.FilterClasses([1, 2], seg_dim=3))
    kw_j = {} if tmask is None else {"target_mask": jnp.asarray(tmask)}
    kw_t = {} if tmask is None else {"target_mask": torch.from_numpy(tmask)}
    want, (gp, gt) = jax.value_and_grad(lambda p, t: jl(p, t, **kw_j), argnums=(0, 1))(
        jnp.asarray(pred), jnp.asarray(target))
    tp = torch.from_numpy(pred).requires_grad_()
    tt = torch.from_numpy(target).requires_grad_()
    got = tl(tp, tt, **kw_t)
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= REL * float(want)
    close(to_np(tp.grad), gp, "pred")
    close(to_np(tt.grad), gt, "target")


@pytest.mark.parametrize("scene", ["Cube", "PegInHole"])
def test_state_prediction_loss_matches_jax(scene):
    """The StatePredictor's loss as create_model builds it in both packages
    (norm_pos on the 3-d states only, quaternions and 1-d states as they
    are), against the same predictions and raw targets."""
    from pointcloud_tpu.train import harness as jharness
    from pointcloud_tpu_torch.train import harness as tharness

    jloss = jharness.create_model("StatePredictor", "PointNet", scene)[0].loss
    tloss = tharness.create_model("StatePredictor", "PointNet", scene,
                                  device="cpu").loss
    assert tloss.states == jloss.states
    rng = np.random.default_rng(6)
    sc = tharness.scene_config(scene)
    dims = {n: d for n, d in zip(sc.states, sc.state_dim) if d > 0}
    bbox = np.asarray(sc.bbox, np.float32)
    pred = {n: rng.random((4, d), dtype=np.float32) for n, d in dims.items()}
    target = {n: (bbox[:, 0] + rng.random((4, 3), dtype=np.float32)
                  * (bbox[:, 1] - bbox[:, 0])) if d == 3
              else rng.standard_normal((4, d)).astype(np.float32)
              for n, d in dims.items()}
    want, gp = jax.value_and_grad(jloss)(
        {k: jnp.asarray(v) for k, v in pred.items()},
        {k: jnp.asarray(v) for k, v in target.items()})
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in pred.items()}
    got = tloss(tp, {k: torch.from_numpy(v) for k, v in target.items()})
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= REL * float(want)
    for k in dims:
        close(to_np(tp[k].grad), np.asarray(gp[k]), k)
    # the 3-d states are normalised, the others pass through
    for k, d in dims.items():
        t = torch.from_numpy(target[k])
        same = torch.equal(tloss.t[k](t), t)
        assert same == (d != 3), k


def test_state_prediction_loss_default_transform():
    loss = tlosses.StatePredictionLoss(["a", "b"], {"a": lambda x: 2 * x})
    pred = {"a": torch.ones(2, 3), "b": torch.zeros(2, 1)}
    target = {"a": torch.ones(2, 3), "b": torch.ones(2, 1), "c": torch.ones(2, 9)}
    assert float(loss(pred, target)) == pytest.approx((1.0 + 1.0) / 2)


def test_one_class_matches_jax():
    """The Table scene's MultiSegmenter has one expert (the gripper, 103
    points): the stack is the target's xyz itself, made contiguous."""
    sizes = {"gripper": (4, 103)}
    pred, target, tmask = seg_inputs(7, B=2, N=300, sizes=sizes, masked=True)
    want = jax_value_and_grads(jlosses.SegmentingChamferDistance({"gripper": 4}), pred,
                               target, tmask)
    got = torch_value_and_grads(tlosses.SegmentingChamferDistance({"gripper": 4}), pred,
                                target, tmask)
    assert abs(got[0] - want[0]) <= REL * abs(want[0])
    close(got[1]["gripper"], want[1]["gripper"], "gripper")
