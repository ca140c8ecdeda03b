"""The MultiSegmenter slice as a whole against the JAX package's, on the
CPU, through the real entry points: `create_model("MultiSegmenter",
"PointNet", scene)` for the Cube scene (experts cube / arm / gripper of 21 /
820 / 103 points: the segmenting loss's Nmax = 820) and PegInHole (peg_hole
/ robot0 / robot1 of 820 / 615 / 615), B=2 clouds of 256 points, with
`make_eval_step` on random interop-converted weights and the train steps
from the flax init against `pointcloud_tpu.train.harness.make_train_step(
spec, optax.adam(1e-3))`.

Tolerances are tests/test_torch_train_slice.py's, for the same reasons (the
STN heads normalise over a batch of two): the eval outputs 1e-4, the eval
and first-step losses 1e-5 relative; the first step's gradients 1e-3
relative plus 3e-3 of each tensor's largest entry, the STN heads' last
weight on 98% of its entries, the zero-gradient biases round-off; the first
update 1e-3 relative where the gradient is above noise; over three steps on
one repeated cloud the losses 1e-3 relative, the running statistics 1e-3,
the parameters 2 lr a step.
"""

import numpy as np
import pytest
import torch
from test_torch_train_slice import (
    LR,
    check_first_step_grads,
    check_first_update,
    port_params,
)
from torch_heads_utils import (
    STEPS,
    as_jax,
    as_torch,
    batch,
    jax_first_step,
    jax_spec,
    jax_steps,
    port_spec,
    repeat,
)
from torch_port_utils import random_variables, to_np

from pointcloud_tpu.train import harness as jharness
from pointcloud_tpu_torch.data.dataset import PointCloudDataset
from pointcloud_tpu_torch.interop import flax_to_state_dict
from pointcloud_tpu_torch.train import harness as tharness
from pointcloud_tpu_torch.train.harness import zero_gradient_biases

MODEL = "MultiSegmenter"
SIZES = {"Cube": (("cube", 21, 3), ("arm", 820, 7), ("gripper", 103, 3)),
         "PegInHole": (("peg_hole", 820, 14), ("robot0", 615, 7), ("robot1", 615, 7))}


@pytest.fixture(scope="module", params=["Cube", "PegInHole"])
def jax_side(request):
    """The JAX spec, its flax init, a random variable set, the batches and
    the JAX package's results on them."""
    scene = request.param
    sc = jharness.scene_config(scene)
    x, y = batch(MODEL, sc, 0)
    jspec, v = jax_spec(MODEL, scene, x)
    vr = random_variables(v, np.random.default_rng(1))
    jl, _, jout = jharness.make_eval_step(jspec)(vr["params"], vr["batch_stats"],
                                                 as_jax(x), as_jax(y))
    first = jax_first_step(jspec, v, x, y)
    xr, yr = repeat(x), repeat(y)
    steps = jax_steps(jspec, v, xr, yr)
    return {"scene": scene, "jspec": jspec, "v": v, "vr": vr, "x": x, "y": y,
            "eval": (float(jl), {k: np.asarray(o) for k, o in jout.items()}),
            "first": first, "xr": xr, "yr": yr, "steps": steps,
            "grads_r": jax_first_step(jspec, v, xr, yr)[1]}


def test_create_model_wiring(jax_side):
    j = jax_side
    jspec = j["jspec"]
    tspec = tharness.create_model(MODEL, "PointNet", j["scene"], device="cpu",
                                  loss_override="chamfer")  # ignored, as in JAX
    assert tspec.model.name_points_dims == tuple(jspec.model.name_points_dims)
    assert tspec.model.name_points_dims == SIZES[j["scene"]]
    assert tspec.model.class_labels == dict(jspec.model.class_labels)
    assert tspec.loss.class_labels == jspec.loss.class_labels
    assert type(tspec.loss).__name__ == "SegmentingChamferDistance"
    assert not tspec.dict_target and tspec.out_transform is not None
    assert set(tspec.model.state_dict()) == set(flax_to_state_dict(j["v"]))
    ds = tspec.open_dataset(".")
    assert isinstance(ds, PointCloudDataset) and ds.out_features == ["segmentation"]


def test_eval_step_matches_jax(jax_side):
    j = jax_side
    tspec = port_spec(MODEL, j["scene"], j["vr"])
    tl, logs, tout = tharness.make_eval_step(tspec)(as_torch(j["x"]), as_torch(j["y"]))
    jl, jout = j["eval"]
    # jit returns the dict with sorted keys; the port keeps the experts' order
    assert logs == {} and sorted(tout) == sorted(jout)
    assert list(tout) == [n for n, _, _ in SIZES[j["scene"]]]
    for k, w in jout.items():
        np.testing.assert_allclose(to_np(tout[k]), w, atol=1e-4, rtol=1e-4, err_msg=k)
    assert abs(float(tl) - jl) <= 1e-5 * jl


def test_first_train_step_matches_jax(jax_side):
    """Two distinct clouds: the first step's loss and gradients."""
    j = jax_side
    tspec = port_spec(MODEL, j["scene"], j["v"])
    step = tharness.make_train_step(tspec, tharness.make_optimizer(tspec))
    loss, logs = step(as_torch(j["x"]), as_torch(j["y"]))
    jloss, jgrads = j["first"]
    assert logs == {} and loss.shape == ()
    assert abs(loss.item() - jloss) <= 1e-5 * jloss
    check_first_step_grads({k: to_np(p.grad) for k, p in tspec.model.named_parameters()},
                           jgrads, 1e-3, zero_gradient_biases(tspec.model),
                           head_weights_frac=0.98)


def test_three_train_steps_match_jax(jax_side):
    """One cloud repeated: three steps, the first update, then parameters
    and running statistics."""
    j = jax_side
    tspec = port_spec(MODEL, j["scene"], j["v"])
    init = port_params(tspec)
    step = tharness.make_train_step(tspec, tharness.make_optimizer(tspec))
    zero = zero_gradient_biases(tspec.model)
    jlosses, jafter1, final = j["steps"]
    tlosses = []
    for i in range(STEPS):
        tlosses.append(step(as_torch(j["xr"]), as_torch(j["yr"]))[0].item())
        if i == 0:
            check_first_step_grads(
                {k: to_np(p.grad) for k, p in tspec.model.named_parameters()},
                j["grads_r"], 1e-3, zero)
            check_first_update(port_params(tspec), jafter1, init, j["grads_r"], zero)
    assert abs(tlosses[0] - jlosses[0]) <= 1e-5 * jlosses[0]
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-3)
    assert all(np.isfinite(tlosses))
    got = tspec.model.state_dict()
    assert set(got) == set(final)
    for k, w in final.items():
        if k.endswith((".mean", ".var")):
            np.testing.assert_allclose(to_np(got[k]), w, atol=1e-3, rtol=1e-3, err_msg=k)
        else:
            np.testing.assert_allclose(to_np(got[k]), w, atol=2 * STEPS * LR, err_msg=k)


def test_absent_class_loss_follows_jax(jax_side):
    """A target cloud without one expert's class: the eval loss carries
    ~1e10 in both packages, held relative to its size."""
    j = jax_side
    y = j["y"].copy()
    lab = j["jspec"].loss.class_labels[SIZES[j["scene"]][0][0]]
    y[1, :, 3] = np.where(y[1, :, 3] == lab, (lab + 1) % 5, y[1, :, 3])
    tspec = port_spec(MODEL, j["scene"], j["vr"])
    tl = float(tharness.make_eval_step(tspec)(as_torch(j["x"]), as_torch(y))[0])
    jl = float(jharness.make_eval_step(j["jspec"])(
        j["vr"]["params"], j["vr"]["batch_stats"], as_jax(j["x"]), as_jax(y))[0])
    assert 1e9 < jl < 1e11
    assert abs(tl - jl) <= 1e-5 * jl


def test_multi_seg_ae_methods_on_the_spec(jax_side):
    """encode / encode_flat / reconstruct_labeled of the built model."""
    j = jax_side
    tspec = port_spec(MODEL, j["scene"], j["vr"])
    xn = tspec.in_transform(as_torch(j["x"]))[0]
    with torch.inference_mode():
        enc = tspec.model.encode(xn)
        flat = tspec.model.encode_flat(xn)
        lab = tspec.model.reconstruct_labeled(xn)
    sizes = SIZES[j["scene"]]
    assert [tuple(enc[n].shape) for n, _, _ in sizes] == [(2, d) for _, _, d in sizes]
    assert flat.shape == (2, sum(d for _, _, d in sizes))
    assert lab.shape == (2, sum(n for _, n, _ in sizes), 4)
