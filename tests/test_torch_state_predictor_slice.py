"""The StatePredictor slice as a whole against the JAX package's, on the
CPU, through the real entry points: `create_model("StatePredictor",
"PointNet", scene)` for the Cube scene (heads cube_pos and robot0_eef_pos,
both 3-d, both through norm_pos) and PegInHole (peg_to_hole, peg_quat,
hole_pos, hole_quat, t, d, angle: 3 / 4 / 3 / 4 / 1 / 1 / 1, only the 3-d
ones through norm_pos), B=2 clouds of 256 points and dicts of raw states,
with `make_eval_step` on random interop-converted weights and the train
steps from the flax init against `pointcloud_tpu.train.harness.
make_train_step(spec, optax.adam(1e-3))`.

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
from pointcloud_tpu_torch.data.dataset import PointCloudGTDataset
from pointcloud_tpu_torch.interop import flax_to_state_dict
from pointcloud_tpu_torch.train import harness as tharness
from pointcloud_tpu_torch.train.harness import zero_gradient_biases

MODEL = "StatePredictor"
STATES = {"Cube": {"cube_pos": 3, "robot0_eef_pos": 3},
          "PegInHole": {"peg_to_hole": 3, "peg_quat": 4, "hole_pos": 3, "hole_quat": 4,
                        "t": 1, "d": 1, "angle": 1}}


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
    assert tspec.model.state_dims == dict(jspec.model.state_dims) == STATES[j["scene"]]
    assert tspec.loss.states == jspec.loss.states == list(STATES[j["scene"]])
    assert type(tspec.loss).__name__ == "StatePredictionLoss"
    assert tspec.dict_target and tspec.out_transform is None
    assert set(tspec.model.state_dict()) == set(flax_to_state_dict(j["v"]))
    ds = tspec.open_dataset(".")
    assert isinstance(ds, PointCloudGTDataset) and ds.in_features == ["rgb"]


def test_eval_step_matches_jax(jax_side):
    j = jax_side
    tspec = port_spec(MODEL, j["scene"], j["vr"])
    tl, logs, tout = tharness.make_eval_step(tspec)(as_torch(j["x"]), as_torch(j["y"]))
    jl, jout = j["eval"]
    # jit returns the dict with sorted keys; the port keeps the states' order
    assert logs == {} and sorted(tout) == sorted(jout)
    assert list(tout) == list(STATES[j["scene"]])
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


def test_encode_matches_jax(jax_side):
    """encode concatenates the heads in state_dims order, as the JAX
    package's (held to its output, not assumed)."""
    import jax.numpy as jnp

    j = jax_side
    tspec = port_spec(MODEL, j["scene"], j["vr"])
    xn = tspec.in_transform(as_torch(j["x"]))[0]
    with torch.inference_mode():
        got = tspec.model.encode(xn)
    want = j["jspec"].model.apply(j["vr"], jnp.asarray(to_np(xn)), train=False,
                                  method=j["jspec"].model.encode)
    assert got.shape == (2, sum(STATES[j["scene"]].values()))
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-4, rtol=1e-4)
