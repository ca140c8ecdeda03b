"""Checkpoints and the training loop of the MultiSegmenter and the
StatePredictor on the CPU.

Adam's state from the JAX package: it takes three optax.adam steps of
`create_model(model_type, "PointNet", "Cube")` (each step a cloud of its
own, repeated, B=2, 256 points; the MultiSegmenter's target a labelled
cloud, the StatePredictor's a dict of states), its state goes through
interop.checkpoint_from_jax and the port's checkpoint file, and both
packages take a fourth step from it. The fourth update is held by
tests/test_torch_checkpoint.py's rule (1e-3 relative where the fourth
gradient is above noise, plus two roundings of the parameter and what a
1e-3 change of the gradient moves an update whose carried moment nearly
cancels it; every entry at most 2 lr apart), and a planted reset of Adam's
state fails it.

Then train() of each model type for one epoch over npz frames written by
the JAX package's generator (16 train and 4 val frames of 128 points, the
Cube scene's point budget patched to 128 in both scene tables, B=4), the
StatePredictor's through BatchLoader and dict batches; and the
checkpoint's encoder loaded with encoder_only (the bottlenecks and heads
load, the decoders stay fresh) and used by `encode`.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_port_utils  # noqa: F401  (one torch thread per worker)
from test_torch_checkpoint import check_carried_update, jax_moments
from test_torch_train_slice import LR, params_np, port_params
from torch_heads_utils import as_jax, as_torch, batch, jax_first_step, jax_spec, repeat

from pointcloud_tpu.envs import scenes as jscenes
from pointcloud_tpu.envs.synthetic import generate_dataset
from pointcloud_tpu.train import harness as jharness
from pointcloud_tpu_torch.envs import scenes as tscenes
from pointcloud_tpu_torch.interop import checkpoint_from_jax
from pointcloud_tpu_torch.train import harness as tharness
from pointcloud_tpu_torch.train.harness import zero_gradient_biases

MODELS = ["MultiSegmenter", "StatePredictor"]
STEPS = 3  # as test_torch_checkpoint's: the carried update is the fourth
N_PTS, B = 128, 4


@pytest.fixture(scope="module", params=MODELS)
def jax_run(request):
    """The JAX package's three steps, its fourth step's gradient and
    update, and its state as the JAX train() writes it."""
    model_type = request.param
    sc = jharness.scene_config("Cube")
    batches = [tuple(repeat(a) for a in batch(model_type, sc, 10 + i))
               for i in range(STEPS + 1)]
    jspec, v = jax_spec(model_type, "Cube", batches[0][0])
    tx = optax.adam(LR)
    params, stats = v["params"], v["batch_stats"]
    opt_state = tx.init(params)
    jstep = jharness.make_train_step(jspec, tx)
    for x, y in batches[:STEPS]:
        params, stats, opt_state, _, _ = jstep(params, stats, opt_state,
                                              jnp.asarray(x), as_jax(y))
    host = jax.tree_util.tree_map(np.array, {"params": params, "batch_stats": stats})
    payload = {**host, "epoch": np.asarray(0), "opt_state_leaves": {
        str(i): np.array(leaf) for i, leaf in enumerate(jax.tree_util.tree_leaves(opt_state))}}
    x, y = batches[STEPS]
    _, grads = jax_first_step(jspec, host, x, y)
    params, stats, opt_state, _, _ = jstep(params, stats, opt_state,
                                          jnp.asarray(x), as_jax(y))
    return {"model_type": model_type, "x": x, "y": y, "payload": payload,
            "grads": grads, "before": params_np(host["params"]),
            "after": params_np(params)}


def port_fourth_update(j, tmp_path, reset=False):
    """checkpoint_from_jax, written and read back as a checkpoint file, then
    a fourth step: (spec, parameters before, parameters after)."""
    ck = checkpoint_from_jax(j["payload"], j["model_type"], "PointNet", "Cube")
    assert ck["config"]["model_type"] == j["model_type"] and ck["epoch"] == 0
    path = tharness.save_checkpoint(str(tmp_path), 0, ck)
    ck = tharness.load_checkpoint_raw(path)
    assert {float(s["step"]) for s in ck["optimizer"]["state"].values()} == {STEPS}
    spec = tharness.create_model(j["model_type"], "PointNet", "Cube", device="cpu", seed=3)
    opt = tharness.make_optimizer(spec)
    tharness.load_state(spec.model, ck["model"])
    if not reset:  # the planted fault: Adam starts afresh at the fourth step
        opt.load_state_dict(ck["optimizer"])
    before = port_params(spec)
    tharness.make_train_step(spec, opt)(as_torch(j["x"]), as_torch(j["y"]))
    return spec, before, port_params(spec)


def test_converted_state_takes_jax_fourth_update(jax_run, tmp_path):
    j = jax_run
    spec, before, after = port_fourth_update(j, tmp_path)
    for k in before:
        np.testing.assert_array_equal(before[k], j["before"][k], err_msg=k)
    check_carried_update(after, j["after"], before, j["grads"],
                         jax_moments(j["payload"])[1], zero_gradient_biases(spec.model))


def test_adam_reset_fails_the_rule(jax_run, tmp_path):
    j = jax_run
    spec, before, after = port_fourth_update(j, tmp_path, reset=True)
    with pytest.raises(AssertionError):
        check_carried_update(after, j["after"], before, j["grads"],
                             jax_moments(j["payload"])[1], zero_gradient_biases(spec.model))


############################ the loop ############################


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("input_root")
    d = root / "Cube"
    generate_dataset(str(d / "train"), scene="Cube", frames=16, seed=0, sample_points=N_PTS)
    generate_dataset(str(d / "val"), scene="Cube", frames=4, seed=99, sample_points=N_PTS)
    return str(root)


@pytest.fixture
def small_scene(monkeypatch):
    for scenes in (jscenes, tscenes):
        monkeypatch.setitem(scenes.cfg_scene, "Cube", dict(scenes.cfg_scene["Cube"],
                                                            sample_points=N_PTS))


@pytest.mark.parametrize("model_type", MODELS)
def test_train_one_epoch_and_load_the_encoder(model_type, data_root, tmp_path, small_scene):
    epochs = []
    loss, ckpt_dir = tharness.train(model_type, "PointNet", "Cube", epochs=1, batch_size=B,
                                    input_root=data_root, output_root=str(tmp_path),
                                    device="cpu", on_epoch=epochs.append)
    assert np.isfinite(loss) and np.isfinite(epochs[0]["val_loss"])
    assert epochs[0]["steps"] == 16 // B and epochs[0]["global_step"] == 16 // B
    assert ckpt_dir.endswith(os.path.join(f"{model_type}_PointNet", "version_0",
                                          "checkpoints"))
    last = tharness.latest_checkpoint(ckpt_dir)
    assert last.endswith("step_0")
    ck = tharness.load_checkpoint_raw(last)
    assert ck["config"]["model_type"] == model_type
    assert {float(s["step"]) for s in ck["optimizer"]["state"].values()} == {16.0 / B}

    spec = tharness.create_model(model_type, "PointNet", "Cube", device="cpu", seed=5,
                                 load_dir=last, encoder_only=True)
    fresh = tharness.create_model(model_type, "PointNet", "Cube", device="cpu",
                                  seed=5).model.state_dict()
    for key, value in spec.model.state_dict().items():
        want = fresh[key] if key.startswith("decoder") else ck["model"][key]
        assert torch.equal(value, want), key
    assert any(k.startswith(("bottleneck_", "head_")) for k in ck["model"])
    x = torch.from_numpy(batch(model_type, spec.scene, 0, b=1, n=N_PTS)[0])
    with torch.inference_mode():
        z = spec.model.encode(spec.in_transform(x)[0])
    if model_type == "MultiSegmenter":
        assert set(z) == {"cube", "arm", "gripper"}
        assert spec.model.encode_flat(spec.in_transform(x)[0]).shape == (1, 13)
    else:
        assert z.shape == (1, 6) and bool(((z >= 0) & (z <= 1)).all())


def test_state_predictor_val_batches_are_dicts(data_root, small_scene):
    spec = tharness.create_model("StatePredictor", "PointNet", "Cube", device="cpu")
    ds = spec.open_dataset(os.path.join(data_root, "Cube", "val"))
    loader = tharness.BatchLoader(ds, 3, shuffle=False, seed=0, threads=1, prefetch=1,
                                  drop_last=False)
    (x, y), (x2, y2) = list(loader)
    assert x.shape == (3, N_PTS, 6) and x2.shape == (1, N_PTS, 6)
    assert set(y) == {"cube_pos", "robot0_eef_pos"} and y["cube_pos"].shape == (3, 3)
    loss, _, out = tharness.make_eval_step(spec)(torch.from_numpy(x),
                                                 {k: torch.from_numpy(v) for k, v in y.items()})
    assert np.isfinite(float(loss)) and set(out) == set(y)
