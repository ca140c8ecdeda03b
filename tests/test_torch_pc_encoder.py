"""The port's encoder zoo (vision/pc_encoder.py) against the JAX package's on
the CPU, on the PointNet backbone at 128 points (the zoo subclassed with
`backbone = "PointNet"` and the scenes' point budget patched in both scene
tables, as tests/test_vision_envs.py does); tests/test_torch_pc_encoder_pn2*.py
run the default PointNet2 at 2,048 points.

Weights: random flax variables written by the JAX package's save_checkpoint
and converted by convert_checkpoint_torch.convert into the port's root
(tests/torch_bridge_utils.py); each package's encoders read their own root.

Tolerance: encodings and StatePredictor predictions (after to_state) fp32,
1e-4 of the largest entry; the sensed clouds they read are equal (128
points). Checkpoint discovery, the latent-threshold sidecar and the pruned
heads exactly.
"""

import os

import numpy as np
import pytest
import torch
from torch_bridge_utils import (
    both_envs,
    close_to,
    output_roots,
    scenes_at,
    subclass,
    write_checkpoints,
)

from pointcloud_tpu.vision import pc_encoder as jenc
from pointcloud_tpu_torch.vision import pc_encoder as tenc

N_PTS = 128
ENCODERS = ["GlobalAEEncoder", "GlobalSegmenterEncoder", "MultiSegmenterEncoder",
            "StatePredictor", "StatePredictorVisualGoal"]


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("zoo")
    jroot, troot = str(base / "jax"), str(base / "port")
    with scenes_at(N_PTS, "Cube", "PegInHole"):
        for i, model_type in enumerate(["Autoencoder", "Segmenter", "MultiSegmenter",
                                        "StatePredictor"]):
            write_checkpoints(jroot, troot, "Cube", model_type, "PointNet", 10 + i)
        write_checkpoints(jroot, troot, "PegInHole", "StatePredictor", "PointNet", 20)
        yield jroot, troot


@pytest.fixture
def zoo(roots):
    with scenes_at(N_PTS, "Cube", "PegInHole"), output_roots(*roots):
        yield roots


def test_model_path_ordering(tmp_path):
    """Versions by (length, name), steps by number: version_10 after
    version_2, step_10 after step_9; the metadata sidecar beside them; the
    same paths as the JAX package's."""
    for version in ("version_2", "version_10"):
        for step in ("step_9", "step_10", "step_1"):
            os.makedirs(tmp_path / "Cube" / "Autoencoder_PointNet2" / version
                        / "checkpoints" / step)
    root = str(tmp_path)
    base = os.path.join(root, "Cube", "Autoencoder_PointNet2")
    want = os.path.join(base, "version_10", "checkpoints", "step_10")
    assert tenc.model_path("Cube", "Autoencoder", output_root=root) == want
    assert tenc.model_path("Cube", "Autoencoder", version=2, output_root=root) == \
        os.path.join(base, "version_2", "checkpoints", "step_10")
    assert tenc.metadata_path("Cube", "Autoencoder", output_root=root) == \
        os.path.join(base, "version_10", "metadata", "step_10.npz")
    for args in ({}, {"version": 2}):
        assert tenc.model_path("Cube", "Autoencoder", output_root=root, **args) == \
            jenc.model_path("Cube", "Autoencoder", output_root=root, **args)
        assert tenc.metadata_path("Cube", "Autoencoder", output_root=root, **args) == \
            jenc.metadata_path("Cube", "Autoencoder", output_root=root, **args)
    with pytest.raises(FileNotFoundError, match="train_torch.py"):
        tenc.model_path("Cube", "Segmenter", output_root=root)


def test_a_jax_checkpoint_points_at_the_converter(zoo):
    with pytest.raises(FileNotFoundError, match="convert_checkpoint_torch.py"):
        tenc.load_model("Cube", "Autoencoder", "PointNet", output_root=zoo[0],
                        device="cpu")


@pytest.mark.parametrize("encoder", ENCODERS)
def test_encoders_match_jax(zoo, encoder):
    """RoboPush with the PointCloudSensor and each encoder: reset's goal
    dict, encode_observation / encode_goal / __call__ on the same sensed
    cloud, and the spaces."""
    jenv, tenv = both_envs("RoboPush", encoder)
    got, _ = tenv.reset(seed=3)
    want, _ = jenv.reset(seed=3)
    for k in want:
        close_to(got[k], want[k], what=f"{encoder} {k}")
    assert tenv.visual_goal == jenv.visual_goal
    for obs in (tenv.observation, tenv.goal_obs):
        pairs = [(tenv.encoder(obs), jenv.encoder(obs)),
                 ([tenv.encoder.encode_observation(obs)],
                  [jenv.encoder.encode_observation(obs)]),
                 ([tenv.encoder.encode_goal(obs)], [jenv.encoder.encode_goal(obs)])]
        for gs, ws in pairs:
            for g, w in zip(gs, ws):
                assert g.dtype == np.float32
                close_to(g, w, what=encoder)
    for name in ("observation", "achieved_goal", "desired_goal"):
        assert tenv.observation_space.spaces[name].shape == \
            jenv.observation_space.spaces[name].shape
    if encoder.startswith("StatePredictor"):
        got, want = (tenv.encoder.predict_states(tenv.observation),
                     jenv.encoder.predict_states(tenv.observation))
        assert list(got) == ["cube_pos"] or set(got) == set(want)
        for k in want:
            close_to(got[k], want[k], what=f"{encoder} {k}")
        assert tenv.visual_goal is (encoder == "StatePredictorVisualGoal")
    tenv.step(np.full(4, 0.3, np.float32))
    jenv.step(np.full(4, 0.3, np.float32))
    close_to(tenv.encoding, jenv.encoding, what=f"{encoder} step")


@pytest.mark.parametrize("encoder", ["MultiSegmenterEncoder", "StatePredictorVisualGoal"])
@pytest.mark.parametrize("obs_keys", [["robot0_eef_pos", "cube_pos"],
                                      ["cube_pos", "robot0_eef_pos"]])
def test_per_class_order_follows_the_keys(zoo, encoder, obs_keys):
    """The per-class / per-state encodings concatenate in the order of
    obs_keys and goal_keys, never the model's dict order."""
    jenv, tenv = both_envs("RoboPush", encoder)
    tenv.reset(seed=5)
    obs = tenv.observation
    goal_keys = list(reversed(obs_keys))
    t = subclass(getattr(tenc, encoder), "PointNet")(tenv, obs_keys, goal_keys)
    j = subclass(getattr(jenc, encoder), "PointNet")(jenv, obs_keys, goal_keys)
    for g, w in zip(t(obs), j(obs)):
        close_to(g, w, what=f"{encoder} {obs_keys}")
    if encoder == "MultiSegmenterEncoder":
        parts = t.encode_classes(obs)
        want = np.concatenate([parts[t.state_to_class[k]] for k in obs_keys])
        np.testing.assert_array_equal(t.encode_observation(obs), want)


def test_remove_unused_keeps_the_whitelist(zoo):
    """_remove_unused keeps the whitelisted heads in the model's order over
    the same backbone and heads; load_model drops the pruned heads' keys
    and loads the rest exactly."""
    from pointcloud_tpu.train import harness as jharness
    from pointcloud_tpu_torch.train import harness as tharness

    spec = tharness.create_model("MultiSegmenter", "PointNet", "Cube", device="cpu")
    jspec, _ = jharness.create_model("MultiSegmenter", "PointNet", "Cube")
    pruned = tenc._remove_unused(spec.model, {"gripper", "cube"})
    jpruned = jenc._remove_unused(jspec.model, {"gripper", "cube"})
    assert pruned.name_points_dims == tuple(jpruned.name_points_dims)
    assert [n for n, _, _ in pruned.name_points_dims] == ["cube", "gripper"]
    assert pruned.preencoder is spec.model.preencoder
    assert pruned.bottleneck_cube is spec.model.bottleneck_cube
    assert not any(k.startswith(("bottleneck_arm", "decoder_arm"))
                   for k in pruned.state_dict())
    spec = tharness.create_model("StatePredictor", "PointNet", "Cube", device="cpu")
    jspec, _ = jharness.create_model("StatePredictor", "PointNet", "Cube")
    pruned = tenc._remove_unused(spec.model, {"cube_pos"})
    assert pruned.state_dims == dict(jenc._remove_unused(jspec.model, {"cube_pos"}).state_dims)
    assert list(pruned.state_dict()) == [k for k in spec.model.state_dict()
                                         if not k.startswith("head_robot0_eef_pos")]

    module, _ = tenc.load_model("Cube", "MultiSegmenter", "PointNet", whitelist={"cube"},
                                device="cpu")
    ck = tharness.load_checkpoint_raw(tenc.model_path("Cube", "MultiSegmenter", "PointNet"))
    assert [n for n, _, _ in module.name_points_dims] == ["cube"]
    for k, v in module.state_dict().items():
        if not k.startswith("decoder_"):
            assert torch.equal(v, ck["model"][k]), k


def test_latent_threshold_round_trip(zoo):
    """No sidecar: None; saved, reloaded by a new env's encoder; the
    per-dim check in check_success, as the JAX package's."""
    jenv, tenv = both_envs("RoboPush", "GlobalAEEncoder")
    enc = tenv.encoder
    assert enc.latent_threshold is None
    thr = np.linspace(0.01, 0.13, 13).astype(np.float32)
    enc.save_latent_threshold(thr, all_dists=np.ones((4, 13)))
    assert enc.metadata_dir.startswith(zoo[1])
    data = tenc.load_metadata(enc.metadata_dir)
    np.testing.assert_array_equal(data["latent_threshold"], thr)
    _, again = both_envs("RoboPush", "GlobalAEEncoder")
    np.testing.assert_array_equal(again.encoder.latent_threshold, thr)
    jenv.encoder.latent_threshold = thr
    a = np.zeros(13, np.float32)
    rng = np.random.default_rng(0)
    for d in [thr * 0.99, thr * 1.01, rng.uniform(0, 0.15, (6, 13)).astype(np.float32)]:
        got = tenv.check_success(a + d, a, None)
        assert np.array_equal(got, jenv.check_success(a + d, a, None))
    assert again.check_success(a, a + thr * 0.99, None)
    assert not again.check_success(a, a + thr * 1.01, None)


def test_peg_in_hole_state_predictor(zoo):
    """RoboPegInHole with the StatePredictor: per-state predictions in the
    order of its keys (hole_pos through to_state), and reset's dict."""
    jenv, tenv = both_envs("RoboPegInHole", "StatePredictor")
    got, _ = tenv.reset(seed=2)
    want, _ = jenv.reset(seed=2)
    for k in want:
        close_to(got[k], want[k], what=k)
    states = tenv.encoder.predict_states(tenv.observation)
    jstates = jenv.encoder.predict_states(tenv.observation)
    for k in jstates:
        close_to(states[k], jstates[k], what=k)
    assert tenv.encoder.encoding_dim == 14  # peg_to_hole 3, peg_quat 4, hole_pos 3, quat 4
