"""The port's per-class and per-state encoders on the default PointNet2
backbone at the scenes' full 2,048 points, on the CPU: VisionPush's
MultiSegmenterEncoder and VisionPushGT's StatePredictor, made through the
port's gym ids, against the JAX package's model with the same weights
(tests/test_torch_pc_encoder_pn2.py says how).

Tolerance: fp32, 1e-4 of the largest entry; StatePredictor predictions
after to_state.
"""

import numpy as np
import pytest
from test_torch_pc_encoder_pn2 import jax_encoder
from torch_bridge_utils import close_to, output_roots, write_checkpoints

from pointcloud_tpu.vision import pc_encoder as jenc
from pointcloud_tpu_torch.envs.envs import RoboPush
from pointcloud_tpu_torch.vision import pc_encoder as tenc


@pytest.mark.parametrize("env_id,model_type", [("VisionPush-v0", "MultiSegmenter"),
                                               ("VisionPushGT-v0", "StatePredictor")])
def test_heads_pointnet2_through_gym(tmp_path, env_id, model_type):
    import gymnasium as gym

    import pointcloud_tpu_torch  # noqa: F401

    v = write_checkpoints(str(tmp_path / "jax"), str(tmp_path / "port"), "Cube",
                          model_type, "PointNet2", 31)
    with output_roots(str(tmp_path / "jax"), str(tmp_path / "port")):
        env = gym.make(f"pointcloud_tpu_torch/{env_id}", device="cpu")
        base = env.unwrapped
        assert isinstance(base, RoboPush)
        want_cls = (tenc.MultiSegmenterEncoder if model_type == "MultiSegmenter"
                    else tenc.StatePredictor)
        assert type(base.encoder) is want_cls
        obs, _ = env.reset(seed=2)
        for _ in range(2):
            obs, reward, _, _, _ = env.step(np.full(4, -0.4, np.float32))
        sensed = base.observation
        want = jax_encoder(model_type, v)(sensed)
        if model_type == "MultiSegmenter":
            assert [n for n, _, _ in base.encoder.model.name_points_dims] == ["cube"]
            close_to(obs["achieved_goal"], want["cube"], what="cube")
            close_to(obs["observation"][4:], want["cube"], what="cube")
        else:
            to_state = jenc.StatePredictor.to_state(base)["cube_pos"]
            got = base.encoder.predict_states(sensed)
            assert list(got) == ["cube_pos"]
            close_to(got["cube_pos"], to_state(want["cube_pos"]), what="cube_pos")
            close_to(obs["observation"][4:], to_state(want["cube_pos"]), what="obs")
            np.testing.assert_array_equal(obs["achieved_goal"], sensed["cube_pos"])
            assert base.visual_goal is False
        assert reward in (-1, 0)
        env.close()
