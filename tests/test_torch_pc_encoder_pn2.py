"""The port's global encoders on the default PointNet2 backbone at the
scenes' full 2,048 points, on the CPU: GlobalAEEncoder and
GlobalSegmenterEncoder in RoboPush (VisionPushSeg's pair) against the JAX
package's model with the same weights.

The JAX side is its create_model's module applied (jitted) to the JAX
package's own normalization of the same sensed cloud with the variables
both checkpoints hold: its encoder classes compute exactly this, after an
eager init of the whole PointNet2 model that takes ~17 s on the CPU.
Tolerance: fp32, 1e-4 of the largest entry.
"""

import jax
import numpy as np
import pytest
from torch_bridge_utils import close_to, output_roots, write_checkpoints

from pointcloud_tpu.train import harness as jharness
from pointcloud_tpu.vision import pc_encoder as jenc
from pointcloud_tpu_torch.envs import envs as tenvs
from pointcloud_tpu_torch.vision import pc_encoder as tenc
from pointcloud_tpu_torch.vision.pc_sensor import PointCloudSensor


def jax_encoder(model_type, v):
    """The JAX package's model of `model_type` (PointNet2, Cube) as a
    function of one sensed cloud: encode, or the StatePredictor's forward."""
    spec, _ = jharness.create_model(model_type, "PointNet2", "Cube")
    m = spec.model
    if model_type == "StatePredictor":
        fn = jax.jit(lambda x: m.apply(v, x, train=False))
    else:
        fn = jax.jit(lambda x: m.apply(v, x, train=False, method=m.encode))

    def encode(obs):
        out = fn(jenc._normalize_pc(obs, ["rgb"])[None])
        if isinstance(out, dict):
            return {k: np.asarray(a)[0] for k, a in out.items()}
        return np.asarray(out)[0]
    return encode


@pytest.mark.parametrize("model_type,encoder", [("Autoencoder", "GlobalAEEncoder"),
                                                ("Segmenter", "GlobalSegmenterEncoder")])
def test_global_encoders_pointnet2(tmp_path, model_type, encoder):
    v = write_checkpoints(str(tmp_path / "jax"), str(tmp_path / "port"), "Cube",
                          model_type, "PointNet2", 30)
    with output_roots(str(tmp_path / "jax"), str(tmp_path / "port")):
        env = tenvs.RoboPush(sensor=PointCloudSensor, encoder=getattr(tenc, encoder),
                             device="cpu")
        obs, _ = env.reset(seed=1)
        assert env.observation["points"].shape == (2048, 3)
        jax_encode = jax_encoder(model_type, v)
        for sensed in (env.observation, env.goal_obs):
            want = jax_encode(sensed)
            enc, goal = env.encoder(sensed)
            close_to(enc, want, what=encoder)
            np.testing.assert_array_equal(enc, goal)
            close_to(env.encoder.encode_observation(sensed), want, what=encoder)
        np.testing.assert_array_equal(obs["achieved_goal"], env.encoder(env.observation)[0])
        assert obs["achieved_goal"].shape == (13,) and env.simulate_goal is False
