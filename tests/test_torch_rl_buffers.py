"""The port's copied RL modules on the CPU: the replay buffer and HER
(rl/buffers.py), the tqc.yml loader (rl/config.py, rl/tqc.yml), the rollout
bookkeeping (rl/sb3.py) and export_policy.

- The copies' code is the JAX package's, docstrings and imports aside
  (test_torch_env_layer.normalized), and tqc.yml is the same file but for
  its header comment.
- tests/test_rl.py's buffer and HER behaviour tests, on the port's copy;
  each draw equal to the JAX package's on the same generator (exact: numpy).
- The loader's settings equal the JAX package's for every env of tqc.yml.
- rollout on the port's RoboReach (device='cpu') equal to the JAX
  package's rollout on its own, from the same seed (exact: the env layer is
  numpy in both).
"""

import numpy as np
import pytest
import torch_port_utils  # noqa: F401  (one torch thread per worker)
from test_torch_env_layer import normalized

from pointcloud_tpu.rl import buffers as jbuffers
from pointcloud_tpu.rl import config as jconfig
from pointcloud_tpu.rl import export_policy as jexport
from pointcloud_tpu.rl import sb3 as jsb3
from pointcloud_tpu_torch.rl import buffers as tbuffers
from pointcloud_tpu_torch.rl import config as tconfig
from pointcloud_tpu_torch.rl import export_policy as texport
from pointcloud_tpu_torch.rl import sb3 as tsb3
from pointcloud_tpu_torch.rl.buffers import ReplayBuffer, her_sample

ENV_IDS = ["RoboReach-v0", "RoboPush-v0", "RoboPickAndPlace-v0", "VisionReach-v0"]


@pytest.mark.parametrize("name,port,jax_mod", [
    ("buffers", tbuffers, jbuffers), ("config", tconfig, jconfig),
    ("sb3", tsb3, jsb3), ("export_policy", texport, jexport)])
def test_copied_module_is_the_jax_packages(name, port, jax_mod):
    assert normalized(port) == normalized(jax_mod), name


def test_tqc_yml_is_the_jax_packages():
    import os

    def body(mod):
        with open(os.path.join(os.path.dirname(mod.__file__), "tqc.yml")) as f:
            return [ln for ln in f.read().splitlines() if not ln.startswith("#")]

    assert body(tconfig) == body(jconfig)


def _fill_buffer(buf, episodes=3, ep_len=5, goal_dim=3):
    rng = np.random.default_rng(0)
    for e in range(episodes):
        for t in range(ep_len):
            ag = np.full(goal_dim, e * 10 + t, np.float32)
            buf.store(
                obs=rng.random(4, dtype=np.float32),
                achieved=ag,
                desired=np.full(goal_dim, -1.0, np.float32),
                act=rng.random(2, dtype=np.float32),
                rew=-1.0,
                next_obs=rng.random(4, dtype=np.float32),
                next_achieved=ag + 0.5,
                done=float(t == ep_len - 1),
            )
        buf.end_episode()


def test_replay_buffer_store_sample():
    buf = ReplayBuffer(obs_dim=4, goal_dim=3, act_dim=2, size=100)
    _fill_buffer(buf)
    assert buf.size == 15
    batch = buf.sample(8, np.random.default_rng(1))
    assert batch["obs"].shape == (8, 4)
    assert batch["desired"].shape == (8, 3)


def test_her_future_relabels_within_episode():
    buf = ReplayBuffer(obs_dim=4, goal_dim=3, act_dim=2, size=100)
    _fill_buffer(buf, episodes=3, ep_len=5)

    def reward_fn(achieved, desired):
        return -(np.linalg.norm(achieved - desired, axis=-1) > 0.01).astype(np.float32)

    rng = np.random.default_rng(2)
    batch = her_sample(buf, 64, rng, reward_fn, strategy="future", her_ratio=1.0)
    for b in range(64):
        g = batch["desired"][b][0]
        assert g != -1.0  # everything relabeled at ratio 1.0
        base = g - 0.5
        ep = int(base // 10)
        assert 0 <= ep < 3
        assert base % 10 < 5


def test_her_final_strategy():
    buf = ReplayBuffer(obs_dim=4, goal_dim=3, act_dim=2, size=100)
    _fill_buffer(buf, episodes=2, ep_len=4)

    rng = np.random.default_rng(3)
    batch = her_sample(
        buf, 32, rng, lambda a, d: np.zeros(len(a)), strategy="final", her_ratio=1.0
    )
    for b in range(32):
        g = batch["desired"][b][0]
        assert g in (3.5, 13.5)


def test_her_rewards_recomputed():
    buf = ReplayBuffer(obs_dim=4, goal_dim=3, act_dim=2, size=100)
    _fill_buffer(buf, episodes=1, ep_len=5)
    rng = np.random.default_rng(4)

    def reward_fn(achieved, desired):
        return np.where(np.abs(achieved - desired).max(-1) < 0.01, 0.0, -1.0)

    batch = her_sample(buf, 16, rng, reward_fn, strategy="final", her_ratio=1.0)
    assert (batch["rew"] == 0).any()


@pytest.mark.parametrize("strategy,ratio,size", [("future", 0.8, 100), ("final", 0.5, 100),
                                                  ("future", 1.0, 12)])
def test_draws_equal_the_jax_packages(strategy, ratio, size):
    """Same stores and generator seed: the same batches, also when the ring
    wraps (size 12 < 15 stored transitions)."""
    def reward_fn(achieved, desired):
        return -(np.abs(achieved - desired).max(-1) > 0.01).astype(np.float32)

    out = []
    for mod in (tbuffers, jbuffers):
        buf = mod.ReplayBuffer(obs_dim=4, goal_dim=3, act_dim=2, size=size)
        _fill_buffer(buf)
        rng = np.random.default_rng(5)
        out.append([mod.her_sample(buf, 16, rng, reward_fn, strategy=strategy,
                                   her_ratio=ratio) for _ in range(3)])
    for t, j in zip(*out):
        assert t.keys() == j.keys()
        for k in t:
            assert np.array_equal(t[k], j[k]), k


@pytest.mark.parametrize("env_id", ENV_IDS)
def test_yaml_config_equals_the_jax_packages(env_id):
    assert tconfig.load_yaml_config(env_id) == jconfig.load_yaml_config(env_id)


def test_yaml_config_loader():
    cfg = tconfig.load_yaml_config("RoboReach-v0")
    assert cfg["use_her"] is True
    assert cfg["hidden"] == (64, 64)
    assert cfg["gamma"] == 0.95
    assert abs(cfg["her_ratio"] - 0.8) < 1e-9
    assert tconfig.load_yaml_config("RoboPush-v0")["hidden"] == (512, 512, 512)
    with pytest.raises(KeyError):
        tconfig.load_yaml_config("NoSuchEnv-v0")


def test_rollout_bookkeeping_equals_the_jax_packages():
    import gymnasium as gym

    import pointcloud_tpu  # noqa: F401  (registers the JAX package's envs)
    from pointcloud_tpu_torch.rl.vec_env import make_env

    stats = []
    for env in (make_env("RoboReach-v0", max_episode_steps=10, device="cpu"),
                gym.make("RoboReach-v0", max_episode_steps=10)):
        env.action_space.seed(0)
        stats.append(tsb3.rollout(env, None, episodes=3, horizon=10,
                                  rng=np.random.default_rng(1)))
        env.close()
    assert set(stats[0]) >= {
        "mean_reward", "median_reward", "success_rate", "actual_success_rate",
    }
    assert stats[0] == stats[1]


def test_export_policy_copies_a_pickle(tmp_path):
    src = tmp_path / "run" / "policy_src.pkl"
    src.parent.mkdir()
    src.write_bytes(b"payload")
    out = texport.export_policy(str(src))
    assert out == str(tmp_path / "run" / "policy.pkl")
    assert (tmp_path / "run" / "policy.pkl").read_bytes() == b"payload"
    with pytest.raises(ValueError, match="unknown artifact format"):
        texport.export_policy(str(tmp_path / "x.onnx"))
