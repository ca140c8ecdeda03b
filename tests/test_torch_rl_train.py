"""The port's RL trainers and env plumbing on the CPU (device='cpu').

- ddpg() on RoboReach in both packages, the JAX package's initial
  parameters put into the port by monkeypatching its init_params (the
  test's doing, not an argument of ddpg): the buffers equal up to
  update_after (exact: the env, the action sampler and the numpy generator
  are the same), the replay buffers of the whole run and the final actor
  within 1e-4 of the largest entry of each tensor (fp32 round-off of 100
  updates under Adam, which then feeds back into the actions).
- tqc() single-env and with n_envs=2 (tests/test_rl.py:146-173, 244-270),
  finite actions; the saved policy reloads and acts the same.
- The vector envs, dummy and subprocess (spawn), on the port's RoboReach:
  batched observations and the autoreset protocol (tests/test_rl.py:
  203-241); the subprocess workers build their envs from make_env.
- make_env without gymnasium (a subprocess hides it): the registration
  table's RoboReach wrapped in envs.spaces' TimeLimit stand-in, whose
  rollouts (observations, rewards, terminated and truncated flags) equal
  gymnasium's TimeLimit over the same env; tqc() with 1 and 2 envs on the
  stand-ins.
- gym.make of a registered id builds the class that make_env builds.
- train_rl_torch.py --device cpu for one tiny epoch.
- A torch copy of tests/test_rl.py's test_ddpg_her_learns_reach, marked slow
  as the original is.
"""

import functools
import json
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch_port_utils  # noqa: F401  (one torch thread per worker)
from torch_bridge_utils import ROOT, root_module

from pointcloud_tpu_torch.rl.vec_env import DummyVecGoalEnv, SubprocVecGoalEnv, make_env


def _reach_env_fn():
    return make_env("RoboReach-v0", max_episode_steps=5, device="cpu")


def test_ddpg_run_matches_jax(monkeypatch):
    import gymnasium as gym
    import jax
    import jax.numpy as jnp

    import pointcloud_tpu  # noqa: F401  (registers the JAX package's envs)
    from pointcloud_tpu.rl import buffers as jbuffers
    from pointcloud_tpu.rl import core as jcore
    from pointcloud_tpu.rl.ddpg import ddpg as jddpg
    from pointcloud_tpu_torch.interop import load_flax_variables
    from pointcloud_tpu_torch.rl import buffers as tbuffers
    from pointcloud_tpu_torch.rl import core as tcore

    tddpg_mod = sys.modules["pointcloud_tpu_torch.rl.ddpg"]
    kw = dict(hidden=(32, 32), seed=0, steps_per_epoch=200, epochs=1, batch_size=32,
              start_steps=100, update_after=100, update_every=50, max_ep_len=20,
              use_her=True, num_test_episodes=2, log_fn=lambda *a: None)
    stores = {"port": [], "jax": []}

    def recording(mod, key):
        store = mod.ReplayBuffer.store

        def rec(self, *a):
            stores[key].append([np.array(x, np.float32, copy=True) for x in a])
            return store(self, *a)

        monkeypatch.setattr(mod.ReplayBuffer, "store", rec)

    # the JAX package's initial parameters (ddpg.py:110-115): one key for both
    key = jax.random.PRNGKey(0)
    in_dim, act_dim = 3 + 3, 4
    jvars = {tcore.Actor: jcore.Actor(act_dim, 1.0, (32, 32)).init(key, jnp.zeros((1, in_dim))),
             tcore.QCritic: jcore.QCritic((32, 32)).init(key, jnp.zeros((1, in_dim)),
                                                          jnp.zeros((1, act_dim)))}
    monkeypatch.setattr(tddpg_mod, "init_params", lambda module, gen: load_flax_variables(
        module, jax.tree_util.tree_map(np.asarray, jvars[type(module)])))

    recording(tbuffers, "port")
    tout, thist = tddpg_mod.ddpg(
        functools.partial(make_env, "RoboReach-v0", max_episode_steps=20, device="cpu"),
        device="cpu", **kw)
    recording(jbuffers, "jax")
    jout, jhist = jddpg(lambda: gym.make("RoboReach-v0", max_episode_steps=20), **kw)

    assert len(stores["port"]) == len(stores["jax"]) == 200
    for t, (ts, js) in enumerate(zip(stores["port"], stores["jax"])):
        for a, b in zip(ts, js):
            if t < 100:
                assert np.array_equal(a, b), t
            else:
                assert np.abs(a - b).max() <= 1e-4 * max(np.abs(b).max(), 1.0), t
    assert thist == jhist
    mirror = load_flax_variables(tcore.Actor(in_dim, act_dim, 1.0, (32, 32)),
                                 jax.tree_util.tree_map(np.asarray, jout["pi"]))
    for name, want in mirror.state_dict().items():
        got = tout["pi"][name]
        err = float((got - want).abs().max() / want.abs().max())
        assert err <= 1e-4, (name, err)


def test_tqc_smoke_updates(tmp_path):
    from pointcloud_tpu_torch.rl.policy import load_policy
    from pointcloud_tpu_torch.rl.tqc import tqc

    path = str(tmp_path / "tqc.pkl")
    policy, history = tqc(
        functools.partial(make_env, "RoboReach-v0", max_episode_steps=10, device="cpu"),
        hidden=(32, 32), critic_hidden=(32, 32), epochs=1, steps_per_epoch=150,
        start_steps=50, update_after=50, batch_size=32, max_ep_len=10,
        num_test_episodes=2, seed=0, log_fn=lambda *a: None, save_path=path,
        device="cpu",
    )
    obs = {"observation": np.zeros(3, np.float32), "desired_goal": np.zeros(3, np.float32)}
    a, _ = policy.predict(obs)
    assert a.shape == (4,) and np.isfinite(a).all() and len(history) == 1
    b, _ = load_policy(path, device="cpu").predict(obs)
    assert np.array_equal(a, b)


def test_tqc_n_envs_smoke():
    from pointcloud_tpu_torch.rl.tqc import tqc

    policy, history = tqc(
        _reach_env_fn, hidden=(32, 32), critic_hidden=(32, 32), epochs=1,
        steps_per_epoch=120, start_steps=40, update_after=40, batch_size=32, max_ep_len=5,
        num_test_episodes=2, seed=0, log_fn=lambda *a: None, n_envs=2, vec_env="dummy",
        device="cpu",
    )
    obs = {"observation": np.zeros(3, np.float32), "desired_goal": np.zeros(3, np.float32)}
    a, _ = policy.predict(obs)
    assert a.shape == (4,) and np.isfinite(a).all()
    assert len(history) == 1


@pytest.mark.parametrize("kind", ["dummy", "subproc"])
def test_vec_goal_env_batches_and_autoresets(kind):
    n = 2
    if kind == "dummy":
        venv = DummyVecGoalEnv([_reach_env_fn] * n)
    else:
        fn = functools.partial(make_env, "RoboReach-v0", max_episode_steps=5, device="cpu")
        venv = SubprocVecGoalEnv([fn] * n)
    try:
        obs, infos = venv.reset(seed=0)
        assert obs["observation"].shape[0] == n
        assert obs["desired_goal"].shape[0] == n
        act_dim = venv.action_space.shape[0]
        saw_final = False
        for _ in range(6):  # max_episode_steps=5 -> guaranteed truncation
            acts = np.stack([venv.action_space.sample() for _ in range(n)])
            obs, rews, terms, truncs, infos = venv.step(acts)
            assert obs["observation"].shape[0] == n
            assert rews.shape == (n,) and terms.shape == (n,)
            for info in infos:
                if "final_observation" in info:
                    saw_final = True
                    assert "observation" in info["final_observation"]
        assert saw_final, "TimeLimit truncation should surface final_observation"
        r = venv.compute_reward(np.zeros((2, 3), np.float32), np.zeros((2, 3), np.float32))
        assert np.asarray(r).shape == (2,)
        assert act_dim == 4
    finally:
        venv.close()


_NO_GYM = r"""
import json, sys
sys.modules["gymnasium"] = None
import numpy as np
from pointcloud_tpu_torch.envs import spaces
from pointcloud_tpu_torch.rl.vec_env import make_env
assert not spaces.HAVE_GYMNASIUM
env = make_env("pointcloud_tpu_torch/RoboReach-v0", max_episode_steps=4, device="cpu")
assert type(env).__name__ == "TimeLimit" and type(env.unwrapped).__name__ == "RoboReach"
out = []
for seed in (3, 4):
    obs, _ = env.reset(seed=seed)
    rng = np.random.default_rng(seed)
    rows = [obs["desired_goal"].tolist()]
    for t in range(6):
        obs, r, te, tr, info = env.step(rng.uniform(-1, 1, 4).astype(np.float32))
        rows.append([obs["observation"].tolist(), float(r), bool(te), bool(tr)])
    out.append(rows)
from pointcloud_tpu_torch.rl.tqc import tqc
for n_envs in (1, 2):  # tqc() reads the stand-ins' spaces and seeds their sampler
    policy, history = tqc(lambda: make_env("RoboReach-v0", max_episode_steps=5, device="cpu"),
                          hidden=(8,), critic_hidden=(8,), epochs=1, steps_per_epoch=40,
                          start_steps=20, update_after=20, batch_size=8, max_ep_len=5,
                          num_test_episodes=1, log_fn=lambda *a: None, n_envs=n_envs,
                          vec_env="dummy", device="cpu")
    a, _ = policy.predict({"observation": np.zeros(3, np.float32),
                           "desired_goal": np.zeros(3, np.float32)})
    assert a.shape == (4,) and np.isfinite(a).all() and len(history) == 1
print(json.dumps(out))
"""


def test_make_env_without_gymnasium_truncates_as_gymnasium():
    """The stand-in TimeLimit against gymnasium's over the same env: the
    same observations, rewards and flags, truncated from the 4th step on
    and cleared by reset (six steps an episode, two episodes)."""
    import gymnasium

    from pointcloud_tpu_torch.envs.envs import RoboReach

    res = subprocess.run([sys.executable, "-c", _NO_GYM], capture_output=True, text=True,
                         cwd=ROOT, check=True, timeout=120)
    got = json.loads(res.stdout.strip().splitlines()[-1])
    env = gymnasium.wrappers.TimeLimit(RoboReach(device="cpu"), max_episode_steps=4)
    want = []
    for seed in (3, 4):
        obs, _ = env.reset(seed=seed)
        rng = np.random.default_rng(seed)
        rows = [obs["desired_goal"].tolist()]
        for t in range(6):
            obs, r, te, tr, info = env.step(rng.uniform(-1, 1, 4).astype(np.float32))
            rows.append([obs["observation"].tolist(), float(r), bool(te), bool(tr)])
        want.append(rows)
    assert got == want
    assert [row[3] for row in got[0][1:]] == [False, False, False, True, True, True]


def test_make_env_takes_both_ids_on_the_device():
    a = make_env("RoboReach-v0", max_episode_steps=3, device="cpu")
    b = make_env("pointcloud_tpu_torch/RoboReach-v0", max_episode_steps=3, device="cpu")
    assert a.unwrapped.device == b.unwrapped.device == torch.device("cpu")
    assert type(a.unwrapped) is type(b.unwrapped) and a._max_episode_steps == 3
    from pointcloud_tpu_torch.envs.registration import env_table

    assert len(env_table()) == 16 and env_table()["VisionReach-v0"][1]["sensor"].requires_vision
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            make_env("RoboReach-v0")


def test_registered_ids_make_the_table_envs():
    """gym.make of a registered id (register_all, for callers who make
    their envs through gymnasium) builds make_env's env class on the
    device asked for."""
    import gymnasium as gym

    env = gym.make("pointcloud_tpu_torch/RoboReach-v0", max_episode_steps=3, device="cpu")
    assert env.spec.id == "pointcloud_tpu_torch/RoboReach-v0"
    assert env.spec.max_episode_steps == 3
    assert type(env.unwrapped) is type(make_env("RoboReach-v0", device="cpu").unwrapped)
    assert env.unwrapped.device == torch.device("cpu")


def test_train_rl_torch_cli_one_tiny_epoch(tmp_path, capsys):
    from pointcloud_tpu_torch.rl.policy import load_policy

    cli = root_module("train_rl_torch")
    path = str(tmp_path / "policy.pkl")
    cli.main(["RoboReach-v0", "--algo", "tqc", "--epochs", "1", "--steps-per-epoch", "60",
              "--n-envs", "1", "--device", "cpu", "--save", path])
    out = capsys.readouterr().out
    assert "epoch 1/1" in out and "final success rate:" in out
    a, _ = load_policy(path, device="cpu").predict(
        {"observation": np.zeros(3, np.float32), "desired_goal": np.zeros(3, np.float32)})
    assert a.shape == (4,) and np.isfinite(a).all()


@pytest.mark.slow
def test_ddpg_her_learns_reach():
    """DDPG+HER on the kinematic Reach env must climb to >=60% success."""
    from pointcloud_tpu_torch.rl.ddpg import her

    env_fn = functools.partial(make_env, "RoboReach-v0", max_episode_steps=30, device="cpu")
    _, history = her(
        env_fn,
        hidden=(64, 64),
        epochs=4,
        steps_per_epoch=1500,
        start_steps=300,
        update_after=300,
        batch_size=128,
        max_ep_len=30,
        num_test_episodes=10,
        seed=0,
        log_fn=lambda *a: None,
        device="cpu",
    )
    assert max(history) >= 0.6, history
