"""The port's latent-threshold calibration (train/calibrate.py) against the
JAX package's on the CPU.

- tests/test_calibrate.py's scripted fake-env cases, run through the port's
  latent_distributions: the same thresholds, statistics, warnings and saves.
- A seeded calibration of VisionReach's pair (RoboReach, the
  PointCloudSensor and GlobalAEEncoder on PointNet at 128 points, with goal
  imagination) under a proportional ground-truth policy, in both packages
  from the same weights: the threshold within 1e-4 of the JAX function's,
  saved to the sidecar and read back by a new env.
- A policy given as a path (.pkl of either actor type, written by the port)
  loads through rl.policy.load_policy and calibrates as the JAX package's
  function does with the same file.
"""

import numpy as np
import pytest
from test_calibrate import _FakeCalibEnv, _FakePolicy
from torch_bridge_utils import close_to, output_roots, scenes_at, subclass, write_checkpoints

from pointcloud_tpu.train.calibrate import latent_distributions as jcalibrate
from pointcloud_tpu_torch.train.calibrate import latent_distributions as tcalibrate

N_PTS = 128


@pytest.mark.parametrize("script,kw", [
    (([3, 5], [0.8, 0.4], [0.2, 0.1]), dict(horizon=10, runs=2, threshold_strictness=0.3,
                                             save=False)),
    (([2, None], [0.8, 0.4], [0.2, 0.1]), dict(horizon=8, runs=2, threshold_strictness=0.5,
                                                save=False)),
    (([None, None], [0.8, 0.4], [0.2, 0.1]), dict(horizon=5, runs=2, save=True)),
    (([0, 0], [0.8, 0.4], [0.2, 0.1], True), dict(horizon=5, runs=1, save=False)),
    (([1], [0.6, 0.2], [0.2, 0.2]), dict(horizon=5, runs=1, threshold_strictness=0.3,
                                         save=True)),
])
def test_fake_env_cases_equal(script, kw, capsys):
    out = []
    for fn in (tcalibrate, jcalibrate):
        env = _FakeCalibEnv(*script)
        capsys.readouterr()
        thr, before, during = fn("unused", _FakePolicy(), env=env, **kw)
        out.append((thr, before, during, env.encoder.saved, capsys.readouterr().out))
    (t, tb, td, ts, tout), (j, jb, jd, js, jout) = out
    assert tout == jout
    if j is None:
        assert t is None and ts is None and js is None
    else:
        np.testing.assert_array_equal(t, j)
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(td, jd)
        assert (ts is None) == (js is None)
        if js is not None:
            np.testing.assert_array_equal(ts[0], js[0])


def test_a_policy_path_needs_the_rl_port(tmp_path, capsys):
    """The RL port brings load_policy: a path of either actor type loads
    (on the CPU here) and calibrates; the JAX package's function given the
    same file agrees."""
    import torch

    from pointcloud_tpu_torch.rl import core as tcore
    from pointcloud_tpu_torch.rl.ddpg import _save
    from pointcloud_tpu_torch.rl.tqc import TQC

    for kind in ("ddpg", "tqc"):
        path = str(tmp_path / f"{kind}.pkl")
        gen = torch.Generator().manual_seed(0)
        if kind == "ddpg":  # the fake env's observation is 2 wide, its goal 1; 2 actions
            _save(path, tcore.init_params(tcore.Actor(3, 2, 1.0, (8,)), gen))
        else:
            actor = tcore.init_params(tcore.SquashedGaussianActor(3, 2, 1.0, (8,)), gen)
            TQC(actor, 1.0).save(path)
        out = []
        for fn, kw in ((tcalibrate, {"device": "cpu"}), (jcalibrate, {})):
            env = _FakeCalibEnv([1, 2], [0.6, 0.2], [0.2, 0.2])
            capsys.readouterr()
            thr, before, during = fn("unused", path, env=env, horizon=5, runs=2, save=True,
                                     **kw)
            out.append((thr, before, during, env.encoder.saved, capsys.readouterr().out))
        (t, tb, td, ts, tout), (j, jb, jd, js, jout) = out
        assert t is not None and tout == jout, kind
        for got, want in ((t, j), (tb, jb), (td, jd), (ts[0], js[0])):
            np.testing.assert_array_equal(got, want)


class ProportionalReach:
    """Drive the eef toward the goal: action = clip(12 (desired - achieved))."""

    def predict(self, obs, deterministic=True):
        delta = obs["desired_goal"] - obs["achieved_goal"]
        return np.concatenate([np.clip(12.0 * delta, -1, 1), [0.0]]).astype(np.float32), None


def test_seeded_reach_calibration_matches_jax(tmp_path):
    import gymnasium

    from pointcloud_tpu.envs import envs as jenvs
    from pointcloud_tpu.vision import pc_encoder as jenc
    from pointcloud_tpu.vision.pc_sensor import PointCloudSensor as JSensor
    from pointcloud_tpu_torch.envs import envs as tenvs
    from pointcloud_tpu_torch.vision import pc_encoder as tenc
    from pointcloud_tpu_torch.vision.pc_sensor import PointCloudSensor as TSensor

    roots = str(tmp_path / "jax"), str(tmp_path / "port")
    with scenes_at(N_PTS, "Table"), output_roots(*roots):
        write_checkpoints(*roots, "Table", "Autoencoder", "PointNet", 50)

        def make(envs, sensor, enc, **kw):
            env = gymnasium.wrappers.TimeLimit(
                envs.RoboReach(sensor=sensor, encoder=subclass(enc.GlobalAEEncoder, "PointNet"),
                               simulate_goal=True, **kw), max_episode_steps=15)
            env.reset(seed=9)  # seeds the goal draws of every later reset
            return env

        results = []
        for envs, sensor, enc, kw in ((jenvs, JSensor, jenc, {}),
                                      (tenvs, TSensor, tenc, {"device": "cpu"})):
            env = make(envs, sensor, enc, **kw)
            fn = jcalibrate if envs is jenvs else tcalibrate
            results.append(fn("unused", ProportionalReach(), horizon=15, runs=3, env=env,
                              save=True))
        (j, jb, jd), (t, tb, td) = results
        assert j is not None and j.shape == (3,) and len(jb) == len(jd) == 3
        close_to(t, j, what="threshold")
        close_to(tb, jb, what="before success")
        close_to(td, jd, what="during success")
        again = make(tenvs, TSensor, tenc, device="cpu").unwrapped
        np.testing.assert_array_equal(again.encoder.latent_threshold, t)
