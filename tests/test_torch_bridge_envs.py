"""The port's Vision envs as a user makes them: through gym ids beside the
JAX package's, and without gymnasium (the GPU machine has none).

- Registration: in one process, `gym.make("pointcloud_tpu_torch/VisionPush-v0")`
  gives the port's env and `gym.make("VisionPush-v0")` the JAX package's,
  whichever package was imported first (a subprocess for each order).
- Without gymnasium (a subprocess with `sys.modules["gymnasium"] = None`),
  `import pointcloud_tpu_torch` registers nothing, and a Vision env built
  from the classes runs on the stand-ins of envs/spaces.py and gives the
  same observations, rewards and infos as the gymnasium-backed one, bit for
  bit.

Both use the MultiSegmenter zoo encoder on PointNet at 128 points
(tests/test_torch_pc_encoder.py says why).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
from torch_bridge_utils import ROOT, output_roots, scenes_at, subclass, write_checkpoints

N_PTS = 128

_PRELUDE = r"""
import json, os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
jroot, troot, order = sys.argv[1:4]
"""

_REGISTRATION = _PRELUDE + r"""
import jax
jax.config.update("jax_platforms", "cpu")
if order == "jax-first":
    import pointcloud_tpu, pointcloud_tpu_torch
else:
    import pointcloud_tpu_torch, pointcloud_tpu
import gymnasium as gym
from pointcloud_tpu.envs import scenes as jscenes
from pointcloud_tpu.vision import pc_encoder as jenc
from pointcloud_tpu_torch.envs import scenes as tscenes
from pointcloud_tpu_torch.vision import pc_encoder as tenc
for table in (jscenes, tscenes):
    table.cfg_scene["Cube"] = dict(table.cfg_scene["Cube"], sample_points=128)
jenc.OUTPUT_ROOT, tenc.OUTPUT_ROOT = jroot, troot
JEnc = type("JEnc", (jenc.MultiSegmenterEncoder,), {"backbone": "PointNet"})
TEnc = type("TEnc", (tenc.MultiSegmenterEncoder,), {"backbone": "PointNet"})
t = gym.make("pointcloud_tpu_torch/VisionPush-v0", encoder=TEnc, device="cpu")
j = gym.make("VisionPush-v0", encoder=JEnc)
out = {}
for name, env, env_id in (("port", t, "pointcloud_tpu_torch/VisionPush-v0"),
                          ("jax", j, "VisionPush-v0")):
    base = env.unwrapped
    out[name] = [type(base).__module__, type(base.sensor).__module__,
                 type(base.encoder).__mro__[1].__module__]
    spec = gym.spec(env_id)
    out[name + "_spec"] = [spec.entry_point.__module__, spec.kwargs["encoder"].__module__,
                           spec.max_episode_steps]
print(json.dumps(out))
"""

_NO_GYMNASIUM = _PRELUDE + r"""
sys.modules["gymnasium"] = None
import numpy as np
import pointcloud_tpu_torch
from pointcloud_tpu_torch.envs import scenes as tscenes
from pointcloud_tpu_torch.envs import spaces
from pointcloud_tpu_torch.envs.envs import RoboPush
from pointcloud_tpu_torch.vision import pc_encoder as tenc
from pointcloud_tpu_torch.vision.pc_sensor import PointCloudSensor
assert not spaces.HAVE_GYMNASIUM
assert not any(m.split(".")[0] in ("gymnasium", "gymnasium_robotics") for m in sys.modules
               if sys.modules[m] is not None)
tscenes.cfg_scene["Cube"] = dict(tscenes.cfg_scene["Cube"], sample_points=128)
tenc.OUTPUT_ROOT = troot
TEnc = type("TEnc", (tenc.MultiSegmenterEncoder,), {"backbone": "PointNet"})
env = RoboPush(sensor=PointCloudSensor, encoder=TEnc, device="cpu")
assert type(env.observation_space) is spaces.Dict
obs, info = env.reset(seed=0)
rec = {"info0": info, "steps": []}
arrays = {f"reset_{k}": v for k, v in obs.items()}
for t in range(3):
    obs, r, te, tr, info = env.step(np.full(4, 0.2 * (t + 1), np.float32))
    arrays.update({f"step{t}_{k}": v for k, v in obs.items()})
    arrays[f"step{t}_points"] = env.observation["points"]
    rec["steps"].append([float(r), bool(te), bool(tr), info])
np.savez(order, **arrays)
print(json.dumps(rec, default=lambda a: a.item()))  # numpy bools of check_success
"""


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("bridge")
    jroot, troot = str(base / "jax"), str(base / "port")
    with scenes_at(N_PTS, "Cube"):
        write_checkpoints(jroot, troot, "Cube", "MultiSegmenter", "PointNet", 40)
    return jroot, troot


def run(code, roots, arg, cwd=ROOT):
    out = subprocess.run([sys.executable, "-c", code, *roots, arg], capture_output=True,
                         text=True, cwd=cwd, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("order", ["jax-first", "port-first"])
def test_both_packages_envs_under_their_own_ids(roots, order):
    got = run(_REGISTRATION, roots, order)
    assert got["port"][:3] == ["pointcloud_tpu_torch.envs.envs",
                               "pointcloud_tpu_torch.vision.pc_sensor",
                               "pointcloud_tpu_torch.vision.pc_encoder"]
    assert got["jax"][:3] == ["pointcloud_tpu.envs.envs", "pointcloud_tpu.vision.pc_sensor",
                              "pointcloud_tpu.vision.pc_encoder"]
    assert got["port_spec"] == ["pointcloud_tpu_torch.envs.envs",
                                "pointcloud_tpu_torch.vision.pc_encoder", 50]
    assert got["jax_spec"] == ["pointcloud_tpu.envs.envs", "pointcloud_tpu.vision.pc_encoder",
                               50]


def test_vision_env_without_gymnasium(roots, tmp_path):
    from pointcloud_tpu_torch.envs.envs import RoboPush
    from pointcloud_tpu_torch.vision import pc_encoder as tenc
    from pointcloud_tpu_torch.vision.pc_sensor import PointCloudSensor

    path = str(tmp_path / "standins.npz")
    got = run(_NO_GYMNASIUM, roots, path)
    standins = np.load(path)
    with scenes_at(N_PTS, "Cube"), output_roots(*roots):
        env = RoboPush(sensor=PointCloudSensor,
                       encoder=subclass(tenc.MultiSegmenterEncoder, "PointNet"), device="cpu")
        assert type(env.observation_space).__module__.startswith("gymnasium")
        obs, info = env.reset(seed=0)
        want = {"info0": info, "steps": []}
        arrays = {f"reset_{k}": v for k, v in obs.items()}
        for t in range(3):
            obs, r, te, tr, info = env.step(np.full(4, 0.2 * (t + 1), np.float32))
            arrays.update({f"step{t}_{k}": v for k, v in obs.items()})
            arrays[f"step{t}_points"] = env.observation["points"]
            want["steps"].append([float(r), bool(te), bool(tr), info])
    assert got == json.loads(json.dumps(want, default=lambda a: a.item()))
    assert sorted(standins.files) == sorted(arrays)
    for k, v in arrays.items():
        np.testing.assert_array_equal(standins[k], v, err_msg=k)
    assert os.path.getsize(path) > 0
