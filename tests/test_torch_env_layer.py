"""The port's env layer against the JAX package's on the CPU, without
models: the copied modules (sensors, encoders, utils, the numpy part of the
synthetic scenes) held equal to the originals' code; the spaces' stand-ins
against gymnasium; 20 seeded steps of each ground-truth task env; the
synthetic scenes' rendered clouds, observations and generate_dataset frames.

Tolerance: none. The env layer and the scenes are numpy in both packages;
the sensed observations here are 128 points (FPS over the 16,384-point raw
cloud, where the two packages' FPS pick the same points; the full 2,048 are
tests/test_torch_pc_sensor.py's). A port env, scene or sensor asked for a
CUDA device on a machine without one raises.
"""

import ast
import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch_port_utils  # noqa: F401  (one torch thread per worker)
from torch_bridge_utils import ROOT, scenes_at

from pointcloud_tpu.envs import encoders as jencoders
from pointcloud_tpu.envs import envs as jenvs
from pointcloud_tpu.envs import sensors as jsensors
from pointcloud_tpu.envs import synthetic as jsynthetic
from pointcloud_tpu.envs import utils as jutils
from pointcloud_tpu_torch.envs import encoders as tencoders
from pointcloud_tpu_torch.envs import envs as tenvs
from pointcloud_tpu_torch.envs import sensors as tsensors
from pointcloud_tpu_torch.envs import synthetic as tsynthetic
from pointcloud_tpu_torch.envs import utils as tutils

TASKS = ["RoboReach", "RoboPush", "RoboPickAndPlace", "RoboPegInHole"]


############################ the copies ############################


class _Normalize(ast.NodeTransformer):
    """Docstrings, imports, the `device` argument and keyword, and
    `self.device = ...` statements out: what the port adds to a copy."""

    def generic_visit(self, node):
        super().generic_visit(node)
        body = getattr(node, "body", None)
        if isinstance(body, list):
            keep = [s for s in body if not (
                isinstance(s, (ast.Import, ast.ImportFrom))
                or (isinstance(s, ast.Expr) and isinstance(s.value, ast.Constant)
                    and isinstance(s.value.value, str))
                or (isinstance(s, ast.Assign) and ast.unparse(s.targets[0]) == "self.device"))]
            node.body = keep or [ast.Pass()]
        return node

    def visit_Call(self, node):
        self.generic_visit(node)
        node.keywords = [k for k in node.keywords if k.arg != "device"]
        return node

    def visit_arguments(self, node):
        self.generic_visit(node)
        names = [a.arg for a in node.args]
        if "device" in names:
            i = names.index("device")
            n_plain = len(node.args) - len(node.defaults)
            del node.args[i]
            if i >= n_plain:
                del node.defaults[i - n_plain]
        return node


def normalized(module_or_node) -> dict:
    """{qualified name: normalized AST dump} of every top-level function,
    class method and module-level assignment."""
    tree = module_or_node if isinstance(module_or_node, ast.AST) else ast.parse(
        inspect.getsource(module_or_node))
    tree = _Normalize().visit(tree)
    out = {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            out[node.name] = ast.dump(node)
        elif isinstance(node, ast.ClassDef):
            for item in node.body:
                key = f"{node.name}.{getattr(item, 'name', ast.unparse(item)[:40])}"
                out[key] = ast.dump(item)
            out[node.name] = ast.dump(ast.ClassDef(
                name=node.name, bases=node.bases, keywords=node.keywords, body=[],
                decorator_list=node.decorator_list, type_params=[]))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            out[ast.unparse(node).split("=")[0].strip()] = ast.dump(node)
    return out


@pytest.mark.parametrize("name,port,jax_mod", [
    ("sensors", tsensors, jsensors), ("encoders", tencoders, jencoders),
    ("utils", tutils, jutils)])
def test_copied_module_is_the_jax_packages(name, port, jax_mod):
    """The copy's code is the original's, docstrings and imports aside."""
    assert normalized(port) == normalized(jax_mod), name


def test_synthetic_numpy_part_is_the_jax_packages():
    """The scenes, geometry, quaternions and generate_dataset are the JAX
    package's code, but for the device they take; `observe` and the sensor
    chain are the port's own (held by value below)."""
    got, want = normalized(tsynthetic), normalized(jsynthetic)
    own = {"_sense", "_jitted_sensor_chain", "SyntheticScene.observe",
           "SyntheticPegScene.observe"}
    got = {k: v for k, v in got.items() if k not in own}
    want = {k: v for k, v in want.items() if k not in own}
    assert got.keys() == want.keys()
    for k in got:
        assert got[k] == want[k], k


def test_port_envs_import_no_jax():
    code = ("import sys\n"
            "from pointcloud_tpu_torch.envs import backends, base_env, camera, envs, "
            "registration, spaces, synthetic\n"
            "from pointcloud_tpu_torch.vision import pc_encoder, pc_sensor\n"
            "from pointcloud_tpu_torch.train import calibrate\n"
            "from pointcloud_tpu_torch.data import generate\n"
            "print([m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'pointcloud_tpu')])\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, check=True, timeout=120)
    assert out.stdout.strip().splitlines()[-1] == "[]"


############################ spaces ############################

_STANDINS = r"""
import json, sys
sys.modules["gymnasium"] = None
import numpy as np
from pointcloud_tpu_torch.envs import spaces
from pointcloud_tpu_torch.envs.spaces import Box, Dict, GoalEnv
assert not spaces.HAVE_GYMNASIUM
out = {}
b = Box(-1.0, 1.0, shape=(4,), dtype=np.float32)
out["box_seed"] = b.seed(3)
out["box"] = [b.sample().tolist(), b.sample().tolist()]
out["box_meta"] = [list(b.shape), str(b.dtype), b.low.tolist(), b.high.tolist()]
lo = np.array([-np.inf, 0.0, -np.inf, -1.0], np.float32)
hi = np.array([np.inf, np.inf, 2.0, 1.0], np.float32)
m = Box(lo, hi)
m.seed(4)
out["mixed"] = m.sample().tolist()
out["mixed_shape"] = list(m.shape)
out["dict"] = list(Dict({"observation": b, "achieved_goal": b, "desired_goal": b}).spaces)
e = GoalEnv()
e.reset(seed=5)
out["goal_env"] = e.np_random.uniform(size=3).tolist()
print(json.dumps(out))
"""


def test_standins_match_gymnasium():
    """Without gymnasium, Box / Dict / GoalEnv draw the same numbers and keep
    the same surface as gymnasium's (a subprocess hides gymnasium)."""
    import gymnasium
    from gymnasium_robotics.core import GoalEnv

    out = subprocess.run([sys.executable, "-c", _STANDINS], capture_output=True,
                         text=True, cwd=ROOT, check=True, timeout=120)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    b = gymnasium.spaces.Box(-1.0, 1.0, shape=(4,), dtype=np.float32)
    assert got["box_seed"] == b.seed(3)
    assert got["box"] == [b.sample().tolist(), b.sample().tolist()]
    assert got["box_meta"] == [list(b.shape), str(b.dtype), b.low.tolist(), b.high.tolist()]
    lo = np.array([-np.inf, 0.0, -np.inf, -1.0], np.float32)
    hi = np.array([np.inf, np.inf, 2.0, 1.0], np.float32)
    m = gymnasium.spaces.Box(lo, hi)
    m.seed(4)
    assert got["mixed"] == m.sample().tolist() and got["mixed_shape"] == list(m.shape)
    d = gymnasium.spaces.Dict({"observation": b, "achieved_goal": b, "desired_goal": b})
    assert got["dict"] == list(d.spaces)

    class Env(GoalEnv):
        observation_space = d

        def compute_reward(self, *a):
            pass

        compute_terminated = compute_truncated = compute_reward

    e = Env()
    e.reset(seed=5)
    assert got["goal_env"] == e.np_random.uniform(size=3).tolist()


############################ ground-truth envs ############################


def rollout(env, seed, steps=20):
    obs, info = env.reset(seed=seed)
    rng = np.random.default_rng(seed)
    out = [(obs, None, None, None, info)]
    for _ in range(steps):
        action = rng.uniform(-1, 1, env.action_space.shape).astype(np.float32)
        out.append(env.step(action))
    return out


def assert_same_rollout(got, want):
    assert len(got) == len(want)
    for t, (g, w) in enumerate(zip(got, want)):
        assert g[0].keys() == w[0].keys(), t
        for k in g[0]:
            assert g[0][k].dtype == w[0][k].dtype, (t, k)
            np.testing.assert_array_equal(g[0][k], w[0][k], err_msg=f"step {t} {k}")
        assert g[1:4] == w[1:4], (t, g[1:4], w[1:4])
        assert g[4] == w[4], (t, g[4], w[4])


@pytest.mark.parametrize("task", TASKS)
def test_ground_truth_rollouts_equal(task):
    """reset(seed) + 20 seeded steps: obs, reward, terminated, truncated and
    info bit-equal, goals included."""
    jenv = getattr(jenvs, task)()
    tenv = getattr(tenvs, task)(device="cpu")
    for seed in (0, 7):
        assert_same_rollout(rollout(tenv, seed), rollout(jenv, seed))
        for k in jenv.goal_state:
            np.testing.assert_array_equal(tenv.goal_state[k], jenv.goal_state[k])
    assert type(tenv.observation_space).__module__.startswith("gymnasium")
    jenv.close()
    tenv.close()


def test_port_envs_need_a_card_for_cuda():
    """device='cuda' without a card raises, for an env, a scene, a
    backend; the default is the card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from pointcloud_tpu_torch.envs.backends import make_synthetic_backend
    from pointcloud_tpu_torch.vision.pc_encoder import GlobalAEEncoder
    from pointcloud_tpu_torch.vision.pc_sensor import PointCloudSensor

    for make in (lambda: tenvs.RoboReach(),
                 lambda: tenvs.RoboPush(sensor=PointCloudSensor, encoder=GlobalAEEncoder),
                 lambda: tsynthetic.SyntheticScene("Cube"),
                 lambda: tsynthetic.SyntheticPegScene(),
                 lambda: make_synthetic_backend({}, "Cube")):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()

    class CardEnv:  # a sensor reads its env's device
        device = torch.device("cuda")
        bbox, sampler, sample_points = [[0, 1]] * 3, "FPS", 8

    with pytest.raises(RuntimeError, match="CUDA"):
        PointCloudSensor(CardEnv())


############################ synthetic scenes ############################


@pytest.mark.parametrize("scene", ["Table", "Cube", "PegInHole"])
def test_render_points_and_observe_equal(scene):
    """Rendered raw clouds bit-equal frame after frame, and observations of
    128 points (FPS and RS) with their numpy draw: the next frame renders the
    same points in both packages."""
    def make(mod):
        if scene == "PegInHole":
            return mod.SyntheticPegScene(seed=3, **({} if mod is jsynthetic else
                                                    {"device": "cpu"}))
        return mod.SyntheticScene(scene, seed=3, **({} if mod is jsynthetic else
                                                   {"device": "cpu"}))

    j, t = make(jsynthetic), make(tsynthetic)
    for frame in range(3):
        for a, b in zip(t.render_points(), j.render_points()):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        t.randomize()
        j.randomize()
        got, want = t.observe(sample_points=128), j.observe(sample_points=128)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{frame} {k}")
        assert got["segmentation"].dtype == np.int64
    rs = t.observe(sample_points=256, sampler="RS")
    j.observe(sample_points=256, sampler="RS")
    assert rs["points"].shape == (256, 3) and rs["segmentation"].shape == (256, 1)
    bbox = np.asarray(t.cfg["bbox"], np.float32)
    assert ((rs["points"] >= bbox[:, 0]) & (rs["points"] <= bbox[:, 1])).all()
    for a, b in zip(t.render_points(), j.render_points()):  # one draw each
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("scene", ["Table", "Cube", "PegInHole"])
def test_generate_dataset_frames_equal(scene, tmp_path):
    """generate_dataset's npz frames bit-equal (128 points), segmentation
    int64, ground_truth and classes as object pairs."""
    jsynthetic.generate_dataset(str(tmp_path / "j"), scene=scene, frames=3, seed=5,
                                sample_points=128)
    tsynthetic.generate_dataset(str(tmp_path / "t"), scene=scene, frames=3, seed=5,
                                sample_points=128, device="cpu")
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) and len(names) == 3
    for name in names:
        a = np.load(tmp_path / "t" / name, allow_pickle=True)
        b = np.load(tmp_path / "j" / name, allow_pickle=True)
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].dtype == b[k].dtype, k
            if b[k].dtype == object:
                for (na, va), (nb, vb) in zip(a[k], b[k]):
                    assert na == nb
                    np.testing.assert_array_equal(va, vb)
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name} {k}")
        assert a["segmentation"].dtype == np.int64


def test_sensed_envs_equal_at_128_points():
    """A task env with the PointCloudSensor and the Passthrough encoder (as
    generate_pc builds it): the sensed clouds of reset and 3 steps
    bit-equal, segmentation included."""
    from pointcloud_tpu.vision.pc_sensor import PointCloudSensor as JSensor
    from pointcloud_tpu_torch.vision.pc_sensor import PointCloudSensor as TSensor

    with scenes_at(128, "Cube", "PegInHole"):
        for task in ("RoboPush", "RoboPegInHole"):
            jenv = getattr(jenvs, task)(sensor=JSensor, require_segmentation=True)
            tenv = getattr(tenvs, task)(sensor=TSensor, require_segmentation=True,
                                        device="cpu")
            got, want = rollout(tenv, 2, steps=3), rollout(jenv, 2, steps=3)
            assert_same_rollout(got, want)
            for k in ("points", "rgb", "segmentation", "boundingbox"):
                np.testing.assert_array_equal(tenv.observation[k], jenv.observation[k])
                np.testing.assert_array_equal(tenv.goal_obs[k], jenv.goal_obs[k])
            assert tenv.observation["points"].shape == (128, 3)


def test_peg_in_hole_reads_pickled_goals(tmp_path):
    """RoboPegInHole draws its goal from goal_state_dir/*.pkl when present,
    with the env's seeded generator, as the JAX package's."""
    import pickle

    rng = np.random.default_rng(0)
    for i in range(3):
        goal = {k: rng.standard_normal(n).astype(np.float32) for k, n in
                (("peg_to_hole", 3), ("peg_quat", 4), ("hole_pos", 3), ("hole_quat", 4),
                 ("t", 1), ("d", 1), ("angle", 1))}
        with open(tmp_path / f"{i}.pkl", "wb") as f:
            pickle.dump(goal, f)
    jenv = jenvs.RoboPegInHole(goal_state_dir=str(tmp_path))
    tenv = tenvs.RoboPegInHole(goal_state_dir=str(tmp_path), device="cpu")
    for seed in (1, 2, 3):
        got, _ = tenv.reset(seed=seed)
        want, _ = jenv.reset(seed=seed)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        for k in jenv.goal_state:
            np.testing.assert_array_equal(tenv.goal_state[k], jenv.goal_state[k])


def test_goal_imagination_backend():
    """With visual goals and simulate_goal, Reach imagines its goal on a
    second synthetic backend seeded 1; goals and that backend's draws equal
    the JAX package's."""
    from pointcloud_tpu.vision.pc_sensor import PointCloudSensor as JSensor
    from pointcloud_tpu_torch.vision.pc_sensor import PointCloudSensor as TSensor

    with scenes_at(128, "Table"):
        kw = dict(visual_goal=True, simulate_goal=True)
        jenv = jenvs.RoboReach(sensor=JSensor, **kw)
        tenv = tenvs.RoboReach(sensor=TSensor, device="cpu", **kw)
        fresh = tsynthetic.SyntheticScene("Table", seed=1, device="cpu")
        assert tenv.goal_backend.sim.rng.bit_generator.state == \
            fresh.rng.bit_generator.state
        assert_same_rollout(rollout(tenv, 4, steps=2), rollout(jenv, 4, steps=2))
        for k in jenv.goal_state:
            np.testing.assert_array_equal(tenv.goal_state[k], jenv.goal_state[k])
        np.testing.assert_array_equal(tenv.goal_obs["points"], jenv.goal_obs["points"])
        assert tenv.goal_backend.sim.rng.bit_generator.state == \
            jenv.goal_backend.sim.rng.bit_generator.state
