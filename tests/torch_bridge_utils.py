"""Shared pieces of the bridge tests (tests/test_torch_env_*.py,
tests/test_torch_pc_*.py, tests/test_torch_bridge_*.py): both packages'
checkpoints of one configuration from the same random flax variables, the
scene tables at a smaller point budget, and the two packages' task envs
with a vision sensor and encoder.

Checkpoints: the JAX package's create_model, random variables of its
shapes (torch_port_utils.random_variables, so BatchNorm is no identity),
optax's Adam state, its save_checkpoint (orbax) under
<jax root>/<scene>/<Model>_<Backbone>/version_0/checkpoints/step_0, then
convert_checkpoint_torch.convert into the same place under the port's root.
Each package's encoders read their own root (pc_encoder.OUTPUT_ROOT).
"""

import contextlib
import importlib.util
import os

import numpy as np
import torch_port_utils  # noqa: F401  (one torch thread per worker)
from torch_port_utils import random_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def root_module(name):
    """A CLI at the root of the repo, imported as a module."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write_checkpoints(jroot, troot, scene, model_type, backbone, seed):
    """Both packages' step_0 of one configuration from the same variables;
    returns the JAX package's variables."""
    import jax
    import jax.numpy as jnp
    import optax

    from pointcloud_tpu.train import harness as jharness

    jspec, _ = jharness.create_model(model_type, backbone, scene)
    x = jnp.zeros((1, jspec.scene.sample_points, 6), jnp.float32)
    shapes = jax.eval_shape(
        lambda x: jspec.model.init(jax.random.PRNGKey(0), x, train=False), x)
    v = random_variables(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes),
        np.random.default_rng(seed))
    leaves = jax.tree_util.tree_leaves(optax.adam(1e-3).init(v["params"]))
    payload = {"params": v["params"], "batch_stats": v["batch_stats"],
               "epoch": np.asarray(0),
               "opt_state_leaves": {str(i): np.asarray(a) for i, a in enumerate(leaves)}}
    rel = os.path.join(scene, f"{model_type}_{backbone}", "version_0", "checkpoints")
    jdir = jharness.save_checkpoint(os.path.join(jroot, rel), 0, payload)
    root_module("convert_checkpoint_torch").convert(
        jdir, os.path.join(troot, rel), model_type, backbone, scene)
    return v


@contextlib.contextmanager
def scenes_at(points, *scenes):
    """Both packages' scene tables with `points` sample points in `scenes`."""
    import pytest

    from pointcloud_tpu.envs import scenes as jscenes
    from pointcloud_tpu_torch.envs import scenes as tscenes

    with pytest.MonkeyPatch.context() as mp:
        for table in (jscenes, tscenes):
            for scene in scenes:
                mp.setitem(table.cfg_scene, scene,
                           dict(table.cfg_scene[scene], sample_points=points))
        yield


@contextlib.contextmanager
def output_roots(jroot, troot):
    """Each package's encoders read checkpoints from its own root."""
    import pytest

    from pointcloud_tpu.vision import pc_encoder as jenc
    from pointcloud_tpu_torch.vision import pc_encoder as tenc

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jenc, "OUTPUT_ROOT", jroot)
        mp.setattr(tenc, "OUTPUT_ROOT", troot)
        yield


def subclass(encoder_cls, backbone):
    """The encoder class on another backbone (as tests/test_vision_envs.py
    does)."""
    if backbone == encoder_cls.backbone:
        return encoder_cls
    return type(encoder_cls.__name__, (encoder_cls,), {"backbone": backbone})


def both_envs(task, encoder, backbone="PointNet", **kwargs):
    """(JAX env, port env on the CPU) of one task with PointCloudSensor and
    the named encoder class of each package on `backbone`."""
    from pointcloud_tpu.envs import envs as jenvs
    from pointcloud_tpu.vision import pc_encoder as jenc
    from pointcloud_tpu.vision.pc_sensor import PointCloudSensor as JSensor
    from pointcloud_tpu_torch.envs import envs as tenvs
    from pointcloud_tpu_torch.vision import pc_encoder as tenc
    from pointcloud_tpu_torch.vision.pc_sensor import PointCloudSensor as TSensor

    jenv = getattr(jenvs, task)(sensor=JSensor,
                                encoder=subclass(getattr(jenc, encoder), backbone), **kwargs)
    tenv = getattr(tenvs, task)(sensor=TSensor,
                                encoder=subclass(getattr(tenc, encoder), backbone),
                                device="cpu", **kwargs)
    return jenv, tenv


def close_to(got, want, rel=1e-4, what=""):
    """Every entry within `rel` of the largest |want| entry."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max error {err} against {rel} x {scale}"
