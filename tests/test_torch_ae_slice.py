"""The port's first slice as a whole: the PointNet autoencoder's eval step
with Chamfer loss, and its encoder, against pointcloud_tpu on the CPU on
the same interop-converted weights (randomised, with random positive running
statistics). Also: interop totality, the import rule and the copied scene
table.

Tolerances: outputs and encodings 1e-4 absolute and relative (fp32 on both
sides; see tests/test_torch_pointnet.py for why ulps grow to ~1e-6), the
Chamfer loss 1e-5 absolute (the BASELINE guard).
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_utils import jax_variables, raw_clouds, to_np

from pointcloud_tpu import transforms as jtf
from pointcloud_tpu.envs import scenes as jscenes
from pointcloud_tpu.models import AE as JAE, backbone_factory as jbackbones
from pointcloud_tpu.train import harness as jharness
from pointcloud_tpu_torch import transforms as ttf
from pointcloud_tpu_torch.envs import scenes as tscenes
from pointcloud_tpu_torch.interop import flax_to_state_dict, load_flax_variables
from pointcloud_tpu_torch.models import AE as TAE, backbone_factory as tbackbones
from pointcloud_tpu_torch.train import harness as tharness

TOL = dict(atol=1e-4, rtol=1e-4)
LOSS_TOL = 1e-5


def test_eval_step_matches_jax_at_full_size():
    """The real entry points at the Cube scene's 2048 points, B=2."""
    rng = np.random.default_rng(0)
    jspec, _ = jharness.create_model("Autoencoder", "PointNet", "Cube",
                                     loss_override="chamfer")
    tspec = tharness.create_model("Autoencoder", "PointNet", "Cube",
                                  loss_override="chamfer", device="cpu")
    x = raw_clouds(rng, jspec.scene, 2, jspec.scene.sample_points)
    y = raw_clouds(rng, jspec.scene, 2, jspec.scene.sample_points)
    v = jax_variables(jspec.model, x, 1)
    load_flax_variables(tspec.model, v)

    jloss, _, jout = jharness.make_eval_step(jspec)(
        v["params"], v["batch_stats"], jnp.asarray(x), jnp.asarray(y))
    tloss, logs, tout = tharness.make_eval_step(tspec)(
        torch.from_numpy(x), torch.from_numpy(y))
    assert tout.shape == (2, 2048, 6) and tout.dtype == torch.float32
    assert logs == {}
    np.testing.assert_allclose(to_np(tout), np.asarray(jout), **TOL)
    assert abs(float(tloss) - float(jloss)) <= LOSS_TOL

    # the RL observation encoder's call: one normalised cloud
    xn = jtf.Normalize(jspec.scene.bbox)(jnp.asarray(x[0]))[0][None]
    jenc = jspec.model.apply(v, xn, train=False, method=jspec.model.encode)
    with torch.inference_mode():
        tenc = tspec.model.encode(
            ttf.Normalize(tspec.scene.bbox)(torch.from_numpy(x[:1]))[0])
    assert tenc.shape == (1, 13)
    np.testing.assert_allclose(to_np(tenc), np.asarray(jenc), **TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_autoencoder_modules_match_jax(masked):
    """AE forward, encode and Chamfer through the modules directly, at a
    reduced out_points and N, with a validity mask."""
    rng = np.random.default_rng(2)
    B, N, P = 2, 64, 48
    x = rng.random((B, N, 6), dtype=np.float32)
    m = (rng.random((B, N)) > 0.2) if masked else None
    jm = JAE(jbackbones["PointNet"](feature_dims=3), out_points=P, out_dim=6,
             bottleneck=13)
    tm = TAE(tbackbones["PointNet"](feature_dims=3), out_points=P, out_dim=6,
             bottleneck=13)
    v = jax_variables(jm, x, 3)
    load_flax_variables(tm, v)
    jmask = None if m is None else jnp.asarray(m)
    tmask = None if m is None else torch.from_numpy(m)
    with torch.inference_mode():
        tout = tm(torch.from_numpy(x), mask=tmask)
        tenc = tm.encode(torch.from_numpy(x), mask=tmask)
        tloss = tharness.ChamferDistance()(tout, torch.from_numpy(x),
                                           target_mask=tmask)
    jout = jm.apply(v, jnp.asarray(x), train=False, mask=jmask)
    jenc = jm.apply(v, jnp.asarray(x), train=False, mask=jmask, method=jm.encode)
    jloss = jharness.ChamferDistance()(jout, jnp.asarray(x), target_mask=jmask)
    assert tout.shape == (B, P, 6)
    np.testing.assert_allclose(to_np(tout), np.asarray(jout), **TOL)
    np.testing.assert_allclose(to_np(tenc), np.asarray(jenc), **TOL)
    assert abs(float(tloss) - float(jloss)) <= LOSS_TOL


def test_transforms_match_jax():
    rng = np.random.default_rng(4)
    bbox = jscenes.cfg_scene["PegInHole"]["bbox"]
    pc = rng.standard_normal((2, 20, 6)).astype(np.float32)
    for jt, tt in ((jtf.Normalize(bbox), ttf.Normalize(bbox)),
                   (jtf.Unnormalize(bbox), ttf.Unnormalize(bbox))):
        want = np.asarray(jax.vmap(lambda p: jt(p, None, None)[0])(jnp.asarray(pc)))
        got, mask = tt(torch.from_numpy(pc))
        np.testing.assert_allclose(to_np(got), want, atol=1e-6, rtol=1e-6)
        assert mask.shape == (2, 20) and bool(mask.all())


def test_interop_is_total():
    """Unknown and missing keys raise, as do unknown leaves, collections and
    shapes."""
    rng = np.random.default_rng(5)
    x = rng.random((1, 16, 6), dtype=np.float32)
    jm = JAE(jbackbones["PointNet"](feature_dims=3), out_points=8, bottleneck=13)
    tm = TAE(tbackbones["PointNet"](feature_dims=3), out_points=8, bottleneck=13)
    v = jax_variables(jm, x, 6)
    state = flax_to_state_dict(v)
    assert set(state) == set(tm.state_dict())
    w = v["params"]["decoder"]["MLP_0"]["Dense_0"]["kernel"]
    np.testing.assert_array_equal(
        to_np(state["decoder.MLP_0.Dense_0.weight"]), w.T)

    def edited(edit):
        tree = jax.tree_util.tree_map(lambda a: a, v)  # deep copy of dicts
        edit(tree)
        return tree

    with pytest.raises(KeyError, match="missing"):
        load_flax_variables(tm, edited(
            lambda t: t["batch_stats"]["encoder"]["backbone"]["dbnpool2"].pop("var")))
    with pytest.raises(KeyError, match="unknown"):
        load_flax_variables(tm, edited(
            lambda t: t["params"]["encoder"].__setitem__(
                "MLP_1", {"Dense_0": {"kernel": w, "bias": w[0]}})))
    with pytest.raises(KeyError, match="unknown flax leaf"):
        flax_to_state_dict(edited(
            lambda t: t["params"]["decoder"]["MLP_0"]["Dense_0"].__setitem__(
                "gamma", w[0])))
    with pytest.raises(KeyError, match="unknown flax collection"):
        flax_to_state_dict({**v, "cache": {}})
    with pytest.raises(ValueError):
        load_flax_variables(tm, edited(
            lambda t: t["params"]["decoder"]["MLP_0"]["Dense_0"].__setitem__(
                "kernel", w[:, :5])))


def test_create_model_rejects_unported_configs():
    """Every model type of cfg.models builds on every backbone of the
    factory; an unknown model type or backbone raises."""
    from pointcloud_tpu_torch import cfg as tcfg

    for model_type in tcfg.models:
        for backbone in tbackbones:
            spec = tharness.create_model(model_type, backbone, "Cube", device="cpu")
            assert spec.model_type == model_type and spec.backbone == backbone
    for args in (("Classifier", "PointNet", "Cube"),
                 ("MultiSegmenter", "PointNet2MSG", "Cube")):
        with pytest.raises(NotImplementedError):
            tharness.create_model(*args, device="cpu")


def test_scene_table_is_the_jax_packages():
    assert tscenes.cfg_scene == jscenes.cfg_scene
    assert tscenes.robo_kwargs == jscenes.robo_kwargs
    assert vars(tscenes.scene_config("Cube")) == vars(jscenes.scene_config("Cube"))


GENERATE_CLI = str(Path(__file__).parents[1] / "generate_pc_torch.py")


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, pointcloud_tpu_torch, pointcloud_tpu_torch.ops, "
        "pointcloud_tpu_torch.models, pointcloud_tpu_torch.train, "
        "pointcloud_tpu_torch.interop, pointcloud_tpu_torch.losses, "
        "pointcloud_tpu_torch.ops.scatter_rows, "
        "pointcloud_tpu_torch.ops.chamfer_bwd, "
        "pointcloud_tpu_torch.ops.dense_bn_pool, "
        "pointcloud_tpu_torch.ops.fps, pointcloud_tpu_torch.ops.ball_group, "
        "pointcloud_tpu_torch.ops.preextract_fused, "
        "pointcloud_tpu_torch.ops.sinkhorn, pointcloud_tpu_torch.ops.emd, "
        "pointcloud_tpu_torch.models.pointnet2, pointcloud_tpu_torch.transforms, "
        "pointcloud_tpu_torch.models.pointmlp, pointcloud_tpu_torch.ops.knn_group, "
        "pointcloud_tpu_torch.ops.group_gather, pointcloud_tpu_torch.cfg, "
        "pointcloud_tpu_torch.data, pointcloud_tpu_torch.data.dataset, "
        "pointcloud_tpu_torch.data.native_loader, pointcloud_tpu_torch.utils, "
        "pointcloud_tpu_torch.utils.profiling, pointcloud_tpu_torch.train.harness, "
        "pointcloud_tpu_torch.models.architectures, pointcloud_tpu_torch.models.pointnet\n"
        "from pointcloud_tpu_torch.train import make_train_step, train\n"
        "from pointcloud_tpu_torch.interop import checkpoint_from_jax\n"
        "from pointcloud_tpu_torch.transforms import apply_np\n"
        "from pointcloud_tpu_torch.data.native_loader import get_library\n"
        "get_library()\n"
        "from pointcloud_tpu_torch.losses import EarthMoverDistance, "
        "FilteringChamferDistance, SegmentingChamferDistance, StatePredictionLoss\n"
        "from pointcloud_tpu_torch.models import GTEncoder, MLPChainPool, "
        "MultiGTEncoder, MultiSegAE\n"
        "from pointcloud_tpu_torch.transforms import FilterClasses, IntegerEncode, "
        "OneHotEncode, SampleRandomPoints, class_mean_pos, seg_to_color\n"
        "import pointcloud_tpu_torch.envs.sensors, pointcloud_tpu_torch.envs.spaces, "
        "pointcloud_tpu_torch.envs.encoders, pointcloud_tpu_torch.envs.utils, "
        "pointcloud_tpu_torch.envs.synthetic, pointcloud_tpu_torch.envs.camera, "
        "pointcloud_tpu_torch.envs.backends, pointcloud_tpu_torch.envs.base_env, "
        "pointcloud_tpu_torch.envs.envs, pointcloud_tpu_torch.envs.registration, "
        "pointcloud_tpu_torch.vision, pointcloud_tpu_torch.vision.pc_sensor, "
        "pointcloud_tpu_torch.vision.pc_encoder, pointcloud_tpu_torch.train.calibrate, "
        "pointcloud_tpu_torch.data.generate\n"
        "from pointcloud_tpu_torch.envs.registration import register_all\n"
        "from pointcloud_tpu_torch.transforms import sensor_chain\n"
        "from pointcloud_tpu_torch.utils import resolve_device\n"
        "import importlib.util; spec = importlib.util.spec_from_file_location("
        f"'generate_pc_torch', {GENERATE_CLI!r}); "
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m in ('jax', 'flax', 'optax', "
        "'pointcloud_tpu') or m.startswith(('jax.', 'flax.', 'optax.', "
        "'pointcloud_tpu.'))]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
