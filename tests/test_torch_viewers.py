"""The port's viewers (pointcloud_tpu_torch/viewers/) and its five viewer and
rollout CLIs, on the CPU (after tests/test_viewers.py).

  * `aa_lines` and `lerp_clouds` equal the JAX package's;
  * `plot.py` and `interactive.py` are copies: their code (docstrings
    aside) is held equal to the originals';
  * `assemble_prediction` gives the JAX package's clouds for all four model
    types on the same random flax variables converted by interop (PointNet,
    64 points, fp32, atol 1e-5);
  * `load_viewer_model` loads the full model from a checkpoint the port
    wrote;
  * each CLI runs headless with `--device cpu` (matplotlib's Agg backend
    for the PNGs): pc_viewer_torch.py, ae_viewer_torch.py,
    live_ae_viewer_torch.py (VisionReach, two steps), sim_torch.py
    (VisionReach, --benchmark 2) and calibrate_latent_torch.py (a DDPG
    policy file), the vision envs at 128 sensed points on random PointNet2
    weights written by the port.
"""

import ast
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch_port_utils  # noqa: F401  (one torch thread per worker)
from torch_bridge_utils import root_module
from torch_port_utils import random_variables

from pointcloud_tpu.envs import scenes as jscenes
from pointcloud_tpu.envs.synthetic import generate_dataset
from pointcloud_tpu.train import harness as jharness
from pointcloud_tpu.viewers import reconstruct as jrec
from pointcloud_tpu_torch.envs import scenes as tscenes
from pointcloud_tpu_torch.interop import load_flax_variables
from pointcloud_tpu_torch.train import harness as tharness
from pointcloud_tpu_torch.viewers import reconstruct as trec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PTS = 64
MODEL_TYPES = ("Autoencoder", "Segmenter", "MultiSegmenter", "StatePredictor")


def _code(path):
    """A module's AST without its docstrings."""
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant) \
                and isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("name", ["plot", "interactive"])
def test_copies_hold_the_originals_code(name):
    assert _code(os.path.join(ROOT, "pointcloud_tpu_torch", "viewers", f"{name}.py")) == \
        _code(os.path.join(ROOT, "pointcloud_tpu", "viewers", f"{name}.py"))


def test_aa_lines_and_lerp_equal_jax():
    for got, want in zip(trec.aa_lines([1.0, 2.0, 3.0], [1, 0, 0], length=0.2, n=10),
                         jrec.aa_lines([1.0, 2.0, 3.0], [1, 0, 0], length=0.2, n=10)):
        np.testing.assert_array_equal(got, want)
    a = np.zeros((5, 3), np.float32)
    b = np.linspace(0, 1, 15, dtype=np.float32).reshape(5, 3)
    np.testing.assert_array_equal(trec.lerp_clouds(a, b, 0.25), jrec.lerp_clouds(a, b, 0.25))


@pytest.fixture
def small_cube(monkeypatch):
    for table in (jscenes, tscenes):
        monkeypatch.setitem(table.cfg_scene, "Cube",
                            dict(table.cfg_scene["Cube"], sample_points=N_PTS))


def _target(model_type, rng, x):
    if model_type == "StatePredictor":
        return {"cube_pos": rng.random(3, dtype=np.float32),
                "robot0_eef_pos": rng.random(3, dtype=np.float32)}
    if model_type == "Autoencoder":
        return x
    labels = rng.integers(0, 5, (N_PTS, 1)).astype(np.float32)
    return np.concatenate([rng.random((N_PTS, 3), dtype=np.float32), labels], axis=1)


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_assemble_prediction_matches_jax(small_cube, model_type):
    rng = np.random.default_rng(7)
    x = rng.random((N_PTS, 6), dtype=np.float32)
    target = _target(model_type, rng, x)
    colors = tscenes.cfg_scene["Cube"]["class_colors"]
    jspec, _ = jharness.create_model(model_type, "PointNet", "Cube")
    variables = random_variables(
        jspec.model.init(jax.random.PRNGKey(0), x[None], train=False), rng)
    tspec = tharness.create_model(model_type, "PointNet", "Cube", device="cpu")
    load_flax_variables(tspec.model, variables)
    got = trec.assemble_prediction(model_type, tspec, None, x, target, class_colors=colors)
    want = jrec.assemble_prediction(model_type, jspec, variables, x, target,
                                    class_colors=colors)
    for g, w in zip(got, want):
        assert g.shape == np.asarray(w).shape
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5)
    assert len(got[0]) > 0


def _port_checkpoint(root, scene, model_type, backbone, seed=0):
    """A port checkpoint (step_0) of random weights under root; its state."""
    spec = tharness.create_model(model_type, backbone, scene, device="cpu", seed=seed)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for t in spec.model.state_dict().values():
            if t.is_floating_point():
                t.copy_(0.5 + 0.5 * torch.rand(t.shape, generator=gen))
    d = os.path.join(root, scene, f"{model_type}_{backbone}", "version_0", "checkpoints")
    tharness.save_checkpoint(d, 0, tharness.checkpoint_payload(
        spec, tharness.make_optimizer(spec), 0))
    return {k: v.clone() for k, v in spec.model.state_dict().items()}


def test_load_viewer_model_loads_the_full_model(small_cube, tmp_path):
    state = _port_checkpoint(str(tmp_path), "Cube", "Autoencoder", "PointNet")
    spec, variables = trec.load_viewer_model("Cube", "Autoencoder", "PointNet",
                                             output_root=str(tmp_path), device="cpu")
    assert set(variables) == set(state)
    for k, v in spec.model.state_dict().items():
        assert torch.equal(v, state[k]), k  # the decoders too


@pytest.fixture
def cli_env(tmp_path, monkeypatch):
    """The vision envs at 128 points (Table, Cube), the port's encoders
    reading random PointNet2 weights under tmp_path, matplotlib on Agg."""
    from pointcloud_tpu_torch.vision import pc_encoder

    for scene in ("Table", "Cube"):
        monkeypatch.setitem(tscenes.cfg_scene, scene,
                            dict(tscenes.cfg_scene[scene], sample_points=128))
    root = str(tmp_path / "output")
    monkeypatch.setattr(pc_encoder, "OUTPUT_ROOT", root)
    monkeypatch.setenv("MPLBACKEND", "Agg")
    _port_checkpoint(root, "Table", "Autoencoder", "PointNet2")
    return root


def run_cli(monkeypatch, name, *args):
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *args])
    root_module(name).main()


def test_pc_viewer_cli_headless(tmp_path):
    d = tmp_path / "data"
    generate_dataset(str(d), scene="Cube", frames=1, seed=0, sample_points=128)
    out = tmp_path / "frame.png"
    r = subprocess.run(
        [sys.executable, "pc_viewer_torch.py", str(d / "0.npz"), "--save", str(out),
         "--device", "cpu"],
        capture_output=True, text=True, timeout=240, cwd=ROOT,
        env={**os.environ, "MPLBACKEND": "Agg", "PYTHONPATH": ROOT},
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert out.exists() and out.stat().st_size > 1000
    assert "class 1 cube" in r.stdout


def test_ae_viewer_cli_headless(small_cube, tmp_path, monkeypatch):
    _port_checkpoint(str(tmp_path / "out"), "Cube", "Segmenter", "PointNet")
    generate_dataset(str(tmp_path / "in" / "Cube" / "val"), scene="Cube", frames=2,
                     seed=1, sample_points=N_PTS)
    out = tmp_path / "seg.png"
    run_cli(monkeypatch, "ae_viewer_torch", "Cube", "Segmenter", "--backbone", "PointNet",
            "--index", "1", "--save", str(out), "--input_root", str(tmp_path / "in"),
            "--output_root", str(tmp_path / "out"), "--device", "cpu")
    assert out.exists() and out.stat().st_size > 1000


def test_live_ae_viewer_cli_headless(cli_env, tmp_path, monkeypatch):
    frames = tmp_path / "frames"
    run_cli(monkeypatch, "live_ae_viewer_torch", "VisionReach-v0", "--steps", "2",
            "--save_dir", str(frames), "--output_root", cli_env, "--device", "cpu")
    assert sorted(os.listdir(frames)) == ["0000.png", "0001.png"]


def test_sim_cli_benchmark(cli_env, monkeypatch, capsys):
    run_cli(monkeypatch, "sim_torch", "VisionReach-v0", "--benchmark", "2", "--horizon",
            "3", "--device", "cpu")
    out = capsys.readouterr().out
    assert "episodes =  2" in out and "success rate = " in out


def test_calibrate_latent_cli(cli_env, tmp_path, monkeypatch, capsys):
    from pointcloud_tpu_torch.rl import core as tcore
    from pointcloud_tpu_torch.rl.ddpg import _save

    policy = str(tmp_path / "reach.pkl")  # RoboReach: 3 + 3 in, 4 actions
    _save(policy, tcore.init_params(tcore.Actor(6, 4, 1.0, (8,)),
                                    torch.Generator().manual_seed(0)))
    run_cli(monkeypatch, "calibrate_latent_torch", "VisionReach-v0", policy, "--runs", "1",
            "--horizon", "3", "--no_save", "--device", "cpu")
    assert "threshold =" in capsys.readouterr().out


def test_plotting_without_matplotlib_raises_clearly(monkeypatch):
    import importlib.util

    from pointcloud_tpu_torch import viewers

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib" else real(name, *a))
    with pytest.raises(ImportError, match="plotting needs matplotlib"):
        viewers.check_plotting("out.png")
