"""The port's train() loop against the JAX package's, on the CPU.

Data: tests/test_train.py's fixture (the JAX package's generator, 128
points, 16 train and 4 val frames, B=4: four steps an epoch, one val batch),
the Cube scene's point budget patched to 128 in both packages' scene tables
and EMD at 10 iterations, as tests/test_train.py does.

The parity test, for the CLI's default configuration (the PointNet2
autoencoder under EMD) and for tests/test_train.py's (PointNet under
Chamfer): the JAX train() runs one epoch (single device); its step_0 goes
through convert_checkpoint_torch.py; both loops resume from their step_0
into epoch 1 (both loaders start afresh from seed 0, so both see epoch 0's
order again, through the native loader) and write step_1. Compared:

  * the version directory and the checkpoint step: equal, step_1;
  * the TensorBoard tags and steps of the resumed runs (read back with
    EventAccumulator): equal;
  * the parameters after the epoch's four steps: at most 2 lr a step
    apart, the most that Adam steps of opposite sign can put between two
    copies;
  * the epoch's last train loss, the val loss and the running statistics
    (relative to max(1, |value|)), to the bounds of TOL below. These are
    looser than 1e-3 because the JAX package is no closer to itself: the
    same resume run data-parallel over 4 CPU devices (a different order of
    sums, the same function) against one device moves the train loss by
    1.6e-3 (PointNet2 + EMD) and 6e-4 (PointNet + Chamfer) relative, the
    val loss by 2.2e-3 and 1.3e-2 (the STN heads normalise four clouds'
    features over the batch and amplify round-off), the parameters by up
    to 2.0e-3. Port against JAX, measured here: train loss 1.9e-3 / 1.8e-3
    (its EMD part 3.1e-3), val loss 2.1e-3 / 1.2e-2, parameters 1.9e-3 /
    3.2e-3, statistics 5.7e-4 / 3.4e-3 (PointNet2 + EMD / PointNet +
    Chamfer). The loss's sub-logs are held to the train loss's bound.

The other tests drive the port's loop alone: version numbering, its own
resume (Adam's step carried over), the checkpoint cadence, the ragged val
batch, the threaded loader, the trace, the CLIs, and the refusals.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch
import torch_port_utils  # noqa: F401  (one torch thread per worker)

import pointcloud_tpu.cfg as jcfg
from pointcloud_tpu.envs import scenes as jscenes
from pointcloud_tpu.envs.synthetic import generate_dataset
from pointcloud_tpu.train import harness as jharness
from pointcloud_tpu_torch import cfg as tcfg
from pointcloud_tpu_torch.envs import scenes as tscenes
from pointcloud_tpu_torch.interop import flax_to_state_dict
from pointcloud_tpu_torch.train import harness as tharness

N_PTS = 128
B = 4
LR = 1e-3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (train loss, val loss, running statistics): relative bounds, see above
TOL = {("PointNet2", None): (5e-3, 5e-3, 2e-3),
       ("PointNet", "chamfer"): (5e-3, 3e-2, 1e-2)}


def root_module(name):
    """A CLI at the root of the repo, imported as a module."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def small_scene(mp):
    for scenes in (jscenes, tscenes):
        mp.setitem(scenes.cfg_scene, "Cube", dict(scenes.cfg_scene["Cube"],
                                                   sample_points=N_PTS))
    mp.setattr(jcfg, "emd_iterations", 10)
    mp.setattr(tcfg, "emd_iterations", 10)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """input/<scene>/{train,val} layout with tiny clouds."""
    root = tmp_path_factory.mktemp("input_root")
    d = root / "Cube"
    generate_dataset(str(d / "train"), scene="Cube", frames=16, seed=0, sample_points=N_PTS)
    generate_dataset(str(d / "val"), scene="Cube", frames=4, seed=99, sample_points=N_PTS)
    return str(root)


@pytest.fixture(autouse=True)
def patched_scene(monkeypatch):
    small_scene(monkeypatch)


def scalars(run_dir):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    ea = EventAccumulator(run_dir)
    ea.Reload()
    out = {k: [(e.step, e.value) for e in ea.Scalars(k)] for k in ea.Tags()["scalars"]}
    out.update({k: [(e.step, None) for e in ea.Tensors(k)] for k in ea.Tags()["tensors"]})
    return out


@pytest.fixture(scope="module", params=sorted(TOL, key=str), ids=lambda c: "-".join(map(str, c)))
def resumed(request, data_root, tmp_path_factory):
    """Both loops resumed into epoch 1 from the JAX package's step_0."""
    backbone, loss = request.param
    out = tmp_path_factory.mktemp("out")
    kw = dict(scene="Cube", batch_size=B, input_root=data_root, loss_override=loss)
    with pytest.MonkeyPatch.context() as mp:
        small_scene(mp)
        _, jdir = jharness.train("Autoencoder", backbone, epochs=1, data_parallel=False,
                                 output_root=str(out / "jax"), **kw)
        jloss, jdir = jharness.train("Autoencoder", backbone, epochs=2,
                                     data_parallel=False, output_root=str(out / "jax"),
                                     ckpt_path=os.path.join(jdir, "step_0"), **kw)
        pdir = os.path.join(out, "port", "Cube", f"Autoencoder_{backbone}", "version_0",
                            "checkpoints")
        argv = [os.path.join(jdir, "step_0"), pdir, "Autoencoder", "--backbone", backbone]
        mp.setattr(sys, "argv", ["convert_checkpoint_torch.py", *argv,
                                 *(["--loss", loss] if loss else [])])
        root_module("convert_checkpoint_torch").main()
        epochs = []
        tloss, tdir = tharness.train("Autoencoder", backbone, epochs=2, device="cpu",
                                     output_root=str(out / "port"), on_epoch=epochs.append,
                                     ckpt_path=os.path.join(pdir, "step_0"), **kw)
        names = {n for n, _ in tharness.create_model(
            "Autoencoder", backbone, "Cube", device="cpu").model.named_parameters()}
    jck = jharness.load_checkpoint_raw(os.path.join(jdir, "step_1"))
    jstate = {k: v.numpy() for k, v in flax_to_state_dict(
        {"params": jck["params"], "batch_stats": jck["batch_stats"]}).items()}
    tck = tharness.load_checkpoint_raw(os.path.join(tdir, "step_1"))
    return {"case": request.param, "out": str(out), "jax": (jloss, jdir), "port": (tloss, tdir),
            "epochs": epochs, "names": names, "jstate": jstate, "tck": tck,
            "jtb": scalars(os.path.dirname(jdir)), "ttb": scalars(os.path.dirname(tdir))}


def test_resumed_run_keeps_its_version_and_writes_step_1(resumed):
    (_, jdir), (_, tdir) = resumed["jax"], resumed["port"]
    assert os.path.relpath(tdir, os.path.join(resumed["out"], "port")) == os.path.relpath(
        jdir, os.path.join(resumed["out"], "jax"))
    assert tdir.endswith(os.path.join("version_0", "checkpoints"))
    assert tharness.latest_checkpoint(tdir).endswith("step_1")
    assert sorted(os.listdir(tdir)) == ["step_0", "step_1"]
    assert resumed["tck"]["epoch"] == 1 and [e["epoch"] for e in resumed["epochs"]] == [1]
    steps = {float(s["step"]) for s in resumed["tck"]["optimizer"]["state"].values()}
    assert steps == {8.0}  # Adam's count went on from the JAX run's 4


def test_tensorboard_tags_and_steps_match(resumed):
    """The resumed runs' events (the JAX run directory also holds its
    first run's, at step 4)."""
    jtb = {k: [s for s, _ in v if s > 16 // B] for k, v in resumed["jtb"].items()}
    ttb = {k: [s for s, _ in v] for k, v in resumed["ttb"].items()}
    assert ttb == jtb
    assert {"train_loss", "val_loss", "Point Cloud_VERTEX", "Point Cloud_COLOR"} <= set(ttb)
    if resumed["case"][1] is None:
        assert {"train_loss/EMD", "train_loss/feature"} <= set(ttb)


def test_losses_match(resumed):
    tol_train, tol_val, _ = TOL[resumed["case"]]
    jloss, tloss = resumed["jax"][0], resumed["port"][0]
    assert abs(tloss - jloss) <= tol_train * abs(jloss), (tloss, jloss)
    assert resumed["epochs"][0]["train_loss"] == tloss
    jval = dict(resumed["jtb"]["val_loss"])[2 * 16 // B]
    tval = resumed["epochs"][0]["val_loss"]
    assert abs(tval - jval) <= tol_val * abs(jval), (tval, jval)
    for tag, values in resumed["ttb"].items():
        if tag.startswith("train_loss"):
            (step, got), = values
            want = dict(resumed["jtb"][tag])[step]
            assert abs(got - want) <= tol_train * abs(want), (tag, got, want)


def test_parameters_match(resumed):
    """2 lr a step over the epoch's four steps."""
    for k in resumed["names"]:
        got = resumed["tck"]["model"][k].numpy()
        assert np.abs(got - resumed["jstate"][k]).max() <= 2 * LR * (16 // B), k


def test_running_statistics_match(resumed):
    tol = TOL[resumed["case"]][2]
    stats = [k for k in resumed["jstate"] if k not in resumed["names"]]
    assert stats and set(resumed["tck"]["model"]) == set(resumed["jstate"])
    for k in stats:
        want = resumed["jstate"][k]
        got = resumed["tck"]["model"][k].numpy()
        assert np.abs(got - want).max() <= tol * max(1.0, float(np.abs(want).max())), k


############################ the port's loop alone ############################


def port_train(data_root, out, **kw):
    kw = {"epochs": 2, "batch_size": B, "loss_override": "chamfer", **kw}
    return tharness.train("Autoencoder", "PointNet", "Cube", input_root=data_root,
                          output_root=str(out), device="cpu", log_meshes=False, **kw)


def test_versions_resume_and_cadence(data_root, tmp_path, monkeypatch):
    epochs = []
    loss, d0 = port_train(data_root, tmp_path, on_epoch=epochs.append)
    assert np.isfinite(loss) and loss == epochs[-1]["train_loss"]
    assert [e["epoch"] for e in epochs] == [0, 1]
    assert [e["global_step"] for e in epochs] == [4, 8]
    assert all(e["checkpoint"] and e["steps"] == 16 // B for e in epochs)
    assert sorted(os.listdir(d0)) == ["step_0", "step_1"]
    _, d1 = port_train(data_root, tmp_path, epochs=1)
    assert d0.endswith(os.path.join("version_0", "checkpoints"))
    assert d1.endswith(os.path.join("version_1", "checkpoints"))
    # its own resume: into the same version, epoch 2 alone, Adam's step on
    resumed = []
    _, d2 = port_train(data_root, tmp_path, epochs=3, on_epoch=resumed.append,
                       ckpt_path=tharness.latest_checkpoint(d0))
    assert d2 == d0 and [e["epoch"] for e in resumed] == [2]
    assert resumed[0]["global_step"] == 12
    ck = tharness.load_checkpoint_raw(tharness.latest_checkpoint(d0))
    assert ck["epoch"] == 2 and tharness.latest_checkpoint(d0).endswith("step_2")
    assert {float(s["step"]) for s in ck["optimizer"]["state"].values()} == {12.0}
    # the cadence: every ckpt_every epochs and the last
    monkeypatch.setattr(tcfg, "ckpt_every", 2)
    _, d3 = port_train(data_root, tmp_path / "cadence", epochs=5)
    assert sorted(os.listdir(d3)) == ["step_0", "step_2", "step_4"]


def test_ragged_val_batch_and_threaded_loader(data_root, tmp_path, monkeypatch):
    """B=3: the train loader drops its last frame, validation keeps a batch
    of one; the threaded loader where the native one is switched off."""
    for native in (True, False):
        monkeypatch.setattr(tcfg, "use_native_loader", native)
        epochs = []
        loss, _ = port_train(data_root, tmp_path / str(native), epochs=1, batch_size=3,
                             on_epoch=epochs.append)
        assert epochs[0]["steps"] == 5 and np.isfinite(epochs[0]["val_loss"])


def test_profile_writes_a_trace(data_root, tmp_path):
    _, d = port_train(data_root, tmp_path, epochs=1, profile=True)
    assert os.path.getsize(os.path.join(os.path.dirname(d), "profile", "trace.json")) > 0


def test_segmenter_trains(data_root, tmp_path):
    loss, d = tharness.train("Segmenter", "PointNet", "Cube", epochs=1, batch_size=B,
                             input_root=data_root, output_root=str(tmp_path), device="cpu")
    assert np.isfinite(loss) and tharness.latest_checkpoint(d).endswith("step_0")


def test_cli_trains_on_the_cpu(data_root, tmp_path, monkeypatch):
    monkeypatch.setattr(sys, "argv", [
        "train_torch.py", "Cube", "Autoencoder", "--backbone", "PointNet", "--epochs", "1",
        "--batch_size", str(B), "--loss", "chamfer", "--input_root", data_root,
        "--output_root", str(tmp_path), "--device", "cpu"])
    root_module("train_torch").main()
    d = tmp_path / "Cube" / "Autoencoder_PointNet" / "version_0" / "checkpoints"
    assert tharness.latest_checkpoint(str(d)).endswith("step_0")


def test_train_on_a_missing_card_raises(data_root, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        tharness.train("Autoencoder", "PointNet", "Cube", epochs=1, input_root=data_root,
                       output_root=str(tmp_path))
    assert not os.path.exists(tmp_path / "Cube")
