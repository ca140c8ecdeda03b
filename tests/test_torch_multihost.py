"""The port's multi-process training on the CPU over gloo (after
tests/test_multihost.py and tests/test_train.py's multihost run):
`train(multihost=True)` on two ranks of a process group, and
`train_torch.py --multihost` launched as two processes with torchrun's
variables.

Data: the JAX package's generator, 128 points, 16 train and 4 val frames;
B=4 global (two clouds a rank), PointNet under Chamfer. Held: both ranks end
with the same finite loss and the same epochs' numbers; only rank 0 writes
checkpoints (the writer is counted on each rank) and they are on disk; a
second run resumes from rank 0's checkpoint on every rank, into the same
version, at the next epoch; one rank without a group refuses multihost.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch_port_utils  # noqa: F401  (one torch thread per worker)
from torch_dist_utils import free_port, multihost_train, run_ranks

from pointcloud_tpu.envs.synthetic import generate_dataset
from pointcloud_tpu_torch.envs import scenes
from pointcloud_tpu_torch.train import harness

N_PTS = 128
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("input_root")
    generate_dataset(str(root / "Cube" / "train"), scene="Cube", frames=16, seed=0,
                     sample_points=N_PTS)
    generate_dataset(str(root / "Cube" / "val"), scene="Cube", frames=4, seed=99,
                     sample_points=N_PTS)
    return str(root)


@pytest.fixture(scope="module")
def runs(data_root, tmp_path_factory):
    """Two ranks train one epoch, then resume from step_0 into a second."""
    out = str(tmp_path_factory.mktemp("out"))
    first = run_ranks(multihost_train, 2, data_root, out, 1)
    written = sorted(os.listdir(first[0][1]))
    second = run_ranks(multihost_train, 2, data_root, out, 2,
                       os.path.join(first[0][1], "step_0"))
    return first, written, second


def test_two_ranks_train_to_the_same_finite_loss(runs):
    first, _, _ = runs
    (l0, d0, e0, _, r0), (l1, d1, e1, _, r1) = first
    assert (r0, r1) == (0, 1)
    assert np.isfinite(l0) and l0 == l1 and d0 == d1
    assert [e["epoch"] for e in e0] == [0] and [e["steps"] for e in e0] == [4]
    assert [(e["train_loss"], e["val_loss"]) for e in e0] == \
        [(e["train_loss"], e["val_loss"]) for e in e1]


def test_only_rank_0_writes_checkpoints(runs):
    first, written, _ = runs
    assert first[0][3] == [0] and first[1][3] == []
    assert written == ["step_0"]
    assert [e["checkpoint"] for e in first[1][2]] == [False]


def test_every_rank_resumes_from_rank_0s_checkpoint(runs):
    first, _, second = runs
    assert second[0][0] == second[1][0]
    for (loss, d, epochs, wrote, rank) in second:
        assert d == first[0][1]  # the same version
        assert [e["epoch"] for e in epochs] == [1]
        assert epochs[0]["global_step"] == 8 and np.isfinite(loss)
        assert wrote == ([1] if rank == 0 else [])
    ck = harness.load_checkpoint_raw(os.path.join(first[0][1], "step_1"))
    assert ck["epoch"] == 1
    assert {float(s["step"]) for s in ck["optimizer"]["state"].values()} == {8.0}


def test_multihost_without_a_group_raises(data_root, tmp_path, monkeypatch):
    monkeypatch.setitem(scenes.cfg_scene, "Cube",
                        dict(scenes.cfg_scene["Cube"], sample_points=N_PTS))
    with pytest.raises(RuntimeError, match="needs a process group"):
        harness.train("Autoencoder", "PointNet", "Cube", epochs=1, batch_size=4,
                      input_root=data_root, output_root=str(tmp_path), device="cpu",
                      multihost=True)


def test_cli_multihost_two_processes(data_root, tmp_path):
    """train_torch.py --multihost --device cpu, two processes with the
    variables torchrun sets; the scene's points patched by a wrapper."""
    port = free_port()
    wrapper = tmp_path / "run.py"
    wrapper.write_text(
        "import runpy, sys\n"
        "from pointcloud_tpu_torch.envs import scenes\n"
        f"scenes.cfg_scene['Cube'] = dict(scenes.cfg_scene['Cube'], sample_points={N_PTS})\n"
        f"sys.argv = ['train_torch.py'] + sys.argv[1:]\n"
        f"runpy.run_path({os.path.join(ROOT, 'train_torch.py')!r}, run_name='__main__')\n")
    args = ["Cube", "Autoencoder", "--backbone", "PointNet", "--epochs", "1",
            "--batch_size", "4", "--loss", "chamfer", "--input_root", data_root,
            "--output_root", str(tmp_path / "out"), "--device", "cpu", "--multihost"]
    procs = []
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank),
                   PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, str(wrapper), *args], cwd=ROOT,
                                      env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=240)[0])
        except subprocess.TimeoutExpired:
            p.kill()
            outs.append(p.communicate()[0])
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
        assert "multihost: joined the process group" in out
    assert "rank 0: epoch 0" in outs[0] and "rank 1: epoch 0" in outs[1]
    d = tmp_path / "out" / "Cube" / "Autoencoder_PointNet" / "version_0" / "checkpoints"
    assert sorted(os.listdir(d)) == ["step_0"]


def test_initialize_without_a_coordinator_is_a_single_process(monkeypatch):
    """No MASTER_ADDR / WORLD_SIZE and no arguments: nothing to join, as
    the JAX function returns False on a single host."""
    from pointcloud_tpu_torch.parallel import initialize

    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert initialize(device="cpu") is False
