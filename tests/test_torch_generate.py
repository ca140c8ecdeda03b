"""The port's dataset generation against the JAX package's on the CPU:
generate_pc (data/generate.py) on the port's gym id and on a task class,
and the generate_pc_torch.py CLI with --synthetic.

generate_pc seeds its first reset with `seed` (goals and the randomize
draws); the JAX function leaves them unseeded, so its env gets the same
seeded first reset here through a wrapper around gym.make. Frames of 128
points (tests/test_torch_env_layer.py says why); tolerance: none.
"""

import os

import gymnasium
import numpy as np
import pytest
from torch_bridge_utils import root_module, scenes_at

from pointcloud_tpu.data.generate import generate_pc as jgenerate
from pointcloud_tpu.envs.synthetic import generate_dataset as jdataset
from pointcloud_tpu_torch.data.generate import generate_pc as tgenerate
from pointcloud_tpu_torch.envs.envs import RoboPegInHole


class SeededFirstReset(gymnasium.Wrapper):
    def __init__(self, env, seed):
        super().__init__(env)
        self.seed = seed

    def reset(self, **kw):
        seed, self.seed = self.seed, None
        return self.env.reset(seed=seed, **kw)


def same_frames(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for name in names:
        x = np.load(os.path.join(a, name), allow_pickle=True)
        y = np.load(os.path.join(b, name), allow_pickle=True)
        assert sorted(x.files) == sorted(y.files)
        for k in y.files:
            assert x[k].dtype == y[k].dtype, k
            if y[k].dtype == object:
                for (nx, vx), (ny, vy) in zip(x[k], y[k]):
                    assert nx == ny
                    np.testing.assert_array_equal(vx, vy)
            else:
                np.testing.assert_array_equal(x[k], y[k], err_msg=f"{name} {k}")
    return names


@pytest.mark.parametrize("task", ["RoboPush", "RoboPegInHole"])
def test_generate_pc_equals_the_jax_packages(task, tmp_path, monkeypatch):
    make = gymnasium.make
    monkeypatch.setattr(gymnasium, "make", lambda *a, **k: SeededFirstReset(make(*a, **k), 3))
    with scenes_at(128, "Cube", "PegInHole"):
        jgenerate(str(tmp_path / "j"), f"{task}-v0", horizon=3, runs=2, seed=3)
        monkeypatch.setattr(gymnasium, "make", make)
        tgenerate(str(tmp_path / "t"), f"pointcloud_tpu_torch/{task}-v0", horizon=3, runs=2,
                  seed=3, device="cpu")
        if task == "RoboPegInHole":  # a task class, no gymnasium in the way
            tgenerate(str(tmp_path / "c"), RoboPegInHole, horizon=3, runs=2, seed=3,
                      device="cpu")
            same_frames(tmp_path / "c", tmp_path / "t")
    names = same_frames(tmp_path / "t", tmp_path / "j")
    assert len(names) == 6
    frame = np.load(tmp_path / "t" / "0.npz", allow_pickle=True)
    assert frame["points"].shape == (128, 3) and frame["segmentation"].shape == (128, 1)


def test_cli_synthetic_with_a_val_split(tmp_path):
    cli = root_module("generate_pc_torch")
    with scenes_at(128, "Table"):
        cli.main(["--dir", str(tmp_path / "t"), "--synthetic", "--scene", "Table",
                  "--horizon", "2", "--runs", "2", "--val_split", "0.25", "--device", "cpu",
                  "--show_distribution"])
        jdataset(str(tmp_path / "j" / "train"), scene="Table", frames=3, seed=0)
        jdataset(str(tmp_path / "j" / "val"), scene="Table", frames=1, seed=10_000)
    assert len(same_frames(tmp_path / "t" / "train", tmp_path / "j" / "train")) == 3
    assert len(same_frames(tmp_path / "t" / "val", tmp_path / "j" / "val")) == 1
    assert (tmp_path / "t" / "merged.npz_ignore").exists()
    assert (tmp_path / "t" / "distribution.png").exists()
