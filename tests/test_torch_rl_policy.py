"""Policy files across the two packages (pointcloud_tpu_torch/rl/policy.py,
TQC.save, ddpg._save) on the CPU.

- A .pkl written by the JAX package's TQC.save or ddpg._save loads through
  the port's load_policy (no JAX needed: its leaves are numpy arrays in the
  flax layout) and acts as the JAX policy does, within 1e-6 of the largest
  action entry; the pickle references nothing of JAX.
- A .pkl written by the port loads in the JAX package's load_policy and
  acts the same, to the same bound.
- A .pth holding a whole policy module (what export_policy writes) loads
  (torch.load with weights_only=False), and an sb3 zip's policy.pth
  state_dict acts as the JAX package's numpy reader of it does, within 1e-6
  of the largest action entry (the port's reader runs the actor in torch on
  the device asked for); a zip without policy.pth and an unknown suffix
  raise.
"""

import io
import pickle
import pickletools
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_utils  # noqa: F401  (one torch thread per worker)

from pointcloud_tpu.rl import core as jcore
from pointcloud_tpu.rl.ddpg import _save as jsave
from pointcloud_tpu.rl.policy import Sb3TqcPolicy as JSb3
from pointcloud_tpu.rl.policy import load_policy as jload
from pointcloud_tpu.rl.tqc import TQC as JTQC
from pointcloud_tpu_torch.rl import core as tcore
from pointcloud_tpu_torch.rl.ddpg import _save as tsave
from pointcloud_tpu_torch.rl.policy import ActorPolicy, TorchPolicyWrapper, load_policy
from pointcloud_tpu_torch.rl.tqc import TQC as TTQC

OBS, GOAL, ACT = 5, 3, 4


def observations(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [{"observation": rng.standard_normal(OBS).astype(np.float32),
             "achieved_goal": rng.standard_normal(GOAL).astype(np.float32),
             "desired_goal": rng.standard_normal(GOAL).astype(np.float32)} for _ in range(n)]


def same_actions(a, b, tol=1e-6):
    for obs in observations():
        x, _ = a.predict(obs, deterministic=True)
        y, _ = b.predict(obs, deterministic=True)
        assert x.shape == y.shape == (ACT,) and x.dtype == np.float32
        assert np.abs(x - y).max() <= tol * np.abs(y).max(), (x, y)


def globals_of(path):
    """Every module a pickle file names."""
    with open(path, "rb") as f:
        ops = list(pickletools.genops(f.read()))
    names = [arg for op, arg, _ in ops if op.name in ("GLOBAL", "SHORT_BINUNICODE",
                                                     "BINUNICODE", "UNICODE")]
    return {n.split(" ")[0] for n in names if isinstance(n, str) and "." in n
            and n.split(".")[0] in ("numpy", "jax", "jaxlib", "flax", "torch")}


@pytest.mark.parametrize("hidden", [(16, 16), (64, 64)])
def test_jax_tqc_pickle_loads_and_acts_the_same(tmp_path, hidden):
    actor = jcore.SquashedGaussianActor(ACT, 1.0, hidden)
    params = actor.init(jax.random.PRNGKey(1), jnp.zeros((1, OBS + GOAL)))
    jpol = JTQC(actor, params, 1.0)
    path = str(tmp_path / "policy.pkl")
    jpol.save(path)
    assert not {m for m in globals_of(path) if not m.startswith("numpy")}
    tpol = load_policy(path, device="cpu")
    assert isinstance(tpol, TTQC)
    same_actions(tpol, jpol)


def test_jax_ddpg_pickle_loads_and_acts_the_same(tmp_path):
    actor = jcore.Actor(ACT, 2.0, (32, 32))
    params = actor.init(jax.random.PRNGKey(2), jnp.zeros((1, OBS + GOAL)))
    path = str(tmp_path / "ddpg.pkl")
    jsave(path, params, actor)
    tpol = load_policy(path, device="cpu")
    assert isinstance(tpol, ActorPolicy)
    same_actions(tpol, jload(path))


@pytest.mark.parametrize("kind", ["tqc", "ddpg"])
def test_port_pickle_loads_in_the_jax_package(tmp_path, kind):
    gen = torch.Generator().manual_seed(3)
    path = str(tmp_path / f"{kind}.pkl")
    if kind == "tqc":
        actor = tcore.init_params(tcore.SquashedGaussianActor(OBS + GOAL, ACT, 1.0, (24, 24)),
                                  gen)
        live = TTQC(actor, 1.0)
        live.save(path)
    else:
        actor = tcore.init_params(tcore.Actor(OBS + GOAL, ACT, 1.0, (24, 24)), gen)
        live = ActorPolicy(actor, 1.0)
        tsave(path, actor)
    assert not {m for m in globals_of(path) if not m.startswith("numpy")}
    same_actions(jload(path), live)
    same_actions(load_policy(path, device="cpu"), live, tol=0.0)


class DictPolicy(torch.nn.Module):
    """A stand-in for an exported sb3 policy: forward(obs dict,
    deterministic) -> actions."""

    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(OBS + 2 * GOAL, ACT)

    def forward(self, obs, deterministic=True):
        x = torch.cat([obs[k] for k in sorted(obs)], dim=-1)
        return torch.tanh(self.lin(x)), None


def test_whole_module_pth_loads(tmp_path):
    torch.manual_seed(0)
    module = DictPolicy()
    path = str(tmp_path / "policy.pth")
    torch.save(module, path)
    with pytest.raises(pickle.UnpicklingError):  # torch's default refuses a module
        torch.load(path, map_location="cpu")
    pol = load_policy(path, device="cpu")
    assert isinstance(pol, TorchPolicyWrapper)
    same_actions(pol, TorchPolicyWrapper(module), tol=0.0)


def test_sb3_zip_state_dict_acts_as_the_jax_reader(tmp_path):
    rng = np.random.default_rng(4)
    dims = [OBS + 2 * GOAL, 32, 32]
    sd = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        sd[f"actor.latent_pi.{2 * i}.weight"] = torch.from_numpy(
            (rng.standard_normal((b, a)) / np.sqrt(a)).astype(np.float32))
        sd[f"actor.latent_pi.{2 * i}.bias"] = torch.zeros(b)
    sd["actor.mu.weight"] = torch.from_numpy(rng.standard_normal((ACT, 32)).astype(np.float32))
    sd["actor.mu.bias"] = torch.zeros(ACT)
    buf = io.BytesIO()
    torch.save(sd, buf)
    path = str(tmp_path / "model.zip")
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("policy.pth", buf.getvalue())
        z.writestr("data", "{}")
    same_actions(load_policy(path, device="cpu"), JSb3.load(path), tol=1e-6)
    with zipfile.ZipFile(str(tmp_path / "bad.zip"), "w") as z:
        z.writestr("data", "{}")
    with pytest.raises(ValueError, match="not an sb3 save"):
        load_policy(str(tmp_path / "bad.zip"), device="cpu")
    with pytest.raises(ValueError, match="unknown policy format"):
        load_policy(str(tmp_path / "policy.onnx"), device="cpu")
