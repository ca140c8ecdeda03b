"""Policy loading across formats (port of pointcloud_tpu/rl/policy.py).

`load_policy(path, device='cuda')` dispatches:
  *.pkl  — TQC / DDPG policies (rl/tqc.py save format: flax-layout numpy
           params and a config; the JAX package writes the same pickle, and
           its files load here without JAX), on `device`
  *.zip  — sb3_contrib TQC MultiInputPolicy (if sb3_contrib is installed;
           the reference's rl_zoo3 artifacts, readme.md:79-94), else its
           actor read from the zip's state_dict
  *.pth  — a torch policy extracted by export_policy (reference
           rl/export_policy.py:11-26)

Every format's policy runs on `device`. All return objects with
`predict(obs_dict, deterministic=True) -> (action, state)`.
"""

from __future__ import annotations

import numpy as np
import torch

from pointcloud_tpu_torch.utils import resolve_device


class TorchPolicyWrapper:
    """Wraps an exported torch policy module into the predict protocol; the
    observation goes to the device of the module's parameters."""

    def __init__(self, policy):
        self.policy = policy

    def predict(self, obs_dict, deterministic: bool = True, state=None, **kw):
        dev = next(self.policy.parameters()).device
        with torch.no_grad():
            obs = {
                k: torch.as_tensor(np.asarray(v)[None], dtype=torch.float32, device=dev)
                for k, v in obs_dict.items()
            }
            act = self.policy(obs, deterministic=deterministic)
            if isinstance(act, tuple):
                act = act[0]
        return act.cpu().numpy()[0], state


class ActorPolicy:
    """predict()-protocol wrapper over a deterministic actor module (the
    JAX package's JaxPolicy over a jitted actor apply)."""

    def __init__(self, actor, act_limit):
        self.actor = actor
        self.act_limit = act_limit

    @torch.no_grad()
    def predict(self, obs_dict, deterministic: bool = True, state=None, **kw):
        o = np.concatenate(
            [np.asarray(obs_dict["observation"]).reshape(-1),
             np.asarray(obs_dict["desired_goal"]).reshape(-1)],
            dtype=np.float32,
        )
        dev = next(self.actor.parameters()).device
        a = self.actor(torch.from_numpy(o[None]).to(dev))[0].cpu().numpy()
        return np.clip(a, -self.act_limit, self.act_limit), state


def _load_pkl(path: str, device="cuda"):
    import pickle

    from pointcloud_tpu_torch.interop import load_flax_variables

    with open(path, "rb") as f:
        payload = pickle.load(f)
    cfg = payload["config"]
    actor_type = cfg.get("actor_type", "squashed_gaussian")
    if actor_type == "deterministic":
        from pointcloud_tpu_torch.rl.core import Actor

        in_dim = np.shape(payload["pi"]["params"]["MLP_0"]["Dense_0"]["kernel"])[0]
        actor = Actor(in_dim, cfg["act_dim"], cfg["act_limit"], cfg["hidden"])
        load_flax_variables(actor, payload["pi"])
        return ActorPolicy(actor.to(resolve_device(device)), cfg["act_limit"])
    from pointcloud_tpu_torch.rl.tqc import TQC

    return TQC.load(path, device=device)


class Sb3TqcPolicy:
    """Deterministic actor of an sb3_contrib/rl_zoo3 TQC zip, loaded
    WITHOUT stable-baselines3 installed.

    sb3 saves a zip containing `policy.pth` (a torch state_dict). The TQC
    MultiInputPolicy actor is: CombinedExtractor (flatten + concat of the
    dict observation in sorted-key order, the gym.spaces.Dict convention) ->
    `actor.latent_pi` (Linear/ReLU stack) -> `actor.mu` -> tanh squash.
    Deterministic predict() is exactly that forward pass, run on the device
    of the state_dict tensors (reference artifacts: the reference's
    rl/export_policy.py:11-26, readme.md:79-94).
    """

    def __init__(self, hidden, mu, act_limit: float = 1.0):
        self.hidden = hidden  # [(W, b), ...] of actor.latent_pi
        self.mu = mu  # (W, b) of actor.mu
        self.act_limit = act_limit

    @classmethod
    def load(cls, path: str, act_limit: float = 1.0, device="cuda"):
        import io
        import zipfile

        with zipfile.ZipFile(path) as z:
            names = z.namelist()
            if "policy.pth" not in names:
                raise ValueError(
                    f"{path} is not an sb3 save (no policy.pth; has {names})"
                )
            # a state_dict of tensors: the safe unpickler suffices
            sd = torch.load(
                io.BytesIO(z.read("policy.pth")), map_location=resolve_device(device),
                weights_only=True,
            )
        if hasattr(sd, "state_dict"):  # a full module was saved
            sd = sd.state_dict()
        sd = {k: v.float() for k, v in sd.items()}  # the actor runs in fp32
        hidden = []
        i = 0
        while f"actor.latent_pi.{i}.weight" in sd:
            hidden.append(
                (sd[f"actor.latent_pi.{i}.weight"], sd[f"actor.latent_pi.{i}.bias"])
            )
            i += 2  # Linear layers interleaved with activations
        if not hidden or "actor.mu.weight" not in sd:
            raise ValueError(
                f"{path}: no TQC actor tensors found (keys: {sorted(sd)[:8]}...)"
            )
        return cls(hidden, (sd["actor.mu.weight"], sd["actor.mu.bias"]), act_limit)

    @torch.no_grad()
    def predict(self, obs_dict, deterministic: bool = True, state=None, **kw):
        x = np.concatenate(
            [np.asarray(obs_dict[k], dtype=np.float32).reshape(-1)
             for k in sorted(obs_dict)]
        )
        x = torch.from_numpy(x).to(self.mu[0].device)
        for W, b in self.hidden:
            x = torch.relu(W @ x + b)
        a = torch.tanh(self.mu[0] @ x + self.mu[1])
        return (a * self.act_limit).cpu().numpy(), state


def load_policy(path: str, device="cuda"):
    """The predict()-protocol policy saved at `path`, running on `device`."""
    if path.endswith(".pkl"):
        return _load_pkl(path, device)
    if path.endswith(".zip"):
        try:
            from sb3_contrib.tqc.policies import MultiInputPolicy

            return MultiInputPolicy.load(path, device=str(resolve_device(device)))
        except ImportError:
            return Sb3TqcPolicy.load(path, device=device)
    if path.endswith(".pth"):
        # export_policy saves the whole policy module (torch.save(model.policy)),
        # which torch >= 2.6's default weights_only=True refuses to unpickle;
        # such a file runs code when loaded, so load only files you trust.
        return TorchPolicyWrapper(
            torch.load(path, map_location=resolve_device(device), weights_only=False))
    raise ValueError(f"unknown policy format: {path}")
