"""tqc.yml loader (a copy of pointcloud_tpu/rl/config.py): maps the
rl_zoo3-format entries onto tqc() kwargs. PyYAML is imported only when a
file is read; the GPU machine has none, so its callers pass the values as
arguments."""

from __future__ import annotations

import ast
import os
import re


def load_yaml_config(env_id: str, path: str | None = None) -> dict:
    import yaml

    path = path or os.path.join(os.path.dirname(__file__), "tqc.yml")
    with open(path) as f:
        cfg = yaml.safe_load(f)
    if env_id not in cfg:
        raise KeyError(f"{env_id} not in {path}")
    entry = cfg[env_id]

    policy_kwargs = _parse_dict_literal(entry.get("policy_kwargs", ""))
    replay_kwargs = _parse_dict_literal(entry.get("replay_buffer_kwargs", ""))

    net_arch = tuple(policy_kwargs.get("net_arch", (256, 256)))
    n_sampled = replay_kwargs.get("n_sampled_goal", 4)
    return {
        "total_timesteps": int(entry.get("n_timesteps", 100000)),
        "gamma": float(entry.get("gamma", 0.95)),
        "lr": float(entry.get("learning_rate", 1e-3)),
        "batch_size": int(entry.get("batch_size", 256)),
        "replay_size": int(entry.get("buffer_size", 1_000_000)),
        "polyak": 1.0 - float(entry.get("tau", 0.005)),
        "hidden": net_arch,
        "critic_hidden": net_arch,
        "n_critics": int(policy_kwargs.get("n_critics", 2)),
        "n_envs": int(entry.get("n_envs", 1)),
        "use_her": entry.get("replay_buffer_class") == "HerReplayBuffer",
        "her_strategy": replay_kwargs.get("goal_selection_strategy", "future"),
        "her_ratio": n_sampled / (n_sampled + 1),
    }


def _parse_dict_literal(s: str) -> dict:
    """Parse rl_zoo3's "dict(a=1, b='x')" strings safely."""
    if not s:
        return {}
    m = re.fullmatch(r"\s*dict\((.*)\)\s*", s, flags=re.S)
    if not m:
        return {}
    try:
        return ast.literal_eval("{" + re.sub(
            r"(\w+)\s*=", lambda g: f"'{g.group(1)}':", m.group(1)
        ) + "}")
    except Exception:
        return {}
