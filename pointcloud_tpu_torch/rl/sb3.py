"""Policy rollout with GT-vs-vision success bookkeeping (a copy of
pointcloud_tpu/rl/sb3.py; reference: rl/sb3.py:33-38): run a policy on a
(vision) env while scoring episodes against the ground-truth success
checker, to quantify how much the vision encoding degrades the policy."""

from __future__ import annotations

import numpy as np


def rollout(env, policy, episodes: int = 10, horizon: int = 50, rng=None):
    """Returns dict with mean/median reward, believed and actual success."""
    rng = rng or np.random.default_rng(0)
    rewards, believed, actual = [], [], []
    for _ in range(episodes):
        obs, info = env.reset(seed=int(rng.integers(1 << 30)))
        total = 0.0
        for _ in range(horizon):
            if policy is None:
                action = env.action_space.sample()
            else:
                action, _ = policy.predict(obs, deterministic=True)
            obs, reward, terminated, truncated, info = env.step(action)
            total += float(reward)
            if terminated or truncated:
                break
        rewards.append(total)
        believed.append(float(info.get("is_success", False)))
        actual.append(float(env.unwrapped.actual_success))
    return {
        "episodes": episodes,
        "mean_reward": float(np.mean(rewards)),
        "median_reward": float(np.median(rewards)),
        "success_rate": float(np.mean(believed)),
        "actual_success_rate": float(np.mean(actual)),
    }
