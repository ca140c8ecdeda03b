"""Replay buffer + HER relabeling (a copy of pointcloud_tpu/rl/buffers.py;
reference: rl/agent.py:12-41, 296-474).

Dict-goal-aware ring buffer storing (obs, achieved, desired, action, reward,
next_obs, next_achieved, done) as flat numpy arrays. `her_sample` implements
'future-k' goal relabeling (the rl_zoo3 HerReplayBuffer configuration the
reference trains with, rl/tqc.yml: goal_selection_strategy future, n=4); the
reference's in-repo her() uses final-state relabeling, available via
strategy='final'.
"""

from __future__ import annotations

import numpy as np


class ReplayBuffer:
    """Uniform ring buffer over GoalEnv transitions (rl/agent.py:12-41)."""

    def __init__(self, obs_dim, goal_dim, act_dim, size):
        self.obs = np.zeros((size, obs_dim), np.float32)
        self.next_obs = np.zeros((size, obs_dim), np.float32)
        self.achieved = np.zeros((size, goal_dim), np.float32)
        self.next_achieved = np.zeros((size, goal_dim), np.float32)
        self.desired = np.zeros((size, goal_dim), np.float32)
        self.act = np.zeros((size, act_dim), np.float32)
        self.rew = np.zeros(size, np.float32)
        self.done = np.zeros(size, np.float32)
        # episode bookkeeping for HER future-sampling
        self.ep_start = np.zeros(size, np.int64)
        self.ep_end = np.zeros(size, np.int64)
        self.ptr, self.size, self.max_size = 0, 0, size
        self._ep_begin = 0

    def store(self, obs, achieved, desired, act, rew, next_obs, next_achieved, done):
        i = self.ptr
        self.obs[i] = obs
        self.achieved[i] = achieved
        self.desired[i] = desired
        self.act[i] = act
        self.rew[i] = rew
        self.next_obs[i] = next_obs
        self.next_achieved[i] = next_achieved
        self.done[i] = done
        self.ep_start[i] = self._ep_begin
        self.ptr = (self.ptr + 1) % self.max_size
        self.size = min(self.size + 1, self.max_size)

    def end_episode(self):
        """Mark the episode boundary; backfills ep_end for HER future-k."""
        end = self.ptr
        i = self._ep_begin
        while i != end:
            self.ep_end[i] = end if end > i else end + self.max_size
            i = (i + 1) % self.max_size
        self._ep_begin = end

    def sample(self, batch_size, rng: np.random.Generator):
        idx = rng.integers(0, self.size, size=batch_size)
        return {
            "obs": self.obs[idx],
            "achieved": self.achieved[idx],
            "desired": self.desired[idx],
            "act": self.act[idx],
            "rew": self.rew[idx],
            "next_obs": self.next_obs[idx],
            "next_achieved": self.next_achieved[idx],
            "done": self.done[idx],
            "idx": idx,
        }


def her_sample(
    buffer: ReplayBuffer,
    batch_size: int,
    rng: np.random.Generator,
    reward_fn,
    strategy: str = "future",
    her_ratio: float = 0.8,
):
    """Sample a batch with HER goal relabeling.

    strategy 'future': relabel with the achieved goal of a random LATER step
    in the same episode (rl_zoo3 future-4 semantics — her_ratio 0.8 == 4 of
    5 virtual transitions); 'final': the episode's last achieved goal
    (reference rl/agent.py her(), :296-474).
    reward_fn(achieved, desired) -> reward, vectorized.
    """
    batch = buffer.sample(batch_size, rng)
    idx = batch.pop("idx")
    relabel = rng.random(batch_size) < her_ratio
    desired = batch["desired"].copy()

    ends = buffer.ep_end[idx]
    starts = idx
    for b in np.nonzero(relabel)[0]:
        i, end = int(starts[b]), int(ends[b])
        if end <= i:  # degenerate/unfinished episode: skip relabeling
            continue
        if strategy == "final":
            j = (end - 1) % buffer.max_size
        else:  # future
            j = int(rng.integers(i, end)) % buffer.max_size
        desired[b] = buffer.next_achieved[j]

    batch["desired"] = desired
    batch["rew"] = reward_fn(batch["next_achieved"], desired).astype(np.float32)
    return batch
