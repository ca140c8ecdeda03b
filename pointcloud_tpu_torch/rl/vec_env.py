"""Parallel GoalEnv stepping: subprocess + in-process vector environments
(port of pointcloud_tpu/rl/vec_env.py).

The reference trains its real policies with rl_zoo3's `--vec-env subproc
-params n_envs:4` (reference readme.md:86-89, rl/tqc.yml:224,243,262), i.e.
sb3's SubprocVecEnv. This module provides the same env-parallelism without
the sb3 dependency:

  * `SubprocVecGoalEnv` — one worker process per env, pipe protocol,
    sb3-style autoreset (done -> reset; the terminal observation is returned
    in `infos[i]["final_observation"]`). The batched observation dicts come
    back stacked, so the N per-env policy inferences become ONE call per
    step.
  * `DummyVecGoalEnv` — same API, envs stepped sequentially in-process
    (sb3's DummyVecEnv; useful for debugging and cheap envs).

Each worker builds its env on the device its env_fn names (`make_env`'s
default is the card): several processes share one card, and each loads the
kernel libraries already built under build/ (or builds them; the build's
atomic renames make a concurrent first use safe). Workers start under the
'spawn' context, which CUDA needs.
"""

from __future__ import annotations

import multiprocessing as mp
from typing import Callable, Sequence

import numpy as np

__all__ = ["SubprocVecGoalEnv", "DummyVecGoalEnv", "make_env"]


def make_env(env_id: str, max_episode_steps: int = 50, device="cuda", **kwargs):
    """Picklable registered-env constructor for subproc workers: use
    `functools.partial(make_env, "RoboReach-v0", max_episode_steps=50)` as an
    env_fn (closures don't pickle under the 'spawn' mp context).

    env_id: one of the sixteen ids, with or without the port's namespace
    (`RoboReach-v0` or `pointcloud_tpu_torch/RoboReach-v0`). The registration
    table's task class, with its sensor and encoder, on `device`, wrapped in
    envs.spaces' TimeLimit (gymnasium's where it is installed, else the
    stand-in; the GPU machine has no gymnasium), which truncates at
    max_episode_steps as gym.make of the registered id does. `kwargs` go to
    the task class over the table's (a sensor or encoder class replaces the
    registered one), as gym.make's do."""
    from pointcloud_tpu_torch.envs import registration, spaces

    task, task_kwargs = registration.env_table()[env_id.removeprefix(registration.NAMESPACE + "/")]
    return spaces.TimeLimit(task(device=device, **{**task_kwargs, **kwargs}),
                            max_episode_steps)


def _stack_obs(obs_list):
    return {k: np.stack([o[k] for o in obs_list]) for k in obs_list[0]}


def _vec_worker(remote, parent_remote, env_fn, seed0):
    """Worker loop: owns one GoalEnv, serves commands over the pipe."""
    parent_remote.close()
    env = env_fn()
    try:
        while True:
            cmd, data = remote.recv()
            if cmd == "reset":
                obs, info = env.reset(seed=data)
                remote.send((obs, info))
            elif cmd == "step":
                obs, rew, term, trunc, info = env.step(data)
                if term or trunc:
                    info = dict(info)
                    info["final_observation"] = obs
                    obs, _ = env.reset()
                remote.send((obs, float(rew), bool(term), bool(trunc), info))
            elif cmd == "spaces":
                remote.send((env.observation_space, env.action_space))
            elif cmd == "compute_reward":
                a, d = data
                remote.send(env.unwrapped.compute_reward(a, d, None))
            elif cmd == "close":
                env.close()
                remote.close()
                break
    except (KeyboardInterrupt, EOFError):
        env.close()


class SubprocVecGoalEnv:
    """N GoalEnvs in worker processes; batched numpy-dict observations.

    env_fns must be picklable under the chosen mp context (functools.partial
    of a module-level constructor / gym.make works; closures don't under
    'spawn'). API mirrors sb3's SubprocVecEnv restricted to the GoalEnv
    protocol: reset() -> (obs_dict (N, ...), infos), step(actions (N, A)) ->
    (obs, rewards (N,), terminated (N,), truncated (N,), infos).
    """

    def __init__(
        self,
        env_fns: Sequence[Callable],
        context: str = "spawn",
    ):
        self.num_envs = len(env_fns)
        ctx = mp.get_context(context)
        self.remotes, work_remotes = zip(
            *[ctx.Pipe(duplex=True) for _ in range(self.num_envs)]
        )
        self.processes = []
        for wr, r, fn in zip(work_remotes, self.remotes, env_fns):
            p = ctx.Process(
                target=_vec_worker, args=(wr, r, fn, None),
                daemon=True,
            )
            p.start()
            wr.close()
            self.processes.append(p)
        self.remotes[0].send(("spaces", None))
        self.observation_space, self.action_space = self.remotes[0].recv()
        self._closed = False

    def reset(self, seed: int | None = None):
        for i, r in enumerate(self.remotes):
            r.send(("reset", None if seed is None else seed + i))
        obs, infos = zip(*[r.recv() for r in self.remotes])
        return _stack_obs(obs), list(infos)

    def step(self, actions):
        actions = np.asarray(actions)
        for r, a in zip(self.remotes, actions):
            r.send(("step", a))
        obs, rews, terms, truncs, infos = zip(*[r.recv() for r in self.remotes])
        return (
            _stack_obs(obs),
            np.asarray(rews, np.float32),
            np.asarray(terms, bool),
            np.asarray(truncs, bool),
            list(infos),
        )

    def compute_reward(self, achieved, desired):
        self.remotes[0].send(("compute_reward", (achieved, desired)))
        return self.remotes[0].recv()

    def close(self):
        if self._closed:
            return
        for r in self.remotes:
            try:
                r.send(("close", None))
            except (BrokenPipeError, OSError):
                pass
        for p in self.processes:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
        self._closed = True

    def __del__(self):
        self.close()


class DummyVecGoalEnv:
    """Sequential in-process vector env with the SubprocVecGoalEnv API."""

    def __init__(self, env_fns: Sequence[Callable]):
        self.envs = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)
        self.observation_space = self.envs[0].observation_space
        self.action_space = self.envs[0].action_space

    def reset(self, seed: int | None = None):
        out = [
            e.reset(seed=None if seed is None else seed + i)
            for i, e in enumerate(self.envs)
        ]
        obs, infos = zip(*out)
        return _stack_obs(obs), list(infos)

    def step(self, actions):
        obs, rews, terms, truncs, infos = [], [], [], [], []
        for e, a in zip(self.envs, np.asarray(actions)):
            o, r, te, tr, info = e.step(a)
            if te or tr:
                info = dict(info)
                info["final_observation"] = o
                o, _ = e.reset()
            obs.append(o)
            rews.append(float(r))
            terms.append(bool(te))
            truncs.append(bool(tr))
            infos.append(info)
        return (
            _stack_obs(obs),
            np.asarray(rews, np.float32),
            np.asarray(terms, bool),
            np.asarray(truncs, bool),
            infos,
        )

    def compute_reward(self, achieved, desired):
        return self.envs[0].unwrapped.compute_reward(achieved, desired, None)

    def close(self):
        for e in self.envs:
            e.close()
