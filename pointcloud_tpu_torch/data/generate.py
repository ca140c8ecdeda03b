"""Dataset generation from a live vision environment (port of
pointcloud_tpu/data/generate.py; reference:
pointcloud_vision/generate_pc.py:12-101).

Rolls a GoalEnv of the port with random actions, randomizing
non-controlled state each frame, and saves per-frame npz observations with
the reference contract. Works with any backend exposing the
RobosuiteGoalEnv API (robosuite or the synthetic backend); for a
backend-free path use envs/synthetic.py:generate_dataset.
"""

from __future__ import annotations

import os

import numpy as np


def generate_pc(
    out_dir: str,
    env_id,
    horizon: int = 50,
    runs: int = 4,
    actions_per_frame: int = 1,
    action_scale: float = 1.0,
    steps_per_action: int = 1,
    render: bool = False,
    seed: int = 0,
    device="cuda",
):
    """Roll `env_id` and write horizon*runs npz frames into out_dir.

    env_id: a registered env id of the port (e.g.
    'pointcloud_tpu_torch/RoboPush-v0'; needs gymnasium) or a task class
    (envs.envs.RoboPush, ...), built with the PointCloudSensor on `device`.
    `seed` seeds the actions and the first reset (goals and randomize), so
    the frames are reproducible; the JAX function leaves the env's own draws
    unseeded.
    """
    from pointcloud_tpu_torch.vision.pc_sensor import PointCloudSensor

    os.makedirs(out_dir, exist_ok=True)
    kwargs = dict(sensor=PointCloudSensor, render_mode="human" if render else None,
                  require_segmentation=True, device=device)
    if isinstance(env_id, str):
        import gymnasium as gym

        import pointcloud_tpu_torch  # noqa: F401  (registers the envs)

        env = gym.make(env_id, max_episode_steps=horizon, **kwargs)
    else:
        env = env_id(**kwargs)
    base = env.unwrapped
    gt_states = [s for s in base.states if s]
    rng = np.random.default_rng(seed)

    total_steps = horizon * runs
    step = 0
    for run in range(runs):
        env.reset(seed=seed if run == 0 else None)
        for _ in range(horizon):
            base.randomize()
            for _ in range(actions_per_frame):
                action = (
                    rng.uniform(-1, 1, env.action_space.shape).astype(np.float32)
                    * action_scale
                )
                for _ in range(steps_per_action):
                    env.step(action)

            obs = dict(base.observation)
            for k in base.raw_state:
                obs.pop(k, None)
            obs = {k: np.asarray(v) for k, v in obs.items()}

            ground_truth = np.array(
                [(s, base.raw_state[s]) for s in gt_states], dtype=object
            )
            classes = np.array(
                [(n, c) for n, c in zip(base.classes, base.class_colors)], dtype=object
            )
            np.savez(
                os.path.join(out_dir, f"{step}.npz"),
                ground_truth=ground_truth,
                classes=classes,
                **obs,
            )
            step += 1
            print(("#" * round(step / total_steps * 100)).ljust(100, "-"), end="\r")
    print("\ndone")
    env.close()
    return out_dir
