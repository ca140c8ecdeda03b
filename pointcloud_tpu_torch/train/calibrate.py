"""Latent success-threshold calibration (port of
pointcloud_tpu/train/calibrate.py; reference:
pointcloud_vision/calibrate_latent.py:28-170).

Runs a pretrained GT policy in a vision env, records the per-dim latent
distance |goal_encoding - achieved| right before the first GT-success and
during success, and sets

    threshold = (1 - s) * mean(before_success) + s * mean(during_success)

which check_success consults for latent encoders (base_env check_success).
The threshold is saved to the encoder's metadata sidecar. The policy is a
predict()-protocol object; loading one from a path needs the RL port
(rl.policy.load_policy), which is not here yet.
"""

from __future__ import annotations

import numpy as np

from pointcloud_tpu_torch.envs.encoders import PassthroughEncoder


def latent_distributions(
    vision_task: str,
    policy,
    horizon: int = 50,
    runs: int = 50,
    threshold_strictness: float = 0.3,
    render: bool = False,
    show_progress: bool = False,
    save: bool = True,
    env=None,
    device="cuda",
):
    """Calibrate the latent threshold of `vision_task`'s encoder.

    vision_task: a registered env id of the port (e.g.
    'pointcloud_tpu_torch/VisionReach-v0', made on `device`; needs
    gymnasium), unused when `env` is given. policy: a predict()-protocol
    object; a path raises NotImplementedError until the RL port brings
    rl.policy.load_policy. Returns (threshold, all_before_succ, all_dists).
    """
    if isinstance(policy, str):
        raise NotImplementedError(
            "a policy given as a path needs rl.policy.load_policy, which the "
            "port does not have yet (ROADMAP Queue 1 item 15); pass an object "
            "with predict(obs, deterministic=True) -> (action, state)"
        )
    if env is None:
        import gymnasium as gym

        import pointcloud_tpu_torch  # noqa: F401  (registers the envs)

        env = gym.make(
            vision_task,
            render_mode="human" if render else None,
            max_episode_steps=horizon,
            device=device,
        )

    base = env.unwrapped
    if base.encoder.latent_threshold is None:
        print("latent_threshold is None, setting to 0")
        base.encoder.latent_threshold = np.zeros(
            base.encoder.get_goal_space(base.backend).shape
        )

    gt_encoder = PassthroughEncoder(
        env=base, obs_keys=base.encoder.obs_keys, goal_keys=base.encoder.goal_keys
    )

    all_dists, all_before_succ = [], []

    for i in range(runs):
        obs, info = env.reset()
        gt_goal = gt_encoder.encode_goal(base.goal_state)
        gt_obs, gt_achieved = gt_encoder(base.raw_state)
        success = base.check_success(gt_achieved, gt_goal, info=info, force_gt=True)
        if success:
            print("WARNING: success right after reset!")
        dist = np.abs(base.goal_encoding - base.achieved)

        zero = np.zeros_like(base.goal_encoding)
        dist_sum, dist_count = zero.copy(), 0
        before_sum, before_count = zero.copy(), 0

        for t in range(horizon):
            gt = {
                "observation": np.concatenate(
                    (base.proprioception, gt_obs), dtype=np.float32
                ),
                "achieved_goal": gt_achieved,
                "desired_goal": gt_goal,
            }
            action, _ = policy.predict(gt, deterministic=True)
            obs, reward, terminated, truncated, info = env.step(action)

            gt_obs, gt_achieved = gt_encoder(base.observation)
            succ_prev = success
            success = base.check_success(
                gt_achieved, gt_goal, info=info, force_gt=True
            )
            if success:
                if not succ_prev:  # first success this episode
                    before_sum += dist
                    before_count += 1
                dist = np.abs(base.goal_encoding - base.achieved)
                dist_sum += dist
                dist_count += 1

            if show_progress:
                print(
                    ("#" * round((i * horizon + t) / (horizon * runs) * 100)).ljust(
                        100, "-"
                    ),
                    end="\r",
                )

        if before_count > 0:
            all_before_succ.append(before_sum / before_count)
        if dist_count > 0:
            all_dists.append(dist_sum / dist_count)
        else:
            print("WARNING: the policy failed in episode", i)

    if show_progress:
        print("\ndone")

    if all_before_succ:
        all_before_succ = np.stack(all_before_succ)
    if all_dists:
        all_dists = np.stack(all_dists)

    if len(all_before_succ) > 0 and len(all_dists) > 0:
        threshold = (1 - threshold_strictness) * all_before_succ.mean(
            axis=0
        ) + threshold_strictness * all_dists.mean(axis=0)
    else:
        print("Warning: No data to calculate threshold")
        threshold = None

    if threshold is not None and save:
        base.encoder.save_latent_threshold(threshold, all_before_succ, all_dists)

    env.close()
    return threshold, all_before_succ, all_dists
