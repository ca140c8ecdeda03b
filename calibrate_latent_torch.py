#!/usr/bin/env python
"""CLI for latent-threshold calibration with the PyTorch port (mirror of
calibrate_latent.py; reference: calibrate_latent.py:123-170).

The env comes from rl.vec_env.make_env (no gymnasium needed) and the policy
from rl.policy.load_policy, both on --device (default cuda; --device cpu
runs on the CPU). --show_distribution plots with matplotlib, which the
calibration itself does not need.

Usage: python calibrate_latent_torch.py VisionReach-v0 path/to/policy.pkl
       [--horizon 50] [--runs 100] [--threshold_strictness 0.3] [--render]
       [--no_save] [--show_distribution] [--device cuda]
"""

import argparse


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("vision_task", type=str)
    parser.add_argument("policy_dir", type=str)
    parser.add_argument("--horizon", type=int, default=50)
    parser.add_argument("--runs", type=int, default=100)
    parser.add_argument("--threshold_strictness", type=float, default=0.3)
    parser.add_argument("--render", action="store_true")
    parser.add_argument("--no_save", action="store_true")
    parser.add_argument("--show_distribution", action="store_true",
                        help="plot per-dim histograms of the latent distances")
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device of the env's sensor, encoder and policy")
    a = parser.parse_args()

    from pointcloud_tpu_torch.rl.vec_env import make_env
    from pointcloud_tpu_torch.train.calibrate import latent_distributions

    if a.show_distribution:
        from pointcloud_tpu_torch.viewers import require_matplotlib

        require_matplotlib()  # before the rollouts, not after them
    env = make_env(a.vision_task, max_episode_steps=a.horizon, device=a.device,
                   render_mode="human" if a.render else None)
    threshold, before, during = latent_distributions(
        a.vision_task,
        a.policy_dir,
        horizon=a.horizon,
        runs=a.runs,
        threshold_strictness=a.threshold_strictness,
        render=a.render,
        show_progress=True,
        save=not a.no_save,
        env=env,
        device=a.device,
    )
    print("threshold =", threshold)

    if a.show_distribution and threshold is not None:
        import matplotlib.pyplot as plt

        dims = threshold.shape[0]
        fig, axes = plt.subplots(1, dims, figsize=(3 * dims, 3), squeeze=False)
        for d in range(dims):
            ax = axes[0, d]
            ax.hist(before[:, d], bins=20, alpha=0.5, label="before success")
            ax.hist(during[:, d], bins=20, alpha=0.5, label="during success")
            ax.axvline(threshold[d], color="k", linestyle="--")
            ax.set_title(f"dim {d}")
        axes[0, 0].legend()
        plt.tight_layout()
        plt.show()


if __name__ == "__main__":
    main()
