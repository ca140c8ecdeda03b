#!/usr/bin/env python
"""Generate point-cloud training data with the PyTorch port.

    python generate_pc_torch.py --dir input/Cube/train --synthetic --scene Cube \
        --horizon 50 --runs 4 [--val_split 0.2] [--device cuda|cpu]

Two sources:
  --synthetic      the kinematic synthetic scenes (no robosuite needed)
  (default)        a registered env of the port (e.g.
                   pointcloud_tpu_torch/RoboPush-v0) rolled with random
                   actions; without robosuite it runs the synthetic backend

Every frame's sensor chain (FilterBBox, then FPS to the scene's point
budget) runs on --device (default cuda; a card is required for it). Writes
one .npz per frame with the reference contract: points / rgb /
segmentation / boundingbox / ground_truth / classes. Imports nothing of
JAX.
"""

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description="Generate point cloud dataset")
    parser.add_argument("--dir", type=str, required=True, help="output directory")
    parser.add_argument("--env", type=str, default="pointcloud_tpu_torch/RoboPush-v0")
    parser.add_argument("--scene", type=str, default="Cube",
                        help="scene name for --synthetic")
    parser.add_argument("--synthetic", action="store_true",
                        help="use the robosuite-free synthetic scenes")
    parser.add_argument("--horizon", type=int, default=50, help="frames per run")
    parser.add_argument("--runs", type=int, default=4)
    parser.add_argument("--actions_per_frame", type=int, default=1)
    parser.add_argument("--action_scale", type=float, default=1.0)
    parser.add_argument("--steps_per_action", type=int, default=1)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--val_split", type=float, default=0.0,
                        help="if >0, also write a val/ split alongside train/ "
                             "(--synthetic)")
    parser.add_argument("--show_distribution", action="store_true",
                        help="merge all frames into a distribution cloud "
                             "(saved as merged.npz_ignore) and plot it to "
                             "distribution.png (needs matplotlib)")
    parser.add_argument("--device", default="cuda",
                        help="device of the sensor chain (cuda or cpu)")
    a = parser.parse_args(argv)

    frames = a.horizon * a.runs
    if a.synthetic:
        from pointcloud_tpu_torch.envs.synthetic import generate_dataset

        if a.val_split > 0:
            n_val = max(1, int(frames * a.val_split))
            generate_dataset(os.path.join(a.dir, "train"), scene=a.scene,
                             frames=frames - n_val, seed=a.seed, device=a.device)
            generate_dataset(os.path.join(a.dir, "val"), scene=a.scene,
                             frames=n_val, seed=a.seed + 10_000, device=a.device)
        else:
            generate_dataset(a.dir, scene=a.scene, frames=frames, seed=a.seed,
                             device=a.device)
        print(f"wrote {frames} synthetic frames to {a.dir}")
    else:
        from pointcloud_tpu_torch.data.generate import generate_pc

        generate_pc(
            a.dir,
            a.env,
            horizon=a.horizon,
            runs=a.runs,
            actions_per_frame=a.actions_per_frame,
            action_scale=a.action_scale,
            steps_per_action=a.steps_per_action,
            seed=a.seed,
            device=a.device,
        )

    if a.show_distribution:
        show_distribution(a.dir)


def show_distribution(root: str):
    """Merge every generated frame into one distribution cloud with GT
    markers and plot it (reference generate_pc.py:79-98; the merged cloud is
    saved with an .npz_ignore suffix so datasets skip it)."""
    import glob

    import numpy as np

    files = sorted(glob.glob(os.path.join(root, "**", "*.npz"), recursive=True))
    if not files:
        print("no frames found under", root)
        return
    all_points, all_gt = [], []
    for f in files:
        data = np.load(f, allow_pickle=True)
        all_points.append(np.concatenate([data["points"], data["rgb"]], axis=1))
        for _, value in data["ground_truth"]:
            v = np.asarray(value)
            if v.shape == (3,):
                all_gt.append(np.concatenate([v, [1, 0, 0]]))
    merged = np.concatenate(all_points)
    gt = np.asarray(all_gt, dtype=np.float32).reshape(-1, 6)
    print("all points gathered", merged.shape)
    with open(os.path.join(root, "merged.npz_ignore"), "wb") as f:
        np.savez(f, points=merged, gt=gt)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    sel = np.random.default_rng(0).choice(len(merged), size=min(len(merged), 20000),
                                          replace=False)
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    for pc, name in ((merged[sel], "distribution"), (gt, "ground truth")):
        ax.scatter(pc[:, 0], pc[:, 1], pc[:, 2], c=np.clip(pc[:, 3:6], 0, 1), s=2,
                   label=name)
    ax.set_title(f"{root} ({len(files)} frames)")
    ax.legend()
    fig.savefig(os.path.join(root, "distribution.png"))
    plt.close(fig)


if __name__ == "__main__":
    main()
