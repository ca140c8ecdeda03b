#!/usr/bin/env python
"""Live reconstruction viewer of the PyTorch port: roll a vision env (random
or policy actions) and view the encoder's reconstruction against the live
sensed cloud each step (mirror of live_ae_viewer.py; reference
live_ae_viewer.py:16-194).

The env comes from rl.vec_env.make_env (no gymnasium needed), the policy
from rl.policy.load_policy, the model from the port's checkpoints under
--output_root, all on --device (default cuda; --device cpu on the CPU).
--save_dir writes one PNG a step headlessly (matplotlib); --interactive
opens a matplotlib window.

Usage: python live_ae_viewer_torch.py VisionPush-v0 --model Autoencoder
       [--backbone PointNet2] [--policy policy.pkl] [--steps 10]
       [--save_dir frames/] [--mode overlap] [--device cuda]
"""

import argparse
import os

import numpy as np

from pointcloud_tpu_torch import cfg


def main():
    p = argparse.ArgumentParser()
    p.add_argument("env", type=str)
    p.add_argument("--model", default="Autoencoder", choices=cfg.models)
    p.add_argument("--backbone", default="PointNet2", choices=cfg.encoder_backbones)
    p.add_argument("--policy", default="", type=str)
    p.add_argument("--gt_policy", action="store_true",
                   help="feed the policy GT observations (reference gt_policy mode)")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--mode", default="overlap", choices=["overlap", "side-by-side"])
    p.add_argument("--save_dir", default=None,
                   help="headless: save one PNG per step here (no window)")
    p.add_argument("--interactive", action="store_true",
                   help="live window with the reference's key toggles: "
                        "i = input cloud, o = reconstruction, v = markers, "
                        "m = overlap/side-by-side (live_ae_viewer.py:16-194)")
    p.add_argument("--output_root", default="output")
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device of the env's sensor and encoder, the model "
                        "and the policy")
    a = p.parse_args()

    from pointcloud_tpu_torch.data.dataset import obs_to_pc
    from pointcloud_tpu_torch.envs.encoders import PassthroughEncoder
    from pointcloud_tpu_torch.envs.scenes import cfg_scene
    from pointcloud_tpu_torch.rl.vec_env import make_env
    from pointcloud_tpu_torch.transforms import Normalize, apply_np
    from pointcloud_tpu_torch.viewers import check_plotting, require_matplotlib
    from pointcloud_tpu_torch.viewers.plot import show_clouds
    from pointcloud_tpu_torch.viewers.reconstruct import (
        assemble_prediction,
        load_viewer_model,
    )

    if a.interactive and not a.save_dir:
        require_matplotlib()
    else:
        check_plotting(a.save_dir)
    env = make_env(a.env, max_episode_steps=a.steps + 1, device=a.device)
    base = env.unwrapped
    spec, _ = load_viewer_model(
        base.scene, a.model, a.backbone, output_root=a.output_root, device=a.device
    )
    norm = Normalize(spec.scene.bbox)

    policy = None
    if a.policy:
        from pointcloud_tpu_torch.rl.policy import load_policy

        policy = load_policy(a.policy, device=a.device)
    gt_encoder = (
        PassthroughEncoder(base, base.obs_keys, base.goal_keys)
        if a.gt_policy
        else None
    )

    if a.save_dir:
        os.makedirs(a.save_dir, exist_ok=True)

    obs, info = env.reset()

    def assemble_now():
        sensed = base.observation
        if "points" not in sensed:
            raise SystemExit("env has no vision sensor — use a Vision* env")
        pc = obs_to_pc(sensed, ["rgb"])
        in_pc = apply_np(norm, pc)[0]
        target = in_pc if not spec.dict_target else {
            k: np.asarray(v) for k, v in base.raw_state.items()
        }
        return assemble_prediction(
            a.model, spec, None, in_pc, target,
            class_colors=cfg_scene[base.scene]["class_colors"],
        )

    if a.interactive and not a.save_dir:
        _run_live_interactive(a, env, base, policy, gt_encoder, assemble_now)
        env.close()
        return

    for t in range(a.steps):
        pred_xyz, pred_rgb, gt_xyz, gt_rgb = assemble_now()
        save = os.path.join(a.save_dir, f"{t:04d}.png") if a.save_dir else None
        show_clouds(
            [(pred_xyz, pred_rgb, "prediction"), (gt_xyz, gt_rgb, "live cloud")],
            mode=a.mode,
            save=save,
            title=f"{a.env} step {t}",
        )
        obs, r, te, tr, info = env.step(_policy_action(env, base, obs, policy, gt_encoder))
        if te or tr:
            obs, info = env.reset()
    env.close()


def _policy_action(env, base, obs, policy, gt_encoder):
    if policy is not None:
        if gt_encoder is not None:
            gt_obs, gt_achieved = gt_encoder(base.raw_state)
            pobs = {
                "observation": np.concatenate(
                    (base.proprioception, gt_obs), dtype=np.float32
                ),
                "achieved_goal": gt_achieved,
                "desired_goal": gt_encoder.encode_goal(base.goal_state),
            }
        else:
            pobs = obs
        action, _ = policy.predict(pobs, deterministic=True)
        return action
    return env.action_space.sample()


def _run_live_interactive(a, env, base, policy, gt_encoder, assemble_now):
    """Reference live_ae_viewer loop: the env steps on a timer while keys
    i/o/v toggle the input cloud / reconstruction / marker overlays and m
    flips overlap vs side-by-side (live_ae_viewer.py:174-182)."""
    import matplotlib.pyplot as plt

    from pointcloud_tpu_torch.viewers.interactive import ReconViewerCore

    state = {"obs": None, "assembly": assemble_now()}
    core = ReconViewerCore(
        lambda _i: state["assembly"], n_items=max(a.steps, 1), mode=a.mode
    )
    core.show_input = False  # reference starts with input hidden (:37)

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    ax.set_title(f"{a.env} live — keys: i/o/v toggle, m mode")
    holder = {"scatter": None, "t": 0, "obs": None}

    def redraw():
        xyz, rgb = core.frame()
        if holder["scatter"] is not None:
            holder["scatter"].remove()
        holder["scatter"] = ax.scatter(
            xyz[:, 0], xyz[:, 1], xyz[:, 2], c=rgb, s=2
        )
        fig.canvas.draw_idle()

    def on_key(event):
        if core.key(event.key or ""):
            redraw()

    def on_tick():
        if holder["t"] >= a.steps:
            plt.close(fig)
            return
        action = _policy_action(env, base, holder["obs"], policy, gt_encoder)
        obs, r, te, tr, info = env.step(action)
        if te or tr:
            obs, info = env.reset()
        holder["obs"] = obs
        holder["t"] += 1
        state["assembly"] = assemble_now()
        core._load()
        core.anim_t = 1.0  # live frames jump; no morph between env steps
        redraw()

    fig.canvas.mpl_connect("key_press_event", on_key)
    timer = fig.canvas.new_timer(interval=100)
    timer.add_callback(on_tick)
    timer.start()
    redraw()
    plt.show()


if __name__ == "__main__":
    main()
