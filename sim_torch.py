#!/usr/bin/env python
"""Rollouts and benchmarks of the PyTorch port (CLI mirror of sim.py;
reference: sim.py:1-129).

Composes any of the port's envs with any {sensor, encoder} pair, optionally
a passive second encoder (scores success independently, drawn as an
overlay), optionally a policy, and --benchmark N for mean/median reward +
success rate. Envs come from rl.vec_env.make_env (no gymnasium needed) on
--device (default cuda; --device cpu runs on the CPU); a policy file loads
through rl.policy.load_policy onto the same device.

Usage: python sim_torch.py VisionReach-v0 --benchmark 2 [--horizon 100]
       [--sensor PC] [--encoder AE] [--passive_encoder StatePred]
       [--policy policy.pkl] [--render] [--device cuda]
"""

import argparse

import numpy as np

from pointcloud_tpu_torch.envs.encoders import PassthroughEncoder
from pointcloud_tpu_torch.envs.sensors import PassthroughSensor


def main():
    from pointcloud_tpu_torch.rl.vec_env import make_env
    from pointcloud_tpu_torch.vision.pc_encoder import (
        GlobalAEEncoder,
        GlobalSegmenterEncoder,
        MultiSegmenterEncoder,
        StatePredictor,
        StatePredictorVisualGoal,
    )
    from pointcloud_tpu_torch.vision.pc_sensor import PointCloudSensor

    sensors = {
        "default": None,
        "passthru": PassthroughSensor,
        "PC": PointCloudSensor,
    }
    encoders = {
        "default": None,
        "passthru": PassthroughEncoder,
        "AE": GlobalAEEncoder,
        "Seg": GlobalSegmenterEncoder,
        "MultiSeg": MultiSegmenterEncoder,
        "StatePred": StatePredictor,
        "StatePredVisGoal": StatePredictorVisualGoal,
    }

    parser = argparse.ArgumentParser()
    parser.add_argument("env", type=str, help="environment ID")
    parser.add_argument("--horizon", type=int, default=100)
    parser.add_argument("--sensor", default="default", choices=list(sensors))
    parser.add_argument("--encoder", default="default", choices=list(encoders))
    parser.add_argument(
        "--passive_encoder", default="", choices=[""] + list(encoders),
        help="passive encoder just for goal checking and visualization",
    )
    parser.add_argument("--policy", default="", type=str, help="path to policy file")
    parser.add_argument("--benchmark", default=None, type=int,
                        help="episodes to run for benchmarking")
    parser.add_argument("--render", action="store_true")
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device of the env's sensor, encoder and policy")
    a = parser.parse_args()

    kwargs = {"sensor": sensors[a.sensor], "encoder": encoders[a.encoder]}
    needs_vision = (kwargs["encoder"] and kwargs["encoder"].requires_vision) or (
        a.passive_encoder and encoders[a.passive_encoder].requires_vision
    )
    if needs_vision:
        kwargs["sensor"] = PointCloudSensor
    env = make_env(
        a.env,
        max_episode_steps=a.horizon,
        device=a.device,
        render_mode="human" if a.render else None,
        **{k: v for k, v in kwargs.items() if v},
    )

    # passive second encoder: scores success on the same rollout (sim.py:43-64)
    pe = None
    if a.passive_encoder and encoders[a.passive_encoder]:
        env.reset()
        base = env.unwrapped
        pe = encoders[a.passive_encoder](base, base.obs_keys, base.goal_keys)
        if isinstance(pe, StatePredictor):
            pe.passthrough_goal = False
        pe_goal = pe.encode_goal(base.goal_obs)

        def show_success(h, w):
            base.encoder, orig = pe, base.encoder
            pe_achieved = pe.encode_goal(base.observation)
            pe_succ = base.check_success(pe_achieved, pe_goal, info=None)
            base.encoder = orig
            overlay = np.zeros((h, w, 3))
            overlay[h - 2 : h, :, :] = [0, 1, 0] if pe_succ else [1, 0, 0]
            return overlay

        base.overlay = show_success

    agent = None
    if a.policy:
        from pointcloud_tpu_torch.rl.policy import load_policy

        agent = load_policy(a.policy, device=a.device)

    ep_rewards, ep_success = [], []
    run = True
    while run:
        obs, info = env.reset()
        base = env.unwrapped
        if pe is not None:
            pe_goal = pe.encode_goal(base.goal_obs)
        total_reward = 0.0
        for t in range(a.horizon):
            if agent:
                action, _ = agent.predict(obs, deterministic=True)
            else:
                action = env.action_space.sample()
            obs, reward, terminated, truncated, info = env.step(action)
            total_reward += float(reward)

            v = base.viewer
            if v is not None:
                if v.is_pressed("g"):
                    base.show_frame(base.goal_state, None)
                if v.is_pressed("v"):
                    import pickle

                    with open(f"input/{base.scene}/{a.env}_visual_goal.pkl", "wb") as f:
                        pickle.dump(base.raw_state, f)
                    print("saved visual goal state")
                if v.is_pressed("b"):
                    _print_stats(ep_rewards, ep_success)
            if terminated or truncated:
                break

        ep_rewards.append(total_reward)
        ep_success.append(float(info["is_success"]))

        if a.benchmark and len(ep_rewards) >= a.benchmark:
            _print_stats(ep_rewards, ep_success)
            run = False
        if not a.benchmark:
            print(f"\ntotal_reward = {total_reward}\nis_success = {info['is_success']}")
    env.close()


def _print_stats(ep_rewards, ep_success):
    print("episodes = ", len(ep_rewards))
    print(f"mean reward = {np.mean(ep_rewards)}")
    print(f"median reward = {np.median(ep_rewards)}")
    print(f"success rate = {np.mean(ep_success)}")


if __name__ == "__main__":
    main()
