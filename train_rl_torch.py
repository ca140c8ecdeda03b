#!/usr/bin/env python
"""Train an RL agent on a GoalEnv with the PyTorch port (train_rl.py's
arguments plus --device; reference: readme.md:79-94 drives rl_zoo3 TQC with
rl/tqc.yml; this CLI runs the port's TQC/DDPG with the same hyperparameter
file).

Usage: python train_rl_torch.py RoboReach-v0 [--algo tqc|ddpg|her]
       [--epochs N] [--steps-per-epoch N] [--save policy.pkl]
       [--device cuda|cpu]

The envs are the port's (rl.vec_env.make_env: the env classes in a
TimeLimit) on --device, as are the nets. tqc.yml is read where PyYAML is installed.
"""

import argparse
import functools


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("env", type=str)
    parser.add_argument("--algo", default="tqc", choices=["tqc", "ddpg", "her"])
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--steps-per-epoch", type=int, default=4000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--save", default=None, type=str)
    parser.add_argument("--conf", default=None, type=str, help="tqc.yml path")
    parser.add_argument(
        "--n-envs", default=None, type=int,
        help="parallel collection envs (tqc only; default from tqc.yml)",
    )
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = parser.parse_args(argv)

    from pointcloud_tpu_torch.rl.vec_env import make_env

    # picklable under the subproc vec-env's 'spawn' context
    env_fn = functools.partial(make_env, a.env, max_episode_steps=50, device=a.device)

    if a.algo == "tqc":
        from pointcloud_tpu_torch.rl.config import load_yaml_config
        from pointcloud_tpu_torch.rl.tqc import tqc

        try:
            cfg = load_yaml_config(a.env.split("/")[-1], a.conf)
        except Exception:
            cfg = {}
        cfg.pop("total_timesteps", None)
        if a.n_envs is not None:
            cfg["n_envs"] = a.n_envs
        policy, history = tqc(
            env_fn,
            epochs=a.epochs,
            steps_per_epoch=a.steps_per_epoch,
            seed=a.seed,
            save_path=a.save,
            device=a.device,
            **cfg,
        )
        print("final success rate:", history[-1] if history else None)
    else:
        from pointcloud_tpu_torch.rl.ddpg import ddpg

        _, history = ddpg(
            env_fn,
            epochs=a.epochs,
            steps_per_epoch=a.steps_per_epoch,
            seed=a.seed,
            use_her=(a.algo == "her"),
            save_path=a.save,
            device=a.device,
        )
        print("final success rate:", history[-1] if history else None)


if __name__ == "__main__":
    main()
