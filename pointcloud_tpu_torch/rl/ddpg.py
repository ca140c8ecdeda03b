"""DDPG and DDPG+HER trainers (port of pointcloud_tpu/rl/ddpg.py; reference:
rl/agent.py:45-474).

Spinning-up-style single-env trainers: the actor/critic updates and target
polyak averaging run as one update step on `device` (default 'cuda'); the
env loop and replay buffer stay on host. `her()` is `ddpg()` with goal
relabeling (future-k by default; the reference's in-repo variant used
final-state).
"""

from __future__ import annotations

import copy
import time
from typing import Callable

import numpy as np
import torch

from pointcloud_tpu_torch.interop import flax_params
from pointcloud_tpu_torch.rl.buffers import ReplayBuffer, her_sample
from pointcloud_tpu_torch.rl.core import Actor, QCritic, init_params
from pointcloud_tpu_torch.rl.tqc import adam, batch_tensors, polyak_update_
from pointcloud_tpu_torch.utils import resolve_device


def _flat(obs_dict):
    return np.concatenate(
        [obs_dict["observation"], obs_dict["desired_goal"]], dtype=np.float32
    )


def make_update_step(actor, critic, actor_target, critic_target, pi_opt, q_opt,
                     gamma: float, polyak: float):
    """update(batch) -> (q_loss, pi_loss), the JAX package's jitted step
    (pointcloud_tpu/rl/ddpg.py:29-69): the critic's Adam step on the Bellman
    backup of the target nets, the actor's on -mean Q of the updated critic,
    then polyak averaging of both targets. batch: tqc.batch_tensors' dict.
    Parameters and Adam states are updated in place."""
    actor_params = list(actor.parameters())

    def update(batch):
        o = torch.cat([batch["obs"], batch["desired"]], dim=-1)
        o2 = torch.cat([batch["next_obs"], batch["desired"]], dim=-1)

        # critic update (Bellman backup with target nets)
        with torch.no_grad():
            a2 = actor_target(o2)
            q_targ = critic_target(o2, a2)
            backup = batch["rew"] + gamma * (1 - batch["done"]) * q_targ

        q = critic(o, batch["act"])
        q_loss = torch.mean((q - backup) ** 2)
        q_opt.zero_grad(set_to_none=True)
        q_loss.backward()
        q_opt.step()

        # actor update (maximize Q)
        pi_loss = -torch.mean(critic(o, actor(o)))
        pi_opt.zero_grad(set_to_none=True)
        pi_loss.backward(inputs=actor_params)
        pi_opt.step()

        # polyak averaging of targets (rl/agent.py polyak=0.995)
        polyak_update_(actor_target, actor, polyak)
        polyak_update_(critic_target, critic, polyak)
        return q_loss.detach(), pi_loss.detach()

    return update


def ddpg(
    env_fn: Callable,
    hidden=(256, 256),
    seed: int = 0,
    steps_per_epoch: int = 4000,
    epochs: int = 10,
    replay_size: int = 1_000_000,
    gamma: float = 0.99,
    polyak: float = 0.995,
    pi_lr: float = 1e-3,
    q_lr: float = 1e-3,
    batch_size: int = 100,
    start_steps: int = 1000,
    update_after: int = 1000,
    update_every: int = 50,
    act_noise: float = 0.1,
    max_ep_len: int = 50,
    use_her: bool = False,
    her_strategy: str = "future",
    her_ratio: float = 0.8,
    num_test_episodes: int = 10,
    save_path: str | None = None,
    log_fn=print,
    device="cuda",
):
    """Train DDPG(+HER) on a GoalEnv (reference rl/agent.py:45-291, 296-474).

    Returns ({"pi": the actor's state_dict, "actor": the actor}, eval success
    rate history). The nets run on `device`.
    """
    device = resolve_device(device)
    env, test_env = env_fn(), env_fn()
    env.action_space.seed(seed)  # deterministic exploration
    rng = np.random.default_rng(seed)

    obs_dim = env.observation_space["observation"].shape[0]
    goal_dim = env.observation_space["desired_goal"].shape[0]
    act_dim = env.action_space.shape[0]
    act_limit = float(env.action_space.high[0])

    gen = torch.Generator().manual_seed(seed)
    actor = init_params(Actor(obs_dim + goal_dim, act_dim, act_limit, hidden), gen)
    critic = init_params(QCritic(obs_dim + goal_dim + act_dim, hidden), gen)
    actor, critic = actor.to(device), critic.to(device)
    actor_target = copy.deepcopy(actor).requires_grad_(False)
    critic_target = copy.deepcopy(critic).requires_grad_(False)
    pi_opt, q_opt = adam(actor.parameters(), pi_lr), adam(critic.parameters(), q_lr)

    update = make_update_step(actor, critic, actor_target, critic_target, pi_opt, q_opt,
                              gamma, polyak)

    @torch.no_grad()
    def act(o_flat):
        return actor(torch.from_numpy(o_flat[None]).to(device))[0].cpu().numpy()

    buffer = ReplayBuffer(obs_dim, goal_dim, act_dim, replay_size)

    def reward_fn(achieved, desired):
        env_u = env.unwrapped
        return env_u.compute_reward(achieved, desired, None).astype(np.float32)

    def get_action(o_flat, noise):
        a = act(o_flat)
        a += noise * rng.standard_normal(act_dim)
        return np.clip(a, -act_limit, act_limit)

    def test_agent():
        successes = []
        for _ in range(num_test_episodes):
            o, info = test_env.reset(seed=int(rng.integers(1 << 30)))
            for _ in range(max_ep_len):
                a = act(_flat(o))
                o, r, te, tr, info = test_env.step(np.clip(a, -act_limit, act_limit))
                if te or tr:
                    break
            successes.append(float(info.get("is_success", False)))
        return float(np.mean(successes))

    total_steps = steps_per_epoch * epochs
    o, info = env.reset(seed=seed)
    ep_len = 0
    history = []
    t0 = time.time()

    for t in range(total_steps):
        if t < start_steps:
            a = env.action_space.sample()
        else:
            a = get_action(_flat(o), act_noise)

        o2, r, terminated, truncated, info = env.step(a)
        d = float(terminated)
        buffer.store(
            o["observation"], o["achieved_goal"], o["desired_goal"], a, r,
            o2["observation"], o2["achieved_goal"], d,
        )
        o = o2
        ep_len += 1

        if terminated or truncated or ep_len >= max_ep_len:
            buffer.end_episode()
            o, info = env.reset()
            ep_len = 0

        if t >= update_after and t % update_every == 0:
            for _ in range(update_every):
                if use_her:
                    batch = her_sample(
                        buffer, batch_size, rng, reward_fn,
                        strategy=her_strategy, her_ratio=her_ratio,
                    )
                else:
                    batch = buffer.sample(batch_size, rng)
                    batch.pop("idx", None)
                q_loss, pi_loss = update(batch_tensors(batch, device))

        if (t + 1) % steps_per_epoch == 0:
            epoch = (t + 1) // steps_per_epoch
            succ = test_agent()
            history.append(succ)
            log_fn(
                f"epoch {epoch}/{epochs}: test success={succ:.2f} "
                f"q_loss={float(q_loss):.4f} ({time.time() - t0:.0f}s)"
            )
            if save_path:
                _save(save_path, actor)

    env.close()
    test_env.close()
    return {"pi": actor.state_dict(), "actor": actor}, history


def her(env_fn, **kwargs):
    """DDPG with hindsight experience replay (reference rl/agent.py:296-474)."""
    kwargs.setdefault("use_her", True)
    return ddpg(env_fn, **kwargs)


def _save(path, actor):
    import pickle

    with open(path, "wb") as f:
        pickle.dump(
            {"pi": flax_params(actor), "config": {
                "act_dim": actor.act_dim, "act_limit": actor.act_limit,
                "hidden": tuple(actor.hidden),
                "actor_type": "deterministic"}},
            f,
        )
