"""TQC: Truncated Quantile Critics (port of pointcloud_tpu/rl/tqc.py; the
algorithm the reference trains with via rl_zoo3/sb3_contrib — readme.md:79-94,
rl/tqc.yml:207-277).

Squashed-Gaussian actor, an ensemble of quantile critics, quantile-Huber
regression against a target distribution with the top
`top_quantiles_to_drop` atoms removed (overestimation control), SAC-style
auto-tuned entropy temperature, polyak target averaging. HER relabeling via
rl.buffers.her_sample (future-4, matching tqc.yml). The nets and their
updates run on `device` (default 'cuda'); the env loop and the replay
buffer stay on the host.

The `TQC` class is the deployable policy object: `predict(obs_dict,
deterministic=True) -> (action, state)` — the MultiInputPolicy protocol
sim.py / calibrate_latent.py consume. Its `save` writes the JAX package's
pickle (flax-layout numpy params), so either package loads the other's.
"""

from __future__ import annotations

import copy
import pickle
import time
import types
from typing import Callable

import numpy as np
import torch

from pointcloud_tpu_torch.interop import flax_params, load_flax_variables
from pointcloud_tpu_torch.rl.buffers import ReplayBuffer, her_sample
from pointcloud_tpu_torch.rl.core import QuantileEnsemble, SquashedGaussianActor, init_params
from pointcloud_tpu_torch.utils import resolve_device

BATCH_KEYS = ("obs", "desired", "act", "rew", "next_obs", "done")


def batch_tensors(batch: dict, device) -> dict:
    """The update's inputs of a sampled batch as fp32 tensors on `device`:
    one host-to-device copy of the columns side by side, split there."""
    B = len(batch["rew"])
    cols = [np.asarray(batch[k], np.float32).reshape(B, -1) for k in BATCH_KEYS]
    flat = torch.from_numpy(np.concatenate(cols, axis=1)).to(device)
    parts = flat.split([c.shape[1] for c in cols], dim=1)
    return {k: p if batch[k].ndim > 1 else p[:, 0] for k, p in zip(BATCH_KEYS, parts)}


def quantile_huber_loss(pred, target, kappa: float = 1.0):
    """pred (B, n_c, n_q), target (B, n_t) -> scalar quantile-Huber loss."""
    B, n_c, n_q = pred.shape
    tau = (torch.arange(n_q, dtype=torch.float32, device=pred.device) + 0.5) / n_q
    # pairwise TD errors: (B, n_c, n_q, n_t)
    td = target[:, None, None, :] - pred[..., None]
    abs_td = torch.abs(td)
    huber = torch.where(abs_td <= kappa, 0.5 * td**2, kappa * (abs_td - 0.5 * kappa))
    weight = torch.abs(tau[None, None, :, None] - (td < 0).float())
    return torch.mean(weight * huber)


def polyak_update_(target, source, polyak: float):
    """target <- polyak * target + (1 - polyak) * source, in place."""
    with torch.no_grad():
        t = list(target.parameters())
        torch._foreach_mul_(t, polyak)
        torch._foreach_add_(t, list(source.parameters()), alpha=1 - polyak)


def make_update_step(actor, critic, critic_target, log_alpha, pi_opt, q_opt, a_opt,
                     gamma: float, polyak: float, target_entropy: float, total_kept: int):
    """update(batch, noise1, noise2) -> (q_loss, pi_loss), in the order of the
    JAX package's jitted step (pointcloud_tpu/rl/tqc.py:153-200):
      1. the target from the current actor (Gaussian draw noise1) and the
         target critics, sorted, truncated to total_kept, minus alpha * logp2;
      2. the critics' Adam step on the quantile-Huber loss;
      3. the actor's Adam step on mean(alpha * logp - mean(z)), z from the
         updated critics and draw noise2;
      4. log_alpha's Adam step on -mean(exp(log_alpha) * (logp + target_entropy)),
         logp of step 3 detached;
      5. polyak averaging of the target critics only.
    batch: batch_tensors' dict; noise1, noise2: (B, act_dim) standard normals.
    Parameters, Adam states and log_alpha are updated in place."""
    actor_params = list(actor.parameters())

    def update(batch, noise1, noise2):
        o = torch.cat([batch["obs"], batch["desired"]], dim=-1)
        o2 = torch.cat([batch["next_obs"], batch["desired"]], dim=-1)
        B = o.shape[0]

        # target distribution: truncated sorted quantiles of the target nets
        with torch.no_grad():
            a2, logp2 = actor(o2, noise1)
            zt = critic_target(o2, a2).reshape(B, -1)  # (B, n_c*n_q)
            zt = torch.sort(zt, dim=-1).values[:, :total_kept]
            alpha = torch.exp(log_alpha)
            target = batch["rew"][:, None] + gamma * (1 - batch["done"][:, None]) * (
                zt - alpha * logp2[:, None]
            )

        q_loss = quantile_huber_loss(critic(o, batch["act"]), target)
        q_opt.zero_grad(set_to_none=True)
        q_loss.backward()
        q_opt.step()

        a, logp = actor(o, noise2)
        z = critic(o, a).reshape(B, -1)
        pi_loss = torch.mean(alpha * logp - torch.mean(z, dim=-1))
        pi_opt.zero_grad(set_to_none=True)
        pi_loss.backward(inputs=actor_params)
        pi_opt.step()

        a_loss = -torch.mean(torch.exp(log_alpha) * (logp.detach() + target_entropy))
        a_opt.zero_grad(set_to_none=True)
        a_loss.backward()
        a_opt.step()

        polyak_update_(critic_target, critic, polyak)
        return q_loss.detach(), pi_loss.detach()

    return update


def adam(params, lr: float) -> torch.optim.Adam:
    """torch's Adam as optax.adam(lr): betas (0.9, 0.999), eps 1e-8 outside
    the square root, bias-corrected."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def make_agent(in_dim: int, act_dim: int, act_limit: float, hidden, critic_hidden,
               n_critics: int, n_quantiles: int, top_quantiles_to_drop: int, gamma: float,
               polyak: float, lr: float, generator: torch.Generator, device):
    """tqc()'s agent: the actor and critics initialised from `generator` on
    the CPU and moved to `device`, the target critics, log_alpha = 0, an Adam
    for each and the update step (make_update_step). A namespace of actor,
    critic, critic_target, log_alpha, pi_opt, q_opt, a_opt and update."""
    actor = init_params(SquashedGaussianActor(in_dim, act_dim, act_limit, hidden), generator)
    critic = init_params(
        QuantileEnsemble(in_dim + act_dim, n_critics, n_quantiles, critic_hidden), generator)
    actor, critic = actor.to(device), critic.to(device)
    critic_target = copy.deepcopy(critic).requires_grad_(False)
    log_alpha = torch.zeros((), device=device, requires_grad=True)
    pi_opt, q_opt, a_opt = adam(actor.parameters(), lr), adam(critic.parameters(), lr), \
        adam([log_alpha], lr)
    total_kept = n_critics * n_quantiles - top_quantiles_to_drop * n_critics
    update = make_update_step(actor, critic, critic_target, log_alpha, pi_opt, q_opt, a_opt,
                              gamma, polyak, -float(act_dim), total_kept)
    return types.SimpleNamespace(actor=actor, critic=critic, critic_target=critic_target,
                                 log_alpha=log_alpha, pi_opt=pi_opt, q_opt=q_opt,
                                 a_opt=a_opt, update=update)


class TQC:
    """Trained TQC policy bundle with sb3-style predict()."""

    def __init__(self, actor: SquashedGaussianActor, act_limit: float):
        self.actor = actor
        self.act_limit = act_limit

    @torch.no_grad()
    def predict(self, obs_dict, deterministic: bool = True, state=None, **kw):
        o = np.concatenate(
            [np.asarray(obs_dict["observation"]).reshape(-1),
             np.asarray(obs_dict["desired_goal"]).reshape(-1)],
            dtype=np.float32,
        )
        dev = next(self.actor.parameters()).device
        a = self.actor(torch.from_numpy(o[None]).to(dev), deterministic=True)[0]
        a = a[0].cpu().numpy()
        return np.clip(a, -self.act_limit, self.act_limit), state

    def save(self, path: str):
        with open(path, "wb") as f:
            pickle.dump(
                {
                    "pi": flax_params(self.actor),
                    "config": {
                        "act_dim": self.actor.act_dim,
                        "act_limit": self.actor.act_limit,
                        "hidden": tuple(self.actor.hidden),
                        "actor_type": "squashed_gaussian",
                    },
                },
                f,
            )

    @classmethod
    def load(cls, path: str, device="cuda"):
        with open(path, "rb") as f:
            payload = pickle.load(f)
        cfg = payload["config"]
        in_dim = np.shape(payload["pi"]["params"]["Dense_0"]["kernel"])[0]
        actor = SquashedGaussianActor(in_dim, cfg["act_dim"], cfg["act_limit"], cfg["hidden"])
        load_flax_variables(actor, payload["pi"])
        return cls(actor.to(resolve_device(device)), cfg["act_limit"])


def tqc(
    env_fn: Callable,
    hidden=(256, 256),
    critic_hidden=(512, 512, 512),
    n_critics: int = 2,
    n_quantiles: int = 25,
    top_quantiles_to_drop: int = 2,
    seed: int = 0,
    steps_per_epoch: int = 4000,
    epochs: int = 10,
    replay_size: int = 1_000_000,
    gamma: float = 0.95,
    polyak: float = 0.995,
    lr: float = 1e-3,
    batch_size: int = 256,
    start_steps: int = 1000,
    update_after: int = 1000,
    update_every: int = 1,
    gradient_steps: int = 1,
    max_ep_len: int = 50,
    use_her: bool = True,
    her_strategy: str = "future",
    her_ratio: float = 0.8,
    num_test_episodes: int = 10,
    save_path: str | None = None,
    log_fn=print,
    n_envs: int = 1,
    vec_env: str = "subproc",
    device="cuda",
):
    """Train TQC(+HER) on a GoalEnv; hyperparameter defaults follow
    rl/tqc.yml:207-277 (gamma .95, net widths per task there). Returns
    (TQC policy, eval success history).

    n_envs > 1 collects experience from N parallel envs (reference:
    rl_zoo3 `--vec-env subproc -params n_envs:4`, readme.md:86-89) via
    rl.vec_env — per step, ONE batched action call serves all envs.
    vec_env: 'subproc' (worker processes; env_fn must be picklable) or
    'dummy' (sequential in-process). The nets run on `device`; the
    Gaussian draws come from a generator there seeded with `seed`."""
    device = resolve_device(device)
    env, test_env = env_fn(), env_fn()
    env.action_space.seed(seed)  # deterministic exploration
    rng = np.random.default_rng(seed)
    noise_gen = torch.Generator(device=device).manual_seed(seed)

    obs_dim = env.observation_space["observation"].shape[0]
    goal_dim = env.observation_space["desired_goal"].shape[0]
    act_dim = env.action_space.shape[0]
    act_limit = float(env.action_space.high[0])
    in_dim = obs_dim + goal_dim

    agent = make_agent(in_dim, act_dim, act_limit, hidden, critic_hidden, n_critics,
                       n_quantiles, top_quantiles_to_drop, gamma, polyak, lr,
                       torch.Generator().manual_seed(seed), device)
    actor, log_alpha, update = agent.actor, agent.log_alpha, agent.update

    @torch.no_grad()
    def sample_act(o):
        o = torch.from_numpy(o).to(device)
        noise = torch.randn(o.shape[0], act_dim, generator=noise_gen, device=device)
        return actor(o, noise)[0].cpu().numpy()

    @torch.no_grad()
    def det_act(o):
        return actor(torch.from_numpy(o).to(device), deterministic=True)[0].cpu().numpy()

    buffer = ReplayBuffer(obs_dim, goal_dim, act_dim, replay_size)

    def reward_fn(achieved, desired):
        return env.unwrapped.compute_reward(achieved, desired, None).astype(np.float32)

    def flat(o):
        return np.concatenate(
            [o["observation"], o["desired_goal"]], dtype=np.float32
        )

    def test_agent():
        succ = []
        for _ in range(num_test_episodes):
            o, info = test_env.reset(seed=int(rng.integers(1 << 30)))
            for _ in range(max_ep_len):
                a = det_act(flat(o)[None])[0]
                o, r, te, tr, info = test_env.step(np.clip(a, -act_limit, act_limit))
                if te or tr:
                    break
            succ.append(float(info.get("is_success", False)))
        return float(np.mean(succ))

    def do_updates():
        q_loss = torch.zeros(())
        for _ in range(gradient_steps):
            if use_her:
                batch = her_sample(
                    buffer, batch_size, rng, reward_fn,
                    strategy=her_strategy, her_ratio=her_ratio,
                )
            else:
                batch = buffer.sample(batch_size, rng)
                batch.pop("idx", None)
            noise = torch.randn(2, batch_size, act_dim, generator=noise_gen, device=device)
            q_loss, _ = update(batch_tensors(batch, device), noise[0], noise[1])
        return q_loss

    def log_epoch(t, q_loss, history, t0):
        epoch = (t + 1) // steps_per_epoch
        succ = test_agent()
        history.append(succ)
        log_fn(
            f"epoch {epoch}/{epochs}: test success={succ:.2f} "
            f"alpha={float(torch.exp(log_alpha.detach())):.3f} "
            f"q_loss={float(q_loss):.4f} ({time.time() - t0:.0f}s)"
        )
        if save_path:
            TQC(actor, act_limit).save(save_path)

    total_steps = steps_per_epoch * epochs

    if n_envs > 1:
        # parallel experience collection (reference rl_zoo3 subproc vec-env)
        from pointcloud_tpu_torch.rl.vec_env import DummyVecGoalEnv, SubprocVecGoalEnv

        venv = (
            SubprocVecGoalEnv([env_fn] * n_envs)
            if vec_env == "subproc"
            else DummyVecGoalEnv([env_fn] * n_envs)
        )
        obs_b, _ = venv.reset(seed=seed)
        # warmup sampling reproducibility: the space pickled back from
        # worker 0 is unseeded (the single-env path seeds env.action_space)
        venv.action_space.seed(seed)
        pend = [[] for _ in range(n_envs)]  # per-env episodes for HER contiguity
        history, t0 = [], time.time()
        q_loss = torch.zeros(())
        t = 0
        next_epoch = steps_per_epoch
        while t < total_steps:
            if t < start_steps:
                acts = np.stack(
                    [venv.action_space.sample() for _ in range(n_envs)]
                ).astype(np.float32)
            else:
                ob = np.concatenate(
                    [obs_b["observation"], obs_b["desired_goal"]], axis=-1
                ).astype(np.float32)
                acts = np.clip(sample_act(ob), -act_limit, act_limit)
            obs2_b, rews, terms, truncs, infos = venv.step(acts)
            for i in range(n_envs):
                cur = {k: v[i] for k, v in obs_b.items()}
                final = infos[i].get("final_observation")
                nxt = final if final is not None else {
                    k: v[i] for k, v in obs2_b.items()
                }
                pend[i].append(
                    (cur["observation"], cur["achieved_goal"],
                     cur["desired_goal"], acts[i], rews[i],
                     nxt["observation"], nxt["achieved_goal"],
                     float(terms[i]))
                )
                if terms[i] or truncs[i] or len(pend[i]) >= max_ep_len:
                    for tr in pend[i]:
                        buffer.store(*tr)
                    buffer.end_episode()
                    pend[i] = []
            obs_b = obs2_b
            t_prev, t = t, t + n_envs
            # same update pacing as the single-env path: run updates when t
            # crosses an update_every boundary (not on every venv.step)
            if (
                t >= update_after
                and buffer.size > batch_size
                and t // update_every > t_prev // update_every
            ):
                q_loss = do_updates()
            if t >= next_epoch:
                log_epoch(next_epoch - 1, q_loss, history, t0)
                next_epoch += steps_per_epoch
        venv.close()
        env.close()
        test_env.close()
        return TQC(actor, act_limit), history

    o, info = env.reset(seed=seed)
    ep_len, history, t0 = 0, [], time.time()
    q_loss = torch.zeros(())

    for t in range(total_steps):
        if t < start_steps:
            a = env.action_space.sample()
        else:
            a = np.clip(sample_act(flat(o)[None])[0], -act_limit, act_limit)

        o2, r, terminated, truncated, info = env.step(a)
        buffer.store(
            o["observation"], o["achieved_goal"], o["desired_goal"], a, r,
            o2["observation"], o2["achieved_goal"], float(terminated),
        )
        o = o2
        ep_len += 1
        if terminated or truncated or ep_len >= max_ep_len:
            buffer.end_episode()
            o, info = env.reset()
            ep_len = 0

        if t >= update_after and t % update_every == 0:
            q_loss = do_updates()

        if (t + 1) % steps_per_epoch == 0:
            log_epoch(t, q_loss, history, t0)

    env.close()
    test_env.close()
    return TQC(actor, act_limit), history
