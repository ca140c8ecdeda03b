"""The port's DDPG and TQC update steps against the JAX package's on the CPU.

Each starts from one JAX update, so that the targets differ from the nets
and Adam's moments are not zero, carries the parameters, targets and optax
Adam states across (interop.load_flax_variables, interop.adam_state_from_
optax), then takes three more updates in both packages on the same numpy
batches:
- DDPG: JAX's exposed make_update_step (pointcloud_tpu/rl/ddpg.py:29).
- TQC: the JAX step is a closure inside tqc() (pointcloud_tpu/rl/tqc.py:
  153-200); `jax_tqc_update` below composes the JAX package's own
  SquashedGaussianActor, QuantileEnsemble, quantile_huber_loss and
  optax.adam in that closure's order, line for line. The port's update
  takes JAX's normal draws of k1 and k2 as its noise.
Losses of every update within 1e-5 relative or 1e-5 absolute (the actor's
loss is a mean of Q values of both signs, near zero); every parameter, target
parameter and log_alpha after the third update within 1e-5 of the largest
entry of its tensor (fp32 products differ in their summation order between
XLA and PyTorch on the CPU; Adam divides by the root of the second moment,
so a gradient's round-off moves its parameter by up to ~lr * 1e-6 / |g|
relative).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_port_utils  # noqa: F401  (one torch thread per worker)

from pointcloud_tpu.rl import core as jcore
from pointcloud_tpu.rl.ddpg import make_update_step as jddpg_step
from pointcloud_tpu.rl.tqc import quantile_huber_loss as jqhl
from pointcloud_tpu_torch.interop import adam_state_from_optax, load_flax_variables
from pointcloud_tpu_torch.rl import core as tcore
from pointcloud_tpu_torch.rl.ddpg import make_update_step as tddpg_step
from pointcloud_tpu_torch.rl.tqc import adam, batch_tensors
from pointcloud_tpu_torch.rl.tqc import make_update_step as ttqc_step

OBS, GOAL, ACT, B = 7, 3, 4, 32
TOL = 1e-5


def batches(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        out.append({
            "obs": rng.standard_normal((B, OBS)).astype(np.float32),
            "achieved": rng.standard_normal((B, GOAL)).astype(np.float32),
            "desired": rng.standard_normal((B, GOAL)).astype(np.float32),
            "act": rng.uniform(-1, 1, (B, ACT)).astype(np.float32),
            "rew": -(rng.random(B) < 0.7).astype(np.float32),
            "next_obs": rng.standard_normal((B, OBS)).astype(np.float32),
            "next_achieved": rng.standard_normal((B, GOAL)).astype(np.float32),
            "done": (rng.random(B) < 0.1).astype(np.float32),
        })
    return out


def close(got, want, tol=TOL, what=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: {err:.3e} of the largest entry"


def port_module(module, variables):
    return load_flax_variables(module, jax.tree_util.tree_map(np.asarray, variables))


def port_adam(module, params, opt_state, lr):
    opt = adam(module.parameters(), lr)
    sd = opt.state_dict()
    sd["state"] = adam_state_from_optax(module, params["params"],
                                        jax.tree_util.tree_leaves(opt_state))
    opt.load_state_dict(sd)
    return opt


def same_module(tmod, jvars, what):
    mirror = copy.deepcopy(tmod)
    port_module(mirror, jvars)
    want = dict(mirror.named_parameters())
    for name, p in tmod.named_parameters():
        close(p, want[name].detach().numpy(), what=f"{what}.{name}")


@pytest.mark.parametrize("hidden,gamma,polyak", [((32, 32), 0.99, 0.995),
                                                 ((64, 64), 0.95, 0.95)])
def test_three_ddpg_updates_match_jax(hidden, gamma, polyak):
    ja, jq = jcore.Actor(ACT, 1.0, hidden), jcore.QCritic(hidden)
    key = jax.random.PRNGKey(0)
    o0, a0 = jnp.zeros((1, OBS + GOAL)), jnp.zeros((1, ACT))
    pi_p, q_p = ja.init(key, o0), jq.init(key, o0, a0)
    state = (pi_p, q_p, pi_p, q_p, optax.adam(1e-3).init(pi_p), optax.adam(2e-3).init(q_p))
    jupdate = jddpg_step(ja, jq, gamma, polyak, 1e-3, 2e-3)
    first, *rest = batches(1, 4)
    jb = lambda b: {k: jnp.asarray(v) for k, v in b.items()}  # noqa: E731
    state, _, _ = jupdate(state, jb(first))

    pi_p, q_p, pi_t, q_t, pi_opt, q_opt = state
    actor = port_module(tcore.Actor(OBS + GOAL, ACT, 1.0, hidden), pi_p)
    critic = port_module(tcore.QCritic(OBS + GOAL + ACT, hidden), q_p)
    actor_t = port_module(tcore.Actor(OBS + GOAL, ACT, 1.0, hidden), pi_t).requires_grad_(False)
    critic_t = port_module(tcore.QCritic(OBS + GOAL + ACT, hidden), q_t).requires_grad_(False)
    tupdate = tddpg_step(actor, critic, actor_t, critic_t,
                         port_adam(actor, pi_p, pi_opt, 1e-3),
                         port_adam(critic, q_p, q_opt, 2e-3), gamma, polyak)
    for i, b in enumerate(rest):
        state, jql, jpl = jupdate(state, jb(b))
        tql, tpl = tupdate(batch_tensors(b, "cpu"))
        np.testing.assert_allclose(float(tql), float(jql), rtol=TOL, atol=TOL,
                                   err_msg=f"q_loss {i}")
        np.testing.assert_allclose(float(tpl), float(jpl), rtol=TOL, atol=TOL,
                                   err_msg=f"pi_loss {i}")
    pi_p, q_p, pi_t, q_t, _, _ = state
    same_module(actor, pi_p, "actor")
    same_module(critic, q_p, "critic")
    same_module(actor_t, pi_t, "actor target")
    same_module(critic_t, q_t, "critic target")


def jax_tqc_update(actor, critic, gamma, polyak, lr, target_entropy, total_kept):
    """The JAX package's TQC step, pointcloud_tpu/rl/tqc.py:148-200, line for
    line (the closure over tqc()'s locals made a function of them)."""
    q_tx, pi_tx, a_tx = optax.adam(lr), optax.adam(lr), optax.adam(lr)

    @jax.jit
    def update(state, batch, key):
        pi_p, q_p, q_t, log_alpha, pi_opt, q_opt, a_opt = state
        o = jnp.concatenate([batch["obs"], batch["desired"]], axis=-1)
        o2 = jnp.concatenate([batch["next_obs"], batch["desired"]], axis=-1)
        k1, k2 = jax.random.split(key)

        a2, logp2 = actor.apply(pi_p, o2, key=k1)
        zt = critic.apply(q_t, o2, a2).reshape(o.shape[0], -1)
        zt = jnp.sort(zt, axis=-1)[:, :total_kept]
        alpha = jnp.exp(log_alpha)
        target = batch["rew"][:, None] + gamma * (1 - batch["done"][:, None]) * (
            zt - alpha * logp2[:, None]
        )
        target = jax.lax.stop_gradient(target)

        def q_loss_fn(qp):
            z = critic.apply(qp, o, batch["act"])
            return jqhl(z, target)

        q_loss, q_grads = jax.value_and_grad(q_loss_fn)(q_p)
        q_up, q_opt = q_tx.update(q_grads, q_opt, q_p)
        q_p = optax.apply_updates(q_p, q_up)

        def pi_loss_fn(pp):
            a, logp = actor.apply(pp, o, key=k2)
            z = critic.apply(q_p, o, a).reshape(o.shape[0], -1)
            return jnp.mean(alpha * logp - jnp.mean(z, axis=-1)), logp

        (pi_loss, logp), pi_grads = jax.value_and_grad(pi_loss_fn, has_aux=True)(pi_p)
        pi_up, pi_opt = pi_tx.update(pi_grads, pi_opt, pi_p)
        pi_p = optax.apply_updates(pi_p, pi_up)

        def alpha_loss_fn(la):
            return -jnp.mean(jnp.exp(la) * jax.lax.stop_gradient(logp + target_entropy))

        a_loss, a_grads = jax.value_and_grad(alpha_loss_fn)(log_alpha)
        a_up, a_opt = a_tx.update(a_grads, a_opt, log_alpha)
        log_alpha = optax.apply_updates(log_alpha, a_up)

        q_t = jax.tree_util.tree_map(
            lambda t, s: polyak * t + (1 - polyak) * s, q_t, q_p
        )
        return (pi_p, q_p, q_t, log_alpha, pi_opt, q_opt, a_opt), q_loss, pi_loss

    def init(pi_p, q_p):
        log_alpha = jnp.zeros(())
        return (pi_p, q_p, q_p, log_alpha, pi_tx.init(pi_p), q_tx.init(q_p),
                a_tx.init(log_alpha))

    return update, init


@pytest.mark.parametrize("hidden,critic_hidden,n_critics,n_q,drop", [
    ((32, 32), (32, 32), 2, 5, 1),
    ((64, 64), (48, 48, 48), 2, 25, 2),
    ((16, 16), (16, 16), 3, 4, 1),
])
def test_three_tqc_updates_match_jax(hidden, critic_hidden, n_critics, n_q, drop):
    gamma, polyak, lr = 0.95, 0.95, 1e-3
    target_entropy = -float(ACT)
    total_kept = n_critics * n_q - drop * n_critics
    ja = jcore.SquashedGaussianActor(ACT, 1.0, hidden)
    jc = jcore.QuantileEnsemble(n_critics, n_q, critic_hidden)
    k_init = jax.random.PRNGKey(0)
    o0, a0 = jnp.zeros((1, OBS + GOAL)), jnp.zeros((1, ACT))
    jupdate, jinit = jax_tqc_update(ja, jc, gamma, polyak, lr, target_entropy, total_kept)
    state = jinit(ja.init(k_init, o0), jc.init(k_init, o0, a0))
    first, *rest = batches(2, 4)
    jb = lambda b: {k: jnp.asarray(v) for k, v in b.items()}  # noqa: E731
    keys = jax.random.split(jax.random.PRNGKey(5), 4)
    state, _, _ = jupdate(state, jb(first), keys[0])

    pi_p, q_p, q_t, log_alpha, pi_opt, q_opt, a_opt = state
    actor = port_module(tcore.SquashedGaussianActor(OBS + GOAL, ACT, 1.0, hidden), pi_p)
    critic = port_module(tcore.QuantileEnsemble(OBS + GOAL + ACT, n_critics, n_q,
                                                critic_hidden), q_p)
    critic_t = port_module(tcore.QuantileEnsemble(OBS + GOAL + ACT, n_critics, n_q,
                                                  critic_hidden), q_t).requires_grad_(False)
    t_alpha = torch.tensor(float(log_alpha), requires_grad=True)
    a_torch = adam([t_alpha], lr)
    sd = a_torch.state_dict()
    count, mu, nu = (np.asarray(x) for x in jax.tree_util.tree_leaves(a_opt))
    sd["state"] = {0: {"step": torch.tensor(float(count)), "exp_avg": torch.tensor(float(mu)),
                       "exp_avg_sq": torch.tensor(float(nu))}}
    a_torch.load_state_dict(sd)
    tupdate = ttqc_step(actor, critic, critic_t, t_alpha,
                        port_adam(actor, pi_p, pi_opt, lr), port_adam(critic, q_p, q_opt, lr),
                        a_torch, gamma, polyak, target_entropy, total_kept)
    for i, (b, key) in enumerate(zip(rest, keys[1:])):
        state, jql, jpl = jupdate(state, jb(b), key)
        k1, k2 = jax.random.split(key)
        n1, n2 = (torch.from_numpy(np.asarray(jax.random.normal(k, (B, ACT)))) for k in (k1, k2))
        tql, tpl = tupdate(batch_tensors(b, "cpu"), n1, n2)
        np.testing.assert_allclose(float(tql), float(jql), rtol=TOL, atol=TOL,
                                   err_msg=f"q_loss {i}")
        np.testing.assert_allclose(float(tpl), float(jpl), rtol=TOL, atol=TOL,
                                   err_msg=f"pi_loss {i}")
    pi_p, q_p, q_t, log_alpha, _, _, _ = state
    same_module(actor, pi_p, "actor")
    same_module(critic, q_p, "critic")
    same_module(critic_t, q_t, "critic target")
    np.testing.assert_allclose(float(t_alpha.detach()), float(log_alpha), rtol=TOL, atol=1e-7)
