"""The port's RL nets (pointcloud_tpu_torch/rl/core.py) and quantile-Huber
loss against the JAX package's on the CPU.

- Every core module (MLP, Actor, QCritic, MLPActorCritic,
  SquashedGaussianActor, QuantileCritic, QuantileEnsemble) from the flax
  variables of its JAX counterpart, converted by interop.load_flax_variables
  (the port keeps the flax names): outputs within 1e-6 of the largest entry
  of the JAX output. The squashed actor takes JAX's own normal draw
  (jax.random.normal(key, mu.shape), what the JAX actor draws inside) as
  `noise`: actions to the same bound, deterministic and stochastic; log
  probabilities within 1e-6 of the port's own float64 evaluation and 2e-6
  of JAX's (both packages' fp32 log probabilities lie 1.5e-7 to 6.6e-7 from
  the float64 value, so their gap reaches 1.03e-6 at hidden (64, 64)).
- interop.flax_params gives back the flax tree (exact).
- init_params draws flax nn.Dense's distribution (LeCun normal truncated at
  2 std, zero bias) from the generator it is given.
- quantile_huber_loss and its gradient within 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_utils  # noqa: F401  (one torch thread per worker)

from pointcloud_tpu.rl import core as jcore
from pointcloud_tpu.rl.tqc import quantile_huber_loss as jqhl
from pointcloud_tpu_torch.interop import flax_params, load_flax_variables
from pointcloud_tpu_torch.rl import core as tcore
from pointcloud_tpu_torch.rl.tqc import quantile_huber_loss as tqhl

OBS, ACT, B = 9, 4, 16


def close(got, want, tol=1e-6, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: {err:.3e} of the largest entry"


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, OBS)).astype(np.float32),
            rng.uniform(-1, 1, (B, ACT)).astype(np.float32))


def t(x):
    return torch.from_numpy(np.asarray(x))


def pair(jmod, tmod, *args):
    v = jmod.init(jax.random.PRNGKey(3), *[jnp.asarray(a) for a in args])
    load_flax_variables(tmod, v)
    return v


@pytest.mark.parametrize("hidden", [(), (32,), (64, 64), (16, 24, 32)])
@pytest.mark.parametrize("out_activation", [None, "tanh"])
def test_mlp_matches_flax(hidden, out_activation):
    o, _ = inputs()
    jm = jcore.MLP(hidden, 5, out_activation)
    tm = tcore.MLP(OBS, hidden, 5, out_activation)
    v = pair(jm, tm, o)
    close(tm(t(o)).detach(), jm.apply(v, o), what="MLP")


@pytest.mark.parametrize("hidden", [(32, 32), (64, 64, 64)])
def test_actor_and_critic_match_flax(hidden):
    o, a = inputs(1)
    ja, ta = jcore.Actor(ACT, 2.5, hidden), tcore.Actor(OBS, ACT, 2.5, hidden)
    v = pair(ja, ta, o)
    close(ta(t(o)).detach(), ja.apply(v, o), what="Actor")
    jq, tq = jcore.QCritic(hidden), tcore.QCritic(OBS + ACT, hidden)
    v = pair(jq, tq, o, a)
    close(tq(t(o), t(a)).detach(), jq.apply(v, o, a), what="QCritic")


def test_actor_critic_bundle_matches_flax():
    o, a = inputs(2)
    jm = jcore.MLPActorCritic(ACT, 1.0, (32, 32))
    tm = tcore.MLPActorCritic(OBS, ACT, 1.0, (32, 32))
    v = pair(jm, tm, o, a)
    (jpi, jq), (tpi, tq) = jm.apply(v, o, a), tm(t(o), t(a))
    close(tpi.detach(), jpi, what="pi")
    close(tq.detach(), jq, what="q")
    close(tm.act(t(o)).detach(), jm.apply(v, o, method=jm.act), what="act")
    close(tm.q_value(t(o), t(a)).detach(), jm.apply(v, o, a, method=jm.q_value),
          what="q_value")


@pytest.mark.parametrize("hidden", [(32, 32), (64, 64), (24, 24, 24)])
@pytest.mark.parametrize("mode", ["deterministic", "no_key", "noise", "clip_high", "clip_low"])
def test_squashed_actor_matches_flax(hidden, mode):
    """clip_high / clip_low: the log std layer's bias at +30 / -30, so
    log_std sits at its clip (2 with a Gaussian draw; -20 deterministic: at
    std e^-20 a draw is lost to mu's rounding in fp32, in both packages)."""
    o, _ = inputs(4)
    ja = jcore.SquashedGaussianActor(ACT, 1.5, hidden)
    ta = tcore.SquashedGaussianActor(OBS, ACT, 1.5, hidden)
    v = jax.tree_util.tree_map(np.array, ja.init(jax.random.PRNGKey(3), jnp.asarray(o)))
    if mode.startswith("clip"):
        v["params"][f"Dense_{len(hidden) + 1}"]["bias"][:] = 30 if mode == "clip_high" else -30
    load_flax_variables(ta, v)
    key = jax.random.PRNGKey(11)
    noise = np.asarray(jax.random.normal(key, (B, ACT)))
    deterministic = mode in ("deterministic", "clip_low")
    if mode == "no_key":
        want, got, noise = ja.apply(v, o), ta(t(o)), None
    else:
        want = ja.apply(v, o, key=key, deterministic=deterministic)
        got = ta(t(o), t(noise), deterministic=deterministic)
    close(got[0].detach(), want[0], what="action")
    close(got[1].detach(), want[1], tol=2e-6, what="logp")
    noise64 = None if noise is None else t(noise).double()
    ref = ta.double()(t(o).double(), noise64, deterministic=deterministic)
    close(got[1].detach(), ref[1].detach(), what="logp against float64")


@pytest.mark.parametrize("n_critics,hidden", [(1, (32, 32)), (2, (32, 32)), (3, (16, 16, 16))])
def test_quantile_ensemble_matches_flax(n_critics, hidden):
    o, a = inputs(5)
    jm = jcore.QuantileEnsemble(n_critics, 7, hidden)
    tm = tcore.QuantileEnsemble(OBS + ACT, n_critics, 7, hidden)
    v = pair(jm, tm, o, a)
    close(tm(t(o), t(a)).detach(), jm.apply(v, o, a), what="ensemble")
    jc, tc = jcore.QuantileCritic(7, hidden), tcore.QuantileCritic(OBS + ACT, 7, hidden)
    v = pair(jc, tc, o, a)
    close(tc(t(o), t(a)).detach(), jc.apply(v, o, a), what="critic")


@pytest.mark.parametrize("make", [
    lambda: (jcore.SquashedGaussianActor(ACT, 1.0, (8, 8)),
             tcore.SquashedGaussianActor(OBS, ACT, 1.0, (8, 8)), 1),
    lambda: (jcore.Actor(ACT, 1.0, (8,)), tcore.Actor(OBS, ACT, 1.0, (8,)), 1),
    lambda: (jcore.QuantileEnsemble(2, 3, (8,)), tcore.QuantileEnsemble(OBS + ACT, 2, 3, (8,)),
             2),
])
def test_flax_params_round_trip(make):
    jm, tm, n_args = make()
    o, a = inputs(6)
    v = pair(jm, tm, *(o, a)[:n_args])
    back = flax_params(tm)
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    want = jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map(np.asarray, v))[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == np.float32 and np.array_equal(g, w), path


def test_init_params_draws_flax_dense_distribution():
    """LeCun normal over fan-in, truncated at 2 std, zero bias: the flax
    Dense's initializer, whose statistics the draws match (a 512 x 512
    layer: 262,144 draws, std within 1%)."""
    gen = torch.Generator().manual_seed(0)
    m = tcore.init_params(tcore.MLP(512, (512,), 512), gen)
    jv = jcore.MLP((512,), 512).init(jax.random.PRNGKey(0), jnp.zeros((1, 512)))
    jk = np.asarray(jv["params"]["Dense_0"]["kernel"])
    w = m.Dense_0.weight.detach().numpy()
    std = 1 / np.sqrt(512) / 0.87962566103423978
    assert np.abs(w).max() <= 2 * std and np.abs(jk).max() <= 2 * std
    assert abs(w.std() / jk.std() - 1) < 0.01 and abs(w.std() * np.sqrt(512) - 1) < 0.01
    assert abs(w.mean()) < 1e-3 and float(m.Dense_0.bias.detach().abs().max()) == 0.0
    again = tcore.init_params(tcore.MLP(512, (512,), 512), torch.Generator().manual_seed(0))
    assert torch.equal(again.Dense_1.weight, m.Dense_1.weight)
    other = tcore.init_params(tcore.MLP(512, (512,), 512), torch.Generator().manual_seed(1))
    assert not torch.equal(other.Dense_0.weight, m.Dense_0.weight)


@pytest.mark.parametrize("n_c,n_q,n_t,scale", [(2, 5, 7, 1.0), (2, 25, 46, 3.0),
                                               (1, 3, 2, 0.2), (3, 4, 9, 10.0)])
def test_quantile_huber_loss_and_gradient_match(n_c, n_q, n_t, scale):
    rng = np.random.default_rng(n_q)
    pred = (scale * rng.standard_normal((6, n_c, n_q))).astype(np.float32)
    target = (scale * rng.standard_normal((6, n_t))).astype(np.float32)
    jl, jg = jax.value_and_grad(jqhl)(jnp.asarray(pred), jnp.asarray(target))
    p = t(pred).requires_grad_(True)
    tl = tqhl(p, t(target))
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    close(p.grad, jg, what="gradient")
    assert float(tqhl(torch.zeros(2, 2, 5), torch.zeros(2, 7))) == 0.0
    assert float(tqhl(torch.zeros(2, 2, 5), torch.ones(2, 7))) > 0
