"""Shared helpers of the port's parity tests (tests/test_torch_*.py)."""

import numpy as np
import torch

# Tier-1 runs the tests under several xdist workers: one thread each.
torch.set_num_threads(1)


def random_variables(variables, rng):
    """A flax variables tree with every leaf redrawn from `rng` (numpy), so
    that BatchNorm, the pools and the STN heads are not the identity:
    kernels ~ N(0, 1/fan_in), biases/offsets ~ N(0, 0.1), BN scales of
    random sign (some negative, which sends the pool through its min branch),
    running means ~ N(0, 0.1) and running variances in [0.5, 2]."""

    def draw(path, leaf):
        shape = np.shape(leaf)
        name = path[-1]
        if name == "kernel":
            return rng.standard_normal(shape) / np.sqrt(shape[0])
        if name == "scale":
            sign = np.where(rng.random(shape) < 0.2, -1.0, 1.0)
            return sign * rng.uniform(0.5, 1.5, shape)
        if name == "var":
            return rng.uniform(0.5, 2.0, shape)
        return 0.1 * rng.standard_normal(shape)  # bias, offset, mean

    def walk(tree, path=()):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = walk(v, path + (k,))
            else:
                out[k] = draw(path + (k,), v).astype(np.float32)
        return out

    return walk(variables)


def to_np(t):
    return np.asarray(t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t)


def train_mode_pair(jmod, tmod, variables, x, seed, jtrain=None, **kw):
    """Train-mode forward of the flax module `jmod` and the port's `tmod` on
    the same variables (already loaded into `tmod`) and input `x`, with the
    loss sum(out * r) for a fixed random r. `jtrain` is the flax module's
    train-mode argument (default train=True).

    Returns {"jax": (out, grads, batch_stats, dx), "port": (...)}, each as
    numpy arrays; grads and batch_stats are state_dict-keyed dicts (flax
    names mapped through interop)."""
    import jax
    import jax.numpy as jnp

    from pointcloud_tpu_torch.interop import flax_to_state_dict

    jx = jnp.asarray(x)
    jtrain = {"train": True} if jtrain is None else jtrain
    out_shape = jax.eval_shape(
        lambda p: jmod.apply({**variables, "params": p}, jx, **jtrain,
                             mutable=["batch_stats"], **kw)[0],
        variables["params"]).shape
    r = np.random.default_rng(seed).standard_normal(out_shape).astype(np.float32)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}

    def loss(params, xin):
        out, mutated = jmod.apply({**variables, "params": params}, xin,
                                  **jtrain, mutable=["batch_stats"], **jkw)
        return jnp.sum(out.astype(jnp.float32) * r), (out, mutated)

    (_, (jout, mutated)), (jgrads, jdx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"], jx)
    jstats = {k: to_np(v) for k, v in flax_to_state_dict(
        {"batch_stats": jax.tree_util.tree_map(np.asarray, mutated["batch_stats"])}
    ).items()}
    jgr = {k: to_np(v) for k, v in flax_to_state_dict(
        {"params": jax.tree_util.tree_map(np.asarray, jgrads)}).items()}

    tx = torch.from_numpy(np.array(x)).requires_grad_()
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    tout = tmod(tx, train=True, **tkw)
    (tout.float() * torch.from_numpy(r)).sum().backward()
    tgr = {k: to_np(p.grad) for k, p in tmod.named_parameters()}
    tstats = {k: to_np(b) for k, b in tmod.named_buffers()}
    return {"jax": (np.asarray(jout), jgr, jstats, np.asarray(jdx)),
            "port": (to_np(tout), tgr, tstats, to_np(tx.grad))}
