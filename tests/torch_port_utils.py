"""Shared helpers of the port's parity tests (tests/test_torch_*.py)."""

import numpy as np
import torch

# Tier-1 runs the tests under several xdist workers: one thread each.
torch.set_num_threads(1)


def random_variables(variables, rng):
    """A flax variables tree with every leaf redrawn from `rng` (numpy), so
    that BatchNorm, the pools and the STN heads are not the identity:
    kernels and SetAbstraction's w{i} ~ N(0, 1/fan_in), biases/offsets ~ N(0, 0.1), BN scales of
    random sign (some negative, which sends the pool through its min branch),
    running means ~ N(0, 0.1) and running variances in [0.5, 2]."""

    def draw(path, leaf):
        shape = np.shape(leaf)
        name = path[-1].rstrip("0123456789")  # SetAbstraction's w0, scale0, ...
        if name in ("kernel", "w"):
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


def raw_clouds(rng, sc, B, N):
    """Clouds in the scene's bbox coordinates (xyz) with rgb in [0, 1]."""
    bbox = np.asarray(sc.bbox, np.float32)
    xyz = bbox[:, 0] + rng.random((B, N, 3), dtype=np.float32) * (
        bbox[:, 1] - bbox[:, 0])
    return np.concatenate([xyz, rng.random((B, N, 3), dtype=np.float32)], -1)


def jax_variables(module, x, seed):
    """Random flax variables (random_variables) of `module` for input x."""
    import jax
    import jax.numpy as jnp

    v = module.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]), train=False)
    return random_variables(jax.tree_util.tree_map(np.asarray, v),
                            np.random.default_rng(seed))


def ball_margin(xyz, cents, radius):
    """Smallest |d - r^2| / r^2 over all (centroid, point) pairs, with d the
    float64 squared distance: how far every point keeps from the ball's
    boundary, relative to r^2."""
    d = ((cents[:, :, None, :].astype(np.float64)
          - xyz[:, None].astype(np.float64)) ** 2).sum(-1)
    return float(np.abs(d / (radius * radius) - 1.0).min())


def knn_margin(xyz, cents, k, mask=None, gaps=None):
    """Smallest relative gap (d_(j+1) - d_j) / d_(j+1) between consecutive
    float64 squared distances of each centroid's nearest valid points, over
    the `gaps` gaps after the j-th nearest for j = k - gaps + 1 .. k (default
    1: only the k-th against the (k+1)-th, which fixes the neighbour set; k:
    every gap up to the (k+1)-th, which fixes the slot order too). 1.0 where
    a cloud has no (k+1)-th valid point."""
    d = ((cents[:, :, None, :].astype(np.float64)
          - xyz[:, None].astype(np.float64)) ** 2).sum(-1)
    if mask is not None:
        d = np.where(mask[:, None, :], d, np.inf)
    d = np.sort(d, axis=-1)
    d = np.concatenate([d, np.full(d.shape[:-1] + (1,), np.inf)], -1)
    gaps = 1 if gaps is None else gaps
    lo, hi = d[..., k - gaps:k], d[..., k - gaps + 1:k + 1]
    with np.errstate(invalid="ignore", divide="ignore"):
        rel = np.where(np.isfinite(hi), (hi - lo) / np.maximum(hi, 1e-30), 1.0)
    return float(rel.min()) if rel.size else 1.0


def stage_margins(xyz, k=24, stages=4):
    """knn_margin of each PointMLP stage's FPS centroids (the port's plain
    FPS, halving the points at every stage) among that stage's points."""
    from pointcloud_tpu_torch.ops.fps import fps_reference

    out = []
    for _ in range(stages):
        idx = fps_reference(torch.from_numpy(xyz), xyz.shape[1] // 2).numpy()
        cents = np.take_along_axis(xyz, idx[..., None].astype(np.int64), 1)
        out.append(knn_margin(xyz, cents, k))
        xyz = cents
    return out


def fps_centroids(xyz, npoint, mask=None):
    """The FPS centroids (the port's plain version) of numpy clouds."""
    from pointcloud_tpu_torch.ops.fps import fps_reference

    idx = fps_reference(torch.from_numpy(xyz), npoint,
                        None if mask is None else torch.from_numpy(mask))
    return np.take_along_axis(xyz, idx.numpy()[..., None].astype(np.int64), 1)


def record_pool_gaps(monkeypatch, distinct=False):
    """Make every plain pool pass of the fused chain (mlp_pool_fused,
    preextract_pool_fused on CPU tensors) record the smallest gap between a
    group's best and second-best value, over all groups and channels, into
    the returned list: where two rows lie within round-off the two packages
    may send a pooled gradient to different rows. With `distinct`, the
    second-best is the best value below the best: rows that tie exactly
    (PointMLP's, whose every input channel a ReLU zeroed) compute the same
    operations on the same values in either package, and both send the
    gradient to the lowest of them."""
    from pointcloud_tpu_torch.ops import preextract_fused as tpf

    gaps, plain_pool = [], tpf.bn_pool_reference

    def recording_pool(h, sc, pen, pool, final_relu=True, res=None):
        v = tpf._with_residual(tpf._bn_pre(h, sc), res)
        if pen is not None:
            v = v - pen[..., None]
        v = v.detach().reshape(h.shape[0], -1, pool, h.shape[2])
        best = v.amax(dim=2, keepdim=True)
        if distinct:
            second = torch.where(v < best, v, -torch.inf).amax(dim=2, keepdim=True)
        else:
            second = torch.topk(v, 2, dim=2).values[:, :, 1:]
        gaps.append(float((best - second).min()))
        return plain_pool(h, sc, pen, pool, final_relu, res)

    monkeypatch.setattr(tpf, "_PLAIN", (*tpf._PLAIN[:2], recording_pool))
    return gaps


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
