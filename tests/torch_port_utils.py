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
    may send a pooled gradient to different rows. Groups without a valid
    row (the -1e9 sentinel, no gradient) are left out. With `distinct`, the
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
        # a group without a valid row pools to the -1e9 sentinel and sends
        # no gradient: its rows' gaps do not count
        gap = (best - second).masked_fill(best < -5e8, torch.inf)
        gaps.append(float(gap.min()))
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


MSG_RADII = ((0.1, 0.2, 0.4), (0.2, 0.4, 0.8))  # PointNet2MSGEncoder's levels


def msg_spec(device="cpu", seed=0):
    """The port's TrainSpec of the multi-scale-grouping PointNet2
    autoencoder, wired as `create_model("Autoencoder", ..., "Cube",
    loss_override="chamfer")` wires the factory's backbones (the factory has
    no MSG entry, as the JAX package's has none)."""
    from pointcloud_tpu_torch import cfg
    from pointcloud_tpu_torch.data import PointCloudDataset
    from pointcloud_tpu_torch.envs.scenes import scene_config
    from pointcloud_tpu_torch.losses import ChamferDistance
    from pointcloud_tpu_torch.models import AE, PointNet2MSGEncoder
    from pointcloud_tpu_torch.models.layers import init_flax_
    from pointcloud_tpu_torch.train.harness import TrainSpec
    from pointcloud_tpu_torch.transforms import Normalize

    device = torch.device(device)
    sc = scene_config("Cube")
    dtype = cfg.compute_dtype(device)
    model = AE(PointNet2MSGEncoder(feature_dims=3, dtype=dtype),
               out_points=sc.sample_points, out_dim=6,
               bottleneck=sum(sc.class_latent_dim), dtype=dtype)
    init_flax_(model, torch.Generator().manual_seed(seed))
    return TrainSpec(model=model.to(device).eval(), loss=ChamferDistance(),
                     open_dataset=lambda input_dir: PointCloudDataset(
                         root_dir=input_dir, in_features=["rgb"], out_features=["rgb"]),
                     in_transform=Normalize(sc.bbox),
                     out_transform=Normalize(sc.bbox), model_type="Autoencoder",
                     backbone="PointNet2MSG", scene_name="Cube", scene=sc)


def jax_msg_spec():
    """The JAX package's TrainSpec of the same model, from its own classes."""
    from pointcloud_tpu import cfg
    from pointcloud_tpu.envs.scenes import scene_config
    from pointcloud_tpu.losses import ChamferDistance
    from pointcloud_tpu.models import AE, PointNet2MSGEncoder
    from pointcloud_tpu.train.harness import TrainSpec
    from pointcloud_tpu.transforms import Normalize

    sc = scene_config("Cube")
    dtype = cfg.compute_dtype()
    model = AE(PointNet2MSGEncoder(feature_dims=3, dtype=dtype),
               out_points=sc.sample_points, out_dim=6,
               bottleneck=sum(sc.class_latent_dim), dtype=dtype)
    return TrainSpec(model=model, loss=ChamferDistance(), open_dataset=None,
                     in_transform=Normalize(sc.bbox),
                     out_transform=Normalize(sc.bbox), model_type="Autoencoder",
                     backbone="PointNet2MSG", scene_name="Cube", scene=sc)


def msg_flips(xyz):
    """For each of PointNet2MSGEncoder's six (level, radius) pairs (level
    1's FPS centroids (512) among the points, level 2's (128) among level
    1's), the number of (centroid, point) pairs whose ball membership
    differs between the JAX package's XLA `ball_query` (the fp32 matmul
    expansion of the distance) and the port's direct differences. A float64
    margin of 1e-5 of r^2 cannot be had at 1024 points a cloud (level 1's
    r = 0.4 tests a million pairs; over 40 seeds its median margin is
    2.5e-6), so the tests assert this count instead: 0 at every level."""
    import jax.numpy as jnp

    from pointcloud_tpu.ops.geometry import pairwise_sqdist
    from pointcloud_tpu_torch.ops.geometry import penalised_sqdist

    c1 = fps_centroids(xyz, 512)
    c2 = fps_centroids(c1, 128)
    out = []
    for pts, cents, radii in ((xyz, c1, MSG_RADII[0]), (c1, c2, MSG_RADII[1])):
        jd = np.asarray(pairwise_sqdist(jnp.asarray(cents), jnp.asarray(pts)))
        td = to_np(penalised_sqdist(torch.from_numpy(pts), torch.from_numpy(cents),
                                    None))
        for r in radii:
            r2 = np.float32(r * r)
            out.append(int(((jd <= r2) != (td <= r2)).sum()))
    return out


def msg_clouds(seed, sc, n=1024):
    """Inputs x and targets y (B=2 clouds of n points, numpy) for the MSG
    slice tests, asserting that the seed's normalised clouds have no
    membership flip (`msg_flips`)."""
    from pointcloud_tpu_torch.transforms import Normalize

    x = raw_clouds(np.random.default_rng(seed), sc, 2, n)
    y = raw_clouds(np.random.default_rng(seed + 100), sc, 2, n)
    xyz = to_np(Normalize(sc.bbox)(torch.from_numpy(x))[0])[..., :3].copy()
    assert msg_flips(xyz) == [0] * 6
    return x, y


def record_dense_pool_gaps(monkeypatch):
    """Make every plain `dense_pool_stats` (DenseBNMaxPool in train mode on
    CPU tensors) record the smallest gap between a block's best and
    second-best value of sign * z - pen, over all blocks and channels, into
    the returned list (see record_pool_gaps)."""
    from pointcloud_tpu_torch.ops import dense_bn_pool as tdp

    gaps, plain = [], tdp.dense_pool_stats_reference

    def recording(x, w, bias, sign, pen, pool):
        out = plain(x, w, bias, sign, pen, pool)
        z = (torch.matmul(x.float(), w.float()) + bias.float()).to(x.dtype).float()
        zs = z.detach() * sign
        if pen is not None:
            zs = zs - pen[..., None]
        top2 = torch.topk(zs.reshape(x.shape[0], -1, pool, w.shape[1]), 2, dim=2).values
        gaps.append(float((top2[:, :, 0] - top2[:, :, 1]).min()))
        return out

    monkeypatch.setattr(tdp, "dense_pool_stats_reference", recording)
    return gaps


def bulk_pieces(k, row_bytes, tile):
    """row_move.cuh's move_bulk walk of one run of k rows of `row_bytes`
    bytes (a multiple of 16) through a tile of `tile` bytes, piece by piece:
    (the piece's first byte in the run, its bytes, [(byte in the piece, row,
    byte in the row, bytes) of each bulk copy into it]). A piece fills half
    the tile; each row, or each part of a row, inside it is one copy."""
    half = (tile // 2) & ~15
    total = k * row_bytes
    out = []
    for p0 in range(0, total, half):
        pn = min(half, total - p0)
        copies = []
        for j in range(p0 // row_bytes, (p0 + pn - 1) // row_bytes + 1):
            r0 = j * row_bytes
            s, e = max(p0, r0), min(p0 + pn, r0 + row_bytes)
            copies.append((s - p0, j, s - r0, e - s))
        out.append((p0, pn, copies))
    return out


def word_walk(k, wpr, head, tile_words, per):
    """row_move.cuh's move_words walk of one run of k rows of `wpr` words
    through a tile of `tile_words` words, `head` words of the run before the
    output's first 16-byte boundary, `per` words a 16-byte chunk, piece by
    piece: (the piece's first word in the run, its words, [(tile position,
    word e of the run, row, word in the row) each lane loads, four in flight,
    lane by lane], [(first word of each 16-byte chunk stored, whether it is
    stored whole)])."""
    total = k * wpr
    jd, wd = divmod(32, wpr)
    out = []
    p0 = head - per if head > 0 else 0
    while p0 < total:
        pn = min(tile_words, total - p0)
        fills = []
        for lane in range(32):
            e = p0 + lane
            j = e // wpr  # floor division, as the kernel's
            w = e - j * wpr
            for i in range(lane, pn, 128):
                for u in range(4):
                    if e >= 0 and i + 32 * u < pn:
                        fills.append((i + 32 * u, e, j, w))
                    e, j, w = e + 32, j + jd, w + wd
                    if w >= wpr:
                        w, j = w - wpr, j + 1
        chunks = [(p0 + q * per, p0 + q * per >= 0 and p0 + (q + 1) * per <= total)
                  for q in range(-(-pn // per))]
        out.append((p0, pn, fills, chunks))
        p0 += tile_words
    return out


def assemble_bulk(rows, idx_row, tile):
    """One run (k, row bytes) assembled from the source rows `rows` (N,
    row bytes) uint8 by bulk_pieces for the slots idx_row (k,)."""
    k, R = len(idx_row), rows.shape[1]
    run = np.full(k * R, 0xAB, np.uint8)
    for p0, _, copies in bulk_pieces(k, R, tile):
        for off, j, src, n in copies:
            run[p0 + off:p0 + off + n] = rows[idx_row[j], src:src + n]
    return run.reshape(k, R)


def assemble_words(words, idx_row, head, tile_words, per):
    """One run (k, wpr) assembled by word_walk from the source rows `words`
    (N, wpr) for the slots idx_row (k,): the tile filled lane by lane, then
    stored chunk by chunk (whole, or word by word inside the run)."""
    k, wpr = len(idx_row), words.shape[1]
    total = k * wpr
    run = np.zeros(total, words.dtype)
    stored = np.zeros(total, np.int64)
    for p0, pn, fills, chunks in word_walk(k, wpr, head, tile_words, per):
        tile = np.zeros(-(-pn // per) * per, words.dtype)
        for pos, _, j, w in fills:
            tile[pos] = words[idx_row[j], w]
        for e0, _ in chunks:
            for i in range(per):
                if 0 <= e0 + i < total:
                    run[e0 + i] = tile[e0 - p0 + i]
                    stored[e0 + i] += 1
    assert (stored == 1).all()
    return run.reshape(k, wpr)
