"""The plain reference of the benchmark's configurations, in float32 PyTorch.

It follows the published descriptions as the reference repository wires
them, with no kernel, no fused chain and no batching trick:

* PointNet++ SSG (Qi et al., NeurIPS 2017): per set-abstraction level,
  farthest-point sampling of the centroids, the first `nsample` points within
  the radius of each centroid (index order, empty slots repeating the first),
  centred xyz beside the features, a shared Dense + BatchNorm + ReLU stack and
  a max over each group; a group-all level at the end.
* PointNet (Qi et al., CVPR 2017): a 3x3 input transform and a 64x64
  feature transform, each predicted by a small PointNet (per-point layers,
  a max pool, two fully connected layers, a head starting at the identity),
  shared per-point layers, and a last 128 -> 1024 layer whose BatchNorm is
  max-pooled without a ReLU.
* The autoencoder: a Dense bottleneck, the fully connected decoder with a
  sigmoid output, the Chamfer distance over all six dimensions or the Earth
  Mover's Distance by entropic optimal transport on xyz (Sinkhorn, then each
  point's best target) plus the matched features' squared error, and Adam.
* The sensor: the bounding-box filter and farthest-point sampling of a
  camera cloud, then the bbox normalisation of the encoder.

Parameters are a flat dict of float32 tensors under the names that the
program's modules register, so that the benchmark can hand one set of
weights to both. Every product goes through a `Precision`: float32 with
TF32 off for the reference, or each operand rounded to float8 (e4m3, one
scale a tensor) for the control. Nothing here imports the program or JAX.
"""

from __future__ import annotations

import math
import re

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BN_EPS = 1e-5
MOMENTUM = 0.9
_FP8_MAX = 448.0  # largest finite float8_e4m3fn


class Precision:
    """The products' precision. `low=False`: float32 throughout. `low=True`:
    the products that the configuration runs in bf16 take float8 e4m3
    operands (each tensor scaled by its largest magnitude), the step below
    bf16 that would tempt a later change. Products the program keeps in
    float32 (the bottleneck and the decoder's last layer) stay float32."""

    def __init__(self, low: bool = False):
        self.low = low

    @staticmethod
    def _fp8(t):
        scale = t.detach().abs().amax().clamp_min(1e-30) / _FP8_MAX
        q = (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
        # straight through: the rounding carries no gradient of its own
        return t + (q - t).detach()

    def mm(self, a, b, reduced=True):
        if self.low and reduced:
            return torch.matmul(self._fp8(a), self._fp8(b))
        return torch.matmul(a, b)


FP32 = Precision(False)


############################## parameters ##############################


def _dense(name, cin, cout, bias=True, zero=False):
    out = [(f"{name}.weight", (cout, cin), "zeros" if zero else ("lecun", cin))]
    if bias:
        out.append((f"{name}.bias", (cout,), "zeros"))
    return out


def _bn_spec(name, c):
    return [(f"{name}.scale", (c,), "ones"), (f"{name}.bias", (c,), "zeros"),
            (f"{name}.mean", (c,), "zeros"), (f"{name}.var", (c,), "ones")]


def _chain(name, layout):
    out = []
    for i, (cin, co) in enumerate(layout):
        out += [(f"{name}.w{i}", (cin, co), ("lecun", cin)),
                (f"{name}.scale{i}", (co,), "ones"), (f"{name}.offset{i}", (co,), "zeros"),
                (f"{name}.mean{i}", (co,), "zeros"), (f"{name}.var{i}", (co,), "ones")]
    return out


def _pointwise(name, cin, widths):
    out = []
    for i, w in enumerate(widths):
        out += _dense(f"{name}.Dense_{i}", cin, w) + _bn_spec(f"{name}.BatchNorm_{i}", w)
        cin = w
    return out


def _dense_bn_pool(name, cin, cout):
    return _dense(name, cin, cout) + [
        (f"{name}.scale", (cout,), "ones"), (f"{name}.offset", (cout,), "zeros"),
        (f"{name}.mean", (cout,), "zeros"), (f"{name}.var", (cout,), "ones")]


def _stn(name, cin, k, cfg):
    s = cfg["stn"]
    out = _pointwise(f"{name}.PointwiseMLP_0", cin, s["point"])
    out += _dense_bn_pool(f"{name}.DenseBNMaxPool_0", s["point"][-1], s["pooled"])
    c = s["pooled"]
    for i, w in enumerate(s["head"]):
        out += _dense(f"{name}.Dense_{i}", c, w) + _bn_spec(f"{name}.BatchNorm_{i}", w)
        c = w
    return out + _dense(f"{name}.Dense_{len(s['head'])}", c, k * k, zero=True)


def param_specs(cfg) -> list:
    """(name, shape, init) of every parameter and BatchNorm statistic of the
    configuration's autoencoder; init is ("lecun", fan_in), "zeros" or
    "ones"."""
    d = cfg["point_dims"]
    b = "encoder.backbone"
    if cfg["backbone"] == "PointNet2":
        specs, feats = [], d - 3
        for i, lv in enumerate(cfg["sa"]):
            specs += _chain(f"{b}.SetAbstraction_{i}",
                            list(zip((3 + feats, *lv["mlp"][:-1]), lv["mlp"])))
            feats = lv["mlp"][-1]
    elif cfg["backbone"] == "PointNet":
        k = cfg["mlp0"][-1]
        specs = _stn(f"{b}.stn", d, 3, cfg)
        specs += _pointwise(f"{b}.mlp0", d, cfg["mlp0"])
        specs += _stn(f"{b}.fstn", k, k, cfg)
        specs += _pointwise(f"{b}.mlp1", k, cfg["mlp1"])
        specs += _dense_bn_pool(f"{b}.dbnpool2", cfg["mlp1"][-1], cfg["encoding"])
    else:
        raise ValueError(f"no reference for backbone {cfg['backbone']!r}")
    specs += _dense("encoder.MLP_0.Dense_0", cfg["encoding"], cfg["bottleneck"])
    c = cfg["bottleneck"]
    widths = [*cfg["decoder_hidden"], cfg["points"] * cfg["point_dims"]]
    for i, w in enumerate(widths):
        specs += _dense(f"decoder.MLP_0.Dense_{i}", c, w)
        c = w
    return specs


def make_weights(cfg, seed: int, device) -> dict:
    """Every parameter and statistic from `seed`, on `device`, float32, in
    a few large calls on a generator on that device: one truncated normal
    (two standard deviations) for all lecun-normal products, each scaled to
    variance 1 / fan_in as flax's lecun_normal does."""
    specs = param_specs(cfg)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    lecun = [(n, s, i[1]) for n, s, i in specs if isinstance(i, tuple)]
    total = sum(math.prod(s) for _, s, _ in lecun)
    flat = torch.empty(total, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    out, at = {}, 0
    for name, shape, fan_in in lecun:
        n = math.prod(shape)
        # 0.8796...: the standard deviation of a unit normal cut at +-2
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        out[name] = flat[at:at + n].view(shape) * std
        at += n
    for name, shape, init in specs:
        if init == "zeros":
            out[name] = torch.zeros(shape, dtype=torch.float32, device=device)
        elif init == "ones":
            out[name] = torch.ones(shape, dtype=torch.float32, device=device)
    return {name: out[name] for name, _, _ in specs}


def is_statistic(name: str) -> bool:
    """A BatchNorm running statistic (a buffer, not a parameter)."""
    return re.fullmatch(r"(mean|var)\d*", name.rsplit(".", 1)[1]) is not None


############################## geometry ##############################


def normalize(pc, bbox):
    """The first three dims from the bbox into the unit cube."""
    bb = torch.tensor(bbox, dtype=torch.float32, device=pc.device)
    lo, span = bb[:, 0], bb[:, 1] - bb[:, 0]
    return torch.cat([(pc[..., :3] - lo) / span, pc[..., 3:]], dim=-1)


def fps(xyz, npoint: int, mask=None):
    """Farthest-point sampling from the first valid point: each step takes the
    valid point farthest from those taken, by ((dx^2 + dy^2) + dz^2), the
    lowest index on ties. xyz (B, N, >=3) -> (B, npoint) long."""
    B, N, _ = xyz.shape
    x, y, z = (xyz[..., c].float() for c in range(3))
    valid = torch.ones((B, N), dtype=torch.bool, device=xyz.device) if mask is None else mask
    ids = torch.arange(N, device=xyz.device).expand(B, N)
    rows = torch.arange(B, device=xyz.device)
    first = torch.where(valid, ids, N).amin(dim=1)
    last = torch.where(first == N, 0, first)
    mind = torch.where(valid, 1e10, -1.0)
    out = [last]
    for _ in range(1, npoint):
        dx = x - x[rows, last, None]
        dy = y - y[rows, last, None]
        dz = z - z[rows, last, None]
        d = (dx * dx + dy * dy) + dz * dz
        mind = torch.where(valid, torch.minimum(mind, d), -1.0)
        top = mind.amax(dim=1, keepdim=True)
        last = torch.where(mind == top, ids, N).amin(dim=1)
        out.append(last)
    return torch.stack(out, dim=1)


def gather(points, idx):
    """points (B, N, C), idx (B, *I) -> (B, *I, C)."""
    B, C = points.shape[0], points.shape[-1]
    flat = idx.reshape(B, -1, 1).long().expand(-1, -1, C)
    return torch.gather(points, 1, flat).reshape(*idx.shape, C)


def ball_query(xyz, centres, radius: float, k: int):
    """The first k points (index order) with ((dx^2 + dy^2) + dz^2) <=
    radius^2 from each centre (centre minus point); slots past the count
    repeat the first. -> (idx (B, S, k) long, valid (B, S, k) bool)."""
    r2 = torch.tensor(radius * radius, dtype=torch.float32, device=xyz.device)
    d = None
    for c in range(3):
        dc = centres[..., c, None] - xyz[:, None, :, c]
        d = dc * dc if d is None else d + dc * dc
    inside = d <= r2
    N = xyz.shape[1]
    key = torch.where(inside, torch.arange(N, device=xyz.device), N)
    first = torch.topk(key, min(k, N), dim=-1, largest=False, sorted=True).values
    valid = first < N
    idx = torch.where(valid, first, first[..., :1])
    return idx, valid


############################## models ##############################


def dense(P, name, x, prec, reduced=True):
    w = P[f"{name}.weight"]
    y = prec.mm(x, w.t(), reduced)
    b = P.get(f"{name}.bias")
    return y if b is None else y + b


def batch_norm(P, x, names, train):
    """flax BatchNorm over the last axis; names = (scale, bias, mean, var)
    of P. Eval (`train` False) reads the running statistics; train mode the
    batch's (biased variance, E[x^2] - E[x]^2). A dict as `train` runs in
    train mode and records the batch statistics in it under the running
    statistics' names."""
    scale, bias, mean, var = (P[n] for n in names)
    if train is not False:
        red = tuple(range(x.dim() - 1))
        mean = x.mean(dim=red)
        var = torch.clamp((x * x).mean(dim=red) - mean * mean, min=0.0)
        if isinstance(train, dict):
            train[names[2]], train[names[3]] = mean.detach(), var.detach()
    return (x - mean) * (torch.rsqrt(var + BN_EPS) * scale) + bias


def _bn(P, name, x, train, bias="bias"):
    return batch_norm(P, x, tuple(f"{name}.{v}" for v in ("scale", bias, "mean", "var")),
                      train)


def set_abstraction(P, name, lv, xyz, feats, train, prec):
    """One SA level -> (new xyz, pooled features (B, S, C))."""
    B, N, _ = xyz.shape
    if lv.get("group_all"):
        new_xyz = torch.zeros((B, 1, 3), device=xyz.device)
        grouped = torch.cat([xyz, feats], -1)[:, None]
        valid = torch.ones(grouped.shape[:3], dtype=torch.bool, device=xyz.device)
    else:
        new_xyz = gather(xyz, fps(xyz, lv["npoint"]))
        idx, valid = ball_query(xyz, new_xyz, lv["radius"], lv["nsample"])
        grouped = torch.cat([gather(xyz, idx) - new_xyz[:, :, None], gather(feats, idx)], -1)
    h = grouped
    L = len(lv["mlp"])
    for i in range(L):
        if i:
            h = torch.relu(h)
        h = prec.mm(h, P[f"{name}.w{i}"])
        h = batch_norm(P, h, tuple(f"{name}.{v}{i}" for v in
                                   ("scale", "offset", "mean", "var")), train)
    h = h.masked_fill(~valid[..., None], -1e9)
    return new_xyz, torch.relu(h.amax(dim=2))


def pointnet2_encode(P, cfg, x, train, prec):
    xyz, feats = x[..., :3], x[..., 3:]
    for i, lv in enumerate(cfg["sa"]):
        xyz, feats = set_abstraction(P, f"encoder.backbone.SetAbstraction_{i}", lv, xyz,
                                     feats, train, prec)
    return feats[:, 0]


def _pointwise_fwd(P, name, x, n, train, prec):
    for i in range(n):
        x = torch.relu(_bn(P, f"{name}.BatchNorm_{i}",
                           dense(P, f"{name}.Dense_{i}", x, prec), train))
    return x


def _dense_bn_pool_fwd(P, name, x, train, prec, final_relu):
    h = _bn(P, name, dense(P, name, x, prec), train, bias="offset").amax(dim=-2)
    return torch.relu(h) if final_relu else h


def _stn_fwd(P, name, x, k, cfg, train, prec):
    s = cfg["stn"]
    h = _pointwise_fwd(P, f"{name}.PointwiseMLP_0", x, len(s["point"]), train, prec)
    h = _dense_bn_pool_fwd(P, f"{name}.DenseBNMaxPool_0", h, train, prec, True)
    for i in range(len(s["head"])):
        h = torch.relu(_bn(P, f"{name}.BatchNorm_{i}", dense(P, f"{name}.Dense_{i}", h, prec),
                           train))
    h = dense(P, f"{name}.Dense_{len(s['head'])}", h, prec, reduced=False)
    eye = torch.eye(k, device=x.device).reshape(1, k * k)
    return (h + eye).reshape(-1, k, k)


def pointnet_encode(P, cfg, x, train, prec):
    b = "encoder.backbone"
    trans = _stn_fwd(P, f"{b}.stn", x, 3, cfg, train, prec)
    # both transforms are float32 products in the configuration
    x = torch.cat([prec.mm(x[..., :3], trans, False), x[..., 3:]], -1)
    x = _pointwise_fwd(P, f"{b}.mlp0", x, len(cfg["mlp0"]), train, prec)
    k = cfg["mlp0"][-1]
    x = prec.mm(x, _stn_fwd(P, f"{b}.fstn", x, k, cfg, train, prec), False)
    x = _pointwise_fwd(P, f"{b}.mlp1", x, len(cfg["mlp1"]), train, prec)
    return _dense_bn_pool_fwd(P, f"{b}.dbnpool2", x, train, prec, False)


def encode(P, cfg, x, train=False, prec=FP32):
    """The bottleneck of normalised clouds x (B, N, 6) -> (B, bottleneck)."""
    enc = pointnet2_encode if cfg["backbone"] == "PointNet2" else pointnet_encode
    return dense(P, "encoder.MLP_0.Dense_0", enc(P, cfg, x, train, prec), prec,
                 reduced=False)


def decode(P, cfg, z, prec=FP32):
    n = len(cfg["decoder_hidden"])
    for i in range(n):
        z = torch.relu(dense(P, f"decoder.MLP_0.Dense_{i}", z, prec))
    z = dense(P, f"decoder.MLP_0.Dense_{n}", z, prec, reduced=False)
    return torch.sigmoid(z).reshape(-1, cfg["points"], cfg["point_dims"])


def forward(P, cfg, x, train=False, prec=FP32):
    return decode(P, cfg, encode(P, cfg, x, train, prec), prec)


############################## losses ##############################


def _sqdist(x, y):
    """(B, N, M) squared distances over every dim, in direct differences."""
    d = None
    for c in range(x.shape[-1]):
        dc = x[:, :, None, c] - y[:, None, :, c]
        d = dc * dc if d is None else d + dc * dc
    return d


def _nearest(x, y, chunk):
    """Each x point's nearest y point (index), in chunks of clouds."""
    out = []
    for s in range(0, x.shape[0], chunk):
        out.append(_sqdist(x[s:s + chunk], y[s:s + chunk]).argmin(dim=2))
    return torch.cat(out)


def chamfer(pred, target, chunk=16):
    """Batch mean of the two directed mean squared nearest-neighbour
    distances over all dims; the gradient flows through the matched pairs."""
    with torch.no_grad():
        nx = _nearest(pred.detach(), target, chunk)
        ny = _nearest(target, pred.detach(), chunk)
    dx = ((pred - gather(target, nx)) ** 2).sum(-1).mean(1)
    dy = ((target - gather(pred, ny)) ** 2).sum(-1).mean(1)
    return (dx + dy).mean()


def _logsumexp(a, dim):
    """log(sum(exp(a))) over `dim`, shifted by the maximum. The shifted
    exponent is clamped at -87, where exp leaves float32's normal range: a
    clamped term adds at most 1.6e-38 to a sum of at least 1, which rounds
    away, and a CPU's exp is far slower on arguments that underflow."""
    m = a.amax(dim=dim, keepdim=True)
    return m.squeeze(dim) + (a - m).clamp_min_(-87.0).exp_().sum(dim=dim).log_()


def sinkhorn_assign(x, y, eps: float, iters: int, chunk=8):
    """Each x point's target under entropic optimal transport between equal
    weights on xyz: `iters` log-domain iterations from zero potentials (g
    from the old f, then f from the new g) at temperature eps, then the best
    target by f_i + g_j - C_ij (the lowest index on ties)."""
    out = []
    for s in range(0, x.shape[0], chunk):
        c = _sqdist(x[s:s + chunk, :, :3], y[s:s + chunk, :, :3])
        B, N, M = c.shape
        f = torch.zeros((B, N), device=c.device)
        g = torch.zeros((B, M), device=c.device)
        for _ in range(iters):
            g = eps * (-math.log(M) - _logsumexp((f[:, :, None] - c) / eps, dim=1))
            f = eps * (-math.log(N) - _logsumexp((g[:, None, :] - c) / eps, dim=2))
        out.append(torch.argmax(f[:, :, None] + g[:, None, :] - c, dim=2))
        del c
    return torch.cat(out)


def emd(pred, target, cfg):
    """The mean matched distance sqrt(|x - y_a|^2 + 1e-12) on xyz plus
    feature_weight-free mean squared error of the matched features (the
    reference's EMD loss without classes)."""
    lc = cfg["loss"]
    with torch.no_grad():
        a = sinkhorn_assign(pred.detach(), target, lc["eps"], lc["iterations"])
    matched = gather(target, a)
    d = ((pred[..., :3] - matched[..., :3]) ** 2).sum(-1)
    point = torch.sqrt(d + 1e-12).mean()
    feature = ((pred[..., 3:] - matched[..., 3:]) ** 2).mean()
    return point + feature


def loss(cfg, pred, target):
    return chamfer(pred, target) if cfg["loss"]["kind"] == "chamfer" else emd(pred, target, cfg)


############################## steps ##############################


def train_steps(cfg, weights, batches, prec=FP32):
    """Adam from `weights` over the raw batches (target = input): each step's
    loss, the first step's gradients, the parameters after the last step,
    and the BatchNorm batch statistics of the first step's forward (under the
    running statistics' names). Adam: betas, eps outside the square root,
    bias-corrected."""
    o = cfg["optimizer"]
    b1, b2 = o["betas"]
    P = {k: v.detach().clone() for k, v in weights.items()}
    params = [k for k in P if not is_statistic(k)]
    m = {k: torch.zeros_like(P[k]) for k in params}
    v = {k: torch.zeros_like(P[k]) for k in params}
    losses, first, stats = [], None, {}
    for t, raw in enumerate(batches, start=1):
        for k in params:
            P[k].requires_grad_(True)
        x = normalize(raw, cfg["bbox"])
        lv = loss(cfg, forward(P, cfg, x, stats if t == 1 else True, prec), x)
        grads = torch.autograd.grad(lv, [P[k] for k in params])
        losses.append(float(lv.detach()))
        if first is None:
            first = {k: g.detach().clone() for k, g in zip(params, grads)}
        with torch.no_grad():
            for k, g in zip(params, grads):
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                mh = m[k] / (1 - b1 ** t)
                vh = v[k] / (1 - b2 ** t)
                P[k] = (P[k] - o["lr"] * mh / (vh.sqrt() + o["eps"])).detach()
        del lv, grads, x
    return losses, first, {k: P[k] for k in params}, stats


@torch.no_grad()
def eval_step(cfg, weights, raw, prec=FP32):
    """(loss, output) of the eval-mode forward on the running statistics."""
    x = normalize(raw, cfg["bbox"])
    out = forward(weights, cfg, x, False, prec)
    return float(loss(cfg, out, x)), out


@torch.no_grad()
def calibrate_statistics(cfg, weights, raw) -> dict:
    """The weights with every BatchNorm running statistic set to the batch
    statistics of one train-mode forward over `raw`, as a trained model's
    would hold statistics of its data."""
    stats = {}
    forward(weights, cfg, normalize(raw, cfg["bbox"]), stats)
    return {**weights, **stats}


@torch.no_grad()
def sense(cloud, bbox, K: int):
    """The sensor's chain on one raw cloud (N, 6): the points inside the bbox
    (bounds included), then K of them by farthest-point sampling."""
    bb = torch.tensor(bbox, dtype=torch.float32, device=cloud.device)
    inside = ((cloud[:, :3] >= bb[:, 0]) & (cloud[:, :3] <= bb[:, 1])).all(dim=1)
    idx = fps(cloud[None, :, :3], K, inside[None])[0]
    return cloud[idx]
