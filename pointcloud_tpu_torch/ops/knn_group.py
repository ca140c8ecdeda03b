"""Exact kNN grouping with the row gather: CUDA kernel, plain version,
wrapper.

Port of pointcloud_tpu/ops/pallas_kernels.py:_group_knn_smajor_kernel, both
entry points: `grouped_gather_knn` (grouped xyz and features) and
`grouped_gather_knn_feats` (features only, the LocalGrouper path). The
kernel is csrc/knn_group.cu; its note states the design and the bound.
`knn_group` launches it for CUDA tensors and takes the plain version
`knn_group_reference` only for CPU tensors. Its gradient (a port of
`_gg_knn_bwd` / `_gg_knnf_bwd`) is one `scatter_rows` of the grouped
cotangent back onto the points, on either device.

Selection follows the TPU kernel: the distance is ((pen + dx^2) + dy^2) +
dz^2 on direct differences (centroid minus point), pen = 1e9 on masked
points; slot order is distance order with the lowest index first on ties;
the valid count is the number of distances below 0.5e9, and slots past it
repeat slot 0. (The JAX package's XLA `knn` uses the matmul expansion, which
can swap points whose distances lie within a few ulps.) The TPU kernel's
`k % 8 == 0` gate was an 8-slot store alignment of its VMEM tiles and does
not apply here: any k >= 1 and any N. In bf16 the TPU kernel carries the
grouped xyz as split-bf16 hi + lo (16 significant bits); the port gathers it
exactly.

`knn_group_plan` sizes the launch from the shape alone: the list route (k
up to 64 and a cloud that fits shared memory) or the first version's rounds
route, the blocks, the tile, how the rows leave and the shared memory as the
kernel lays them out; `knn_list_mirror` is the list route's selection in
plain PyTorch, step for step.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from pointcloud_tpu_torch.ops import _build
from pointcloud_tpu_torch.ops._launch import SMEM_LIMIT, SMS
from pointcloud_tpu_torch.ops.geometry import index_points, penalised_sqdist
from pointcloud_tpu_torch.ops.scatter_rows import scatter_grouped

_PEN = 1e9
_MAX_BATCH = 65535  # gridDim.y
_MAX_POINTS = 1 << 30  # N stays a C int with room for the chunk arithmetic
_LIST_WARPS = 16  # csrc/knn_group.cu kListWarps
_LIST_CAP = 64  # the longest list: two keys a lane
_TILE = 4096  # largest tile of a warp's output run, bytes
_BULK_ROW = 256  # bytes of the narrowest row that bulk copies move faster
_ROWS = {"words": 0, "bulk": 1, "prefetch": 2}  # csrc/knn_group.cu kRows*
_SMEM_SM = 233_472  # shared memory of an H100 SM (228 KB)
_BLOCKS_PER_SM = 2  # the list kernel's launch bounds: 2 blocks of 512 threads
_ROUNDS_WARPS = 8  # csrc/knn_group.cu kWarps
_ROUNDS_SHARED = 160 * 1024  # the rounds route stages clouds up to this size
_ROUTES = {"list": 0, "rounds": 1, "global": 2}


class KnnPlan(NamedTuple):
    """The launch geometry of one `knn_group` call (csrc/knn_group.cu)."""
    route: str  # "list", "rounds" (cloud in shared memory) or "global"
    threads: int  # threads a block
    keys: int  # list keys a lane (1: k <= 32, 2: k <= 64; 0 on the rounds routes)
    per_block: int  # centroids a block
    blocks: int  # blocks a cloud
    tile: int  # bytes of a warp's tile of an output run (list route)
    rows: str  # list route: how the feature rows leave, "prefetch", "bulk" or "words"
    smem: int  # dynamic shared memory a block, bytes, as the kernel lays it out


def _list_smem(N: int, keys: int, tile: int) -> int:
    """csrc/knn_group.cu's list-route shared memory: 16 warps' mbarriers, 16
    warps' lists and buffers of 32 * keys 8-byte keys, 16 warps' tiles, 16
    bytes a staged point in rows of 32."""
    return (_LIST_WARPS * 8 + _LIST_WARPS * 2 * 32 * keys * 8 + _LIST_WARPS * tile
            + 16 * 32 * -(-N // 32))


@functools.lru_cache(maxsize=256)
def knn_group_plan(B: int, N: int, S: int, k: int, F: int, dtype, word: int = 16,
                   with_xyz: bool = False) -> KnnPlan:
    """The launch of `knn_group` for B clouds of N points with F feature
    channels in `dtype` (fp32 or bf16; F = 0 without features), S centroids,
    k neighbours each; `word` is the widest word (2, 4, 8 or 16 bytes) that
    divides a feature row and both feature base addresses, `with_xyz` asks
    for the grouped xyz.

    The list route takes k <= 64 (one key a lane up to 32, two up to 64)
    where a block of 16 warps holds the staged cloud (16 bytes a point, in
    rows of 32) beside each warp's list, buffer and tile. Its tile holds a
    whole run (the features', or the xyz rows') and 16 bytes, at most 4 KB,
    a multiple of 32. Feature rows of 16-byte words whose run fits the tile
    (without xyz) are prefetched while the warp selects its next centroid;
    wider runs of rows of 256 bytes or more go by bulk copies, the rest as
    words (measured on the card: each way is the fastest on its rows). A
    warp selects one centroid at a time; of the blocks a cloud, the plan
    takes the least waves of resident blocks times centroids a warp (the
    fewest blocks on a tie). Other shapes take the first version's rounds
    route: 8 warps a block, a warp a few centroids one after another
    (`per_block` / 8), the cloud in shared memory up to 160 KB, else read
    from global memory.

    Raises ValueError for shapes no launch takes (B outside 1..65,535, N
    outside 1..2^30 - 1, S or k below 1, F below 0, `word` not 2, 4, 8 or
    16 or not dividing a row) and TypeError for other dtypes."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"knn_group kernel takes fp32 or bf16 features; got {dtype}")
    if not (1 <= B <= _MAX_BATCH and 1 <= N < _MAX_POINTS and S >= 1 and k >= 1
            and F >= 0) or word not in (2, 4, 8, 16):
        raise ValueError(f"knn_group kernel bounds exceeded: B={B} N={N} S={S} k={k} "
                         f"F={F} word={word}")
    row = F * (2 if dtype == torch.bfloat16 else 4)
    if row % word:
        raise ValueError(f"knn_group: feature rows of {row} bytes are not a whole "
                         f"number of {word}-byte words")
    keys = 1 if k <= 32 else 2
    run = max(k * row, 12 * k if with_xyz else 0)
    tile = max(32, min(_TILE, -(-(run + 16) // 32) * 32))
    rows = "words"
    if F > 0 and word == 16:
        if not with_xyz and k * row <= tile:
            rows = "prefetch"
        elif row >= _BULK_ROW:
            rows = "bulk"
    smem = _list_smem(N, keys, tile)
    if k <= _LIST_CAP and smem <= SMEM_LIMIT:
        resident = max(1, min(_BLOCKS_PER_SM, _SMEM_SM // (smem + 1024)))
        best = None
        for want in range(1, max(1, min(-(-S // _LIST_WARPS), 4 * SMS)) + 1):
            per_block = -(-S // want)
            blocks = -(-S // per_block)
            iters = -(-per_block // _LIST_WARPS)
            waves = -(-B * blocks // (resident * SMS))
            cost = (waves * iters, blocks)
            if best is None or cost < best[0]:
                best = (cost, KnnPlan("list", _LIST_WARPS * 32, keys, per_block, blocks,
                                      tile, rows, smem))
        return best[1]
    # the first version's geometry: a few centroids a warp where the batch
    # gives blocks enough to fill the card
    per_warp = 1
    while per_warp < 8 and B * -(-S // (2 * per_warp * _ROUNDS_WARPS)) >= 1056:
        per_warp *= 2
    per_block = per_warp * _ROUNDS_WARPS
    smem = 4 * 32 * ((-(-N // 32)) | 1) * 4
    shared = smem <= _ROUNDS_SHARED
    return KnnPlan("rounds" if shared else "global", _ROUNDS_WARPS * 32, 0, per_block,
                   -(-S // per_block), 0, "words", smem if shared else 0)


def plan_args(p: KnnPlan) -> tuple:
    """The plan as csrc/knn_group.cu's entry takes it, after `word`."""
    return (_ROUTES[p.route], p.keys, p.per_block, p.blocks, p.tile, _ROWS[p.rows],
            p.smem)


def knn_select(d, k: int):
    """The TPU kernel's selection from penalised distances d (B, S, N):
    idx (B, S, k) int32 in distance order, the lowest index first on ties
    (a stable sort), slots past the count of d < 0.5e9 repeating slot 0."""
    N = d.shape[-1]
    order = torch.sort(d, dim=-1, stable=True).indices[..., :k]
    if k > N:
        order = torch.cat([order, order[..., :1].expand(*order.shape[:-1], k - N)], -1)
    count = (d < 0.5 * _PEN).sum(dim=-1, keepdim=True)
    slots = torch.arange(k, device=d.device)
    return torch.where(slots < count, order, order[..., :1]).int()


def bitonic_sort_desc(v):
    """csrc/knn_group.cu's sort_desc on keys v (..., 32 * kP) (element e =
    p * 32 + lane), step for step: the same compare-exchanges in the same
    order, descending."""
    n = v.shape[-1]
    e = torch.arange(n)
    s = 2
    while s <= n:
        j = s // 2
        while j > 0:
            o = v[..., e ^ j]
            asc = (e & s) != 0
            keep_min = ((e & j) == 0) == asc
            v = torch.where(keep_min, torch.minimum(v, o), torch.maximum(v, o))
            j //= 2
        s *= 2
    return v


def bitonic_merge_asc(lst, v):
    """csrc/knn_group.cu's merge_asc: the 32 * kP least keys of the
    ascending list `lst` and the descending `v`, ascending, step for step."""
    n = v.shape[-1]
    e = torch.arange(n)
    out = torch.minimum(lst, v)
    j = n // 2
    while j > 0:
        o = out[..., e ^ j]
        out = torch.where((e & j) == 0, torch.minimum(out, o), torch.maximum(out, o))
        j //= 2
    return out


def _sort32(v, ascending: bool):
    """csrc/knn_group.cu's sort32 on values v (..., 32), step for step."""
    e = torch.arange(32)
    s = 2
    while s <= 32:
        j = s // 2
        while j > 0:
            o = v[..., e ^ j]
            asc = ((e & s) == 0) == ascending
            v = torch.where(((e & j) == 0) == asc, torch.minimum(v, o), torch.maximum(v, o))
            j //= 2
        s *= 2
    return v


def kth_of_64(a, b, k: int):
    """csrc/knn_group.cu's kth_of_64, step for step: the k-th least (1 <= k
    <= 64) of the 64 values a (..., 32) and b (..., 32)."""
    a, b = _sort32(a, True), _sort32(b, False)
    v = torch.maximum(a, b) if k > 32 else torch.minimum(a, b)
    e = torch.arange(32)
    j = 16
    while j > 0:
        o = v[..., e ^ j]
        v = torch.where((e & j) == 0, torch.minimum(v, o), torch.maximum(v, o))
        j //= 2
    return v[..., (k - 1) % 32]


def knn_list_mirror(d, k: int):
    """The list route's selection (csrc/knn_group.cu: lane_least, kth_of_64,
    select_list, flush, list_slots) in plain PyTorch, for penalised
    distances d (B, S, N) fp32: idx (B, S, k) int32. Lane l holds points l,
    l + 32, ...; one pass takes each lane's least key and second least
    distance; T is the k-th least of those 64 distances. The lanes whose
    second least lies above T give their least key where it is <= T, in
    lane order; the others, four at a time in lane order, every point of
    theirs at distance <= T, 32 points of each of the four a step (lane l's
    point l + 32 q at warp lane x, q = 32 h + 4 (x % 8) + x / 8, the order
    the kernel's conflict-free reads take). The keys join the buffer, which is first merged into the list
    (bitonic_sort_desc, bitonic_merge_asc) when they do not fit, and at the
    end. Keys as int64 (bits << 32 | index), the 64-bit unsigned order of
    the kernel's keys while the bits stay below 2^31 (distances are never
    negative)."""
    if k > _LIST_CAP:
        raise ValueError(f"the list route takes k <= {_LIST_CAP}; got {k}")
    B, S, N = d.shape
    cap = 32 if k <= 32 else 64
    none = (1 << 63) - 1  # int64 stand-in for the kernel's empty key
    inf = 0x7F800000
    bits = d.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    keys = (bits << 32) | torch.arange(N, dtype=torch.int64)
    # lane l's points: column l of the (-1, 32) view, padded with +inf
    pad = -N % 32
    lanes = torch.cat([keys, torch.full((B, S, pad), (inf << 32) | 0, dtype=torch.int64)],
                      -1).reshape(B, S, -1, 32)
    if lanes.shape[2] < 2:
        lanes = torch.cat([lanes, torch.full_like(lanes, inf << 32)], 2)
    two = torch.sort(lanes, dim=2).values[:, :, :2]  # least keys of each lane
    m1, m2 = two[:, :, 0], two[:, :, 1] >> 32
    t = kth_of_64(m1 >> 32, m2, k)
    valid_bits = int(torch.tensor(0.5 * _PEN, dtype=torch.float32).view(torch.int32))
    x32 = torch.arange(32)
    out = torch.empty((B, S, k), dtype=torch.int32)
    for b in range(B):
        for s in range(S):
            lst = torch.full((cap,), none, dtype=torch.int64)
            buf = []
            again = m2[b, s] <= t[b, s]
            found = [m1[b, s][(~again) & ((m1[b, s] >> 32) <= t[b, s])]]
            searched = torch.nonzero(again).flatten().tolist()
            for four in (searched[r:r + 4] for r in range(0, len(searched), 4)):
                # four lanes at once, 32 points of each a step: lane l's
                # point l + 32 q at warp lane x, q = 32 h + 4 (x % 8) + x / 8
                for h in range(0, -(-N // 1024)):
                    q = 32 * h + 4 * (x32 % 8) + x32 // 8
                    for lane in four:
                        i = lane + 32 * q
                        chunk = keys[b, s].index_select(0, i[i < N])
                        found.append(chunk[(chunk >> 32) <= t[b, s]])
            for group in found:
                if len(group) == 0:
                    continue
                if len(buf) + len(group) > cap:
                    v = torch.full((cap,), none, dtype=torch.int64)
                    v[:len(buf)] = torch.stack(buf)
                    lst, buf = bitonic_merge_asc(lst, bitonic_sort_desc(v)), []
                buf.extend(group)
            if buf:
                v = torch.full((cap,), none, dtype=torch.int64)
                v[:len(buf)] = torch.stack(buf)
                lst = bitonic_merge_asc(lst, bitonic_sort_desc(v))
            head = lst[:k]
            count = int(((head >> 32) < valid_bits).sum())
            rounds = max(1, count)
            slots = (head & 0xFFFFFFFF).int()
            out[b, s] = torch.where(torch.arange(k) < rounds, slots, slots[0])
    return out


def knn_group_reference(xyz, feats, new_xyz, mask, k: int, with_xyz: bool = False):
    """Plain PyTorch version of the kernel; same arguments and results as
    `knn_group`. Differentiable through its gathers by autograd."""
    idx = knn_select(penalised_sqdist(xyz, new_xyz, mask), k)
    gx = index_points(xyz, idx) if with_xyz else None
    gf = None if feats is None else index_points(feats, idx)
    return gx, gf, idx


@functools.cache
def _launcher():
    fn = _build.load("knn_group").knn_group_launch
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _group(xyz, feats, new_xyz, mask, k: int, with_xyz: bool):
    """`knn_group` without its gradient: checks, then the kernel or the
    plain version."""
    if xyz.dim() != 3 or xyz.shape[2] != 3 or new_xyz.dim() != 3 \
            or new_xyz.shape[2] != 3 or new_xyz.shape[0] != xyz.shape[0]:
        raise ValueError(f"knn_group takes xyz (B, N, 3) and new_xyz (B, S, 3); "
                         f"got {tuple(xyz.shape)} and {tuple(new_xyz.shape)}")
    B, N, _ = xyz.shape
    S = new_xyz.shape[1]
    if feats is not None and (feats.dim() != 3 or feats.shape[:2] != (B, N)):
        raise ValueError(f"feats must be (B, N, F) = ({B}, {N}, F); got "
                         f"{tuple(feats.shape)}")
    if mask is not None and (mask.dtype != torch.bool or mask.shape != (B, N)):
        raise ValueError(f"mask must be bool of shape {(B, N)}; got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    if k < 1:
        raise ValueError(f"knn_group needs k >= 1; got k={k}")
    devices = {t.device for t in (xyz, feats, new_xyz, mask) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"knn_group inputs lie on several devices: {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return knn_group_reference(xyz, feats, new_xyz, mask, k, with_xyz)
    if device.type != "cuda":
        raise ValueError(f"knn_group runs on CPU or CUDA tensors, not {device}")
    if xyz.dtype != torch.float32 or new_xyz.dtype != torch.float32 or (
            feats is not None and feats.dtype not in (torch.float32, torch.bfloat16)):
        raise TypeError(f"knn_group kernel takes fp32 xyz and centroids and "
                        f"fp32/bf16 features; got {xyz.dtype}, {new_xyz.dtype}, "
                        f"{None if feats is None else feats.dtype}")
    if not all(t.is_contiguous() for t in (xyz, feats, new_xyz, mask)
               if t is not None):
        raise ValueError("knn_group kernel takes contiguous tensors")
    if not (1 <= B <= _MAX_BATCH and 1 <= N < _MAX_POINTS and S >= 1):
        raise ValueError(f"knn_group kernel bounds exceeded: B={B} N={N} S={S}")

    F = 0 if feats is None else feats.shape[2]
    idx = torch.empty((B, S, k), dtype=torch.int32, device=device)
    gx = (torch.empty((B, S, k, 3), dtype=torch.float32, device=device)
          if with_xyz else None)
    gf = (None if feats is None
          else torch.empty((B, S, k, F), dtype=feats.dtype, device=device))
    esize = 4 if feats is None else feats.element_size()
    word = next(w for w in (16, 8, 4, 2)
                if (F * esize) % w == 0 and (F == 0 or (
                    feats.data_ptr() % w == 0 and gf.data_ptr() % w == 0)))
    plan = knn_group_plan(B, N, S, k, F, torch.float32 if feats is None
                          else feats.dtype, word, with_xyz)

    def ptr(t):
        return None if t is None else t.data_ptr()

    launch = _launcher()
    with torch.cuda.device(device):
        err = launch(
            xyz.data_ptr(), ptr(feats), esize, new_xyz.data_ptr(), ptr(mask),
            B, N, S, k, F, idx.data_ptr(), ptr(gx), ptr(gf), word, *plan_args(plan),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"knn_group kernel launch failed: CUDA error {err}")
    knn_group.launches += 1
    return gx, gf, idx


class _KnnGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xyz, feats, new_xyz, mask, k, with_xyz):
        gx, gf, idx = _group(xyz, feats, new_xyz, mask, k, with_xyz)
        ctx.save_for_backward(idx)
        ctx.n_points = xyz.shape[1]
        ctx.with_xyz = with_xyz
        ctx.feat_dtype = None if feats is None else feats.dtype
        ctx.mark_non_differentiable(idx)
        return gx, gf, idx

    @staticmethod
    def backward(ctx, dgx, dgf, didx):
        del didx
        (idx,) = ctx.saved_tensors
        B, S, k = idx.shape
        # xyz gets the scatter of d grouped_xyz, or no gradient without that
        # output; new_xyz none: the selection is not differentiable
        with_xyz = ctx.with_xyz and ctx.needs_input_grad[0]
        with_feats = ctx.feat_dtype is not None and ctx.needs_input_grad[1]
        d_xyz, d_feats = scatter_grouped(idx, ctx.n_points,
                                         dgx if with_xyz else None,
                                         dgf if with_feats else None,
                                         ctx.feat_dtype)
        return d_xyz, d_feats, None, None, None, None


def knn_group(xyz, feats, new_xyz, mask, k: int, with_xyz: bool = False):
    """Group the k nearest points of each centroid.

    xyz (B, N, 3) fp32, feats (B, N, F) fp32 or bf16 or None, new_xyz
    (B, S, 3) fp32 centroids, mask (B, N) bool (True = valid) or None.
    Returns (grouped_xyz (B, S, k, 3) fp32, not centred, or None unless
    `with_xyz`; grouped_feats (B, S, k, F) in the features' dtype or None
    without features; idx (B, S, k) int32).

    CPU tensors take the plain version. CUDA tensors launch the kernel,
    which takes contiguous tensors; anything else raises.
    `knn_group.launches` counts the kernel's launches.

    Differentiable in xyz and feats (the selection is not; new_xyz gets no
    gradient): the cotangents of the gathered rows go back onto the points
    through one `scatter_rows` (deterministic).
    """
    return _KnnGroup.apply(xyz, feats, new_xyz, mask, k, with_xyz)


knn_group.launches = 0
