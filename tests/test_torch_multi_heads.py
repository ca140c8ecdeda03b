"""The port's per-class and state heads (MultiSegAE, MultiGTEncoder,
GTEncoder) against pointcloud_tpu.models.architectures on the CPU, on the
same random flax variables converted by interop: `__call__`, `encode`,
`encode_flat` and `reconstruct_labeled`, in eval and in train mode (the
outputs, the gradients of a fixed random projection of them, and the
running statistics after the step).

The backbone is the PointNet encoder without its two STN heads (B=2, 128
points): the heads' BatchNorm over a batch of two amplifies round-off, and
tests/test_torch_pointnet_train.py holds them apart. fp32 on both sides,
sums in other orders: outputs 1e-4 absolute and relative (as the AE
slice's), gradients and statistics 1e-4 of each tensor's largest entry; the
bias before the pool's train-mode BatchNorm (zero_gradient_biases), whose
true gradient is 0, below 1e-4 of the largest gradient on both sides.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_utils import jax_variables, to_np

from pointcloud_tpu.models import architectures as jarch
from pointcloud_tpu.models.pointnet import PointNetEncoder as JPointNet
from pointcloud_tpu_torch.interop import flax_to_state_dict, load_flax_variables
from pointcloud_tpu_torch.models import architectures as tarch
from pointcloud_tpu_torch.models.pointnet import PointNetEncoder as TPointNet
from pointcloud_tpu_torch.train.harness import zero_gradient_biases

TOL = dict(atol=1e-4, rtol=1e-4)
NPD = (("cube", 21, 3), ("arm", 64, 7), ("gripper", 13, 3))
LABELS = {"cube": 1, "arm": 2, "gripper": 4}
STATES = {"peg_to_hole": 3, "peg_quat": 4, "t": 1, "hole_pos": 3}  # not sorted
METHODS = {"MultiSegAE": ("__call__", "encode", "encode_flat", "reconstruct_labeled"),
           "MultiGTEncoder": ("__call__", "encode"),
           "GTEncoder": ("__call__",)}


def backbones():
    kw = dict(feature_dims=3, input_transform=False, feature_transform=False)
    return JPointNet(**kw), TPointNet(**kw)


def build(name):
    jb, tb = backbones()
    if name == "MultiSegAE":
        return (jarch.MultiSegAE(preencoder=jb, class_labels=LABELS, name_points_dims=NPD),
                tarch.MultiSegAE(tb, LABELS, NPD))
    if name == "MultiGTEncoder":
        return (jarch.MultiGTEncoder(preencoder=jb, state_dims=STATES),
                tarch.MultiGTEncoder(tb, STATES))
    return jarch.GTEncoder(backbone=jb, out_dim=5), tarch.GTEncoder(tb, 5)


def flat(out, keys=None):
    """A head's output as a list of arrays: a dict's values in the order of
    `keys` (default: its own; jax.tree_util returns dicts with sorted keys)."""
    if not isinstance(out, dict):
        return [out]
    return [out[k] for k in (keys or list(out))]


@functools.lru_cache(maxsize=None)
def jax_side(name):
    """The flax module, its random variables and the input (flax's init is
    the slow part: once per head)."""
    x = np.random.default_rng(0).random((2, 128, 6), dtype=np.float32)
    jm, _ = build(name)
    return jm, jax_variables(jm, x, 1), x


def setup(name):
    """(flax module, a fresh port module on the same variables, variables,
    input)."""
    jm, v, x = jax_side(name)
    tm = build(name)[1]
    load_flax_variables(tm, v)
    return jm, tm, v, x


@pytest.mark.parametrize("name", list(METHODS))
def test_heads_eval_match_jax(name):
    jm, tm, v, x = setup(name)
    tm.eval()
    for method in METHODS[name]:
        jout = jm.apply(v, jnp.asarray(x), train=False,
                        method=None if method == "__call__" else getattr(jm, method))
        with torch.inference_mode():
            tout = (tm if method == "__call__" else getattr(tm, method))(
                torch.from_numpy(x), train=False)
        if isinstance(jout, dict):
            assert list(tout) == list(jout), method
        for t, j in zip(flat(tout), flat(jout)):
            assert t.shape == j.shape and t.dtype == torch.float32, method
            np.testing.assert_allclose(to_np(t), np.asarray(j), err_msg=method, **TOL)


@pytest.mark.parametrize("name,method", [(n, m) for n in METHODS for m in METHODS[n]])
def test_heads_train_mode_match_jax(name, method):
    jm, tm, v, x = setup(name)
    jmethod = None if method == "__call__" else getattr(jm, method)
    jout = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"],
                    method=jmethod)[0]
    keys = list(jout) if isinstance(jout, dict) else None
    rs = [np.random.default_rng(3 + i).standard_normal(np.shape(j)).astype(np.float32)
          for i, j in enumerate(flat(jout))]

    def loss(params):
        out, mutated = jm.apply({**v, "params": params}, jnp.asarray(x), train=True,
                                mutable=["batch_stats"], method=jmethod)
        return sum(jnp.sum(o * r) for o, r in zip(flat(out, keys), rs)), (out, mutated)

    (_, (jout, mutated)), jgrads = jax.value_and_grad(loss, has_aux=True)(v["params"])
    tout = (tm if method == "__call__" else getattr(tm, method))(
        torch.from_numpy(x), train=True)
    if keys is not None:
        assert list(tout) == keys
    sum((o * torch.from_numpy(r)).sum() for o, r in zip(flat(tout), rs)).backward()
    for t, j in zip(flat(tout), flat(jout, keys)):
        np.testing.assert_allclose(to_np(t), np.asarray(j), err_msg=method, **TOL)
    want = flax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, {"params": jgrads, "batch_stats": mutated["batch_stats"]}))
    got = {k: p.grad for k, p in tm.named_parameters()}
    got.update(dict(tm.named_buffers()))
    assert set(got) == set(want)
    zero = zero_gradient_biases(tm)  # true gradient 0: both sides round-off
    top = max(float(np.abs(to_np(want[k])).max()) for k in want
              if k in dict(tm.named_parameters()))
    for k, w in want.items():
        w = to_np(w)
        g = np.zeros_like(w) if got[k] is None else to_np(got[k])
        if k in zero:
            assert max(np.abs(g).max(), np.abs(w).max()) <= 1e-4 * top, k
            continue
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max() + 1e-12,
                                   err_msg=k)


def test_multi_seg_ae_labels_and_order():
    """reconstruct_labeled: the classes' clouds in name_points_dims order,
    each with its integer label as a fourth column; encode_flat the
    bottlenecks in that order."""
    _, tm, _, x = setup("MultiSegAE")
    with torch.inference_mode():
        lab = tm.reconstruct_labeled(torch.from_numpy(x))
        clouds = tm(torch.from_numpy(x))
        enc = tm.encode(torch.from_numpy(x))
        fl = tm.encode_flat(torch.from_numpy(x))
    assert lab.shape == (2, 21 + 64 + 13, 4)
    start = 0
    for name, n, d in NPD:
        np.testing.assert_array_equal(to_np(lab[:, start:start + n, :3]),
                                      to_np(clouds[name]))
        assert bool((lab[:, start:start + n, 3] == LABELS[name]).all())
        start += n
    assert torch.equal(fl, torch.cat([enc[n] for n, _, _ in NPD], dim=-1))
    assert fl.shape == (2, 13)


def test_state_dict_keys_are_the_flax_paths():
    """bottleneck_{name}, decoder_{name}, head_{name} and MLP_0 carry the
    flax names, so a flax tree loads key for key (load_flax_variables is
    total), and strip_decoders keeps the bottlenecks and heads."""
    from pointcloud_tpu_torch.train.harness import strip_decoders

    for name in METHODS:
        jm, tm, v, _ = setup(name)
        assert set(flax_to_state_dict(v)) == set(tm.state_dict())
        kept = strip_decoders(tm.state_dict())
        assert not any(k.startswith("decoder") for k in kept)
        assert all(k in kept for k in tm.state_dict()
                   if k.startswith(("bottleneck_", "head_", "preencoder", "backbone")))
