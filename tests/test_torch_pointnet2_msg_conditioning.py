"""Why tests/test_torch_pointnet2_msg_train_slice.py holds the backbone's
first-step gradients to a share of each tensor's largest entry and not to
`close_grads`: at the initial weights the MSG autoencoder's backbone
gradients are ill-conditioned in the input itself, with no discontinuity
behind it.

The port alone, in float64, on the train slice's clouds (SEED) and the
port's flax init: moving the input features (channels 3:6) by a relative
1e-11 and by 1e-9 (one draw of N(0, 1) a value) moves no pool's best row
(the six DenseBNMaxPool layers, the group-all chain's pool), no Chamfer
nearest-neighbour assignment and no ball membership (xyz is untouched), yet
the backbone's gradients move by a share of their tensors' largest entries
that grows about as fast as the perturbation: the median tensor by 1.8e-5
at 1e-11 and by 9.2e-4 at 1e-9, about a million times the input's relative
move.
The decoder's gradients stay within 1e-4. So fp32 round-off alone (a
relative 6e-8 a value) moves these gradients by percents of a tensor's
largest entry in any implementation: the JAX package, the port on the CPU
and the port on the card each land elsewhere, and a wider gap between a
pool's best two rows would not bring them together. The assertions hold
this: no flip of any kind, and the backbone's median move at 1e-9 at least
1e4 times the perturbation.
"""

import numpy as np
import torch
from torch_port_utils import msg_spec, raw_clouds, to_np

from pointcloud_tpu_torch.train import harness as tharness

SEED = 35  # the train slice's clouds


def record_choices(monkeypatch):
    """Make the plain pools (DenseBNMaxPool's dense_pool_stats, the fused
    chain's pool pass) and Chamfer's nearest-neighbour sweep append their
    selections (the best row of every group and channel, the argmins both
    ways) to the returned list, in the inputs' own dtype."""
    import sys

    from pointcloud_tpu_torch.ops import dense_bn_pool as tdp
    from pointcloud_tpu_torch.ops import preextract_fused as tpf

    chamfer = sys.modules["pointcloud_tpu_torch.ops.chamfer"]
    picks, dense, pool, sweep = [], tdp.dense_pool_stats_reference, tpf._PLAIN, \
        chamfer.nn_sweep

    def dense_rec(x, w, bias, sign, pen, k):
        z = (torch.matmul(x, w.to(x.dtype)) + bias.to(x.dtype)) * sign.to(x.dtype)
        z = z if pen is None else z - pen[..., None]
        picks.append(z.detach().reshape(x.shape[0], -1, k, w.shape[1]).argmax(2))
        return dense(x, w, bias, sign, pen, k)

    def pool_rec(h, sc, pen, k, final_relu=True, res=None):
        v = tpf._with_residual(tpf._bn_pre(h, sc), res)
        v = v if pen is None else v - pen[..., None]
        picks.append(v.detach().reshape(h.shape[0], -1, k, h.shape[2]).argmax(2))
        return pool[2](h, sc, pen, k, final_relu, res)

    def sweep_rec(*args, **kwargs):
        out = sweep(*args, **kwargs)
        picks.extend((out[1], out[3]))
        return out

    monkeypatch.setattr(tdp, "dense_pool_stats_reference", dense_rec)
    monkeypatch.setattr(tpf, "_PLAIN", (*pool[:2], pool_rec))
    monkeypatch.setattr(chamfer, "nn_sweep", sweep_rec)
    return picks


def test_backbone_gradients_are_ill_conditioned(monkeypatch):
    spec = msg_spec()
    init = {k: v.clone() for k, v in spec.model.state_dict().items()}
    x = raw_clouds(np.random.default_rng(SEED), spec.scene, 2, 1024).astype(np.float64)
    y = raw_clouds(np.random.default_rng(SEED + 100), spec.scene, 2, 1024)
    noise = np.random.default_rng(5).standard_normal(x[..., 3:].shape)
    picks = record_choices(monkeypatch)

    def first_step(eps):
        spec.model.load_state_dict(init)
        spec.model.double()
        xe = x.copy()
        xe[..., 3:] *= 1 + eps * noise
        picks.clear()
        step = tharness.make_train_step(spec, tharness.make_optimizer(spec))
        step(torch.from_numpy(xe), torch.from_numpy(y.astype(np.float64)))
        return ({k: to_np(p.grad) for k, p in spec.model.named_parameters()},
                [p.clone() for p in picks])

    g0, p0 = first_step(0.0)
    assert len(p0) == 6 + 1 + 2
    moves = {}
    for eps in (1e-11, 1e-9):
        g, p = first_step(eps)
        assert all(torch.equal(a, b) for a, b in zip(p, p0)), eps
        share = {k: float(np.abs(g[k] - w).max() / np.abs(w).max())
                 for k, w in g0.items() if np.abs(w).max() > 0}
        assert max(v for k, v in share.items() if k.startswith("decoder.")) < 1e-4
        moves[eps] = float(np.median([v for k, v in share.items()
                                      if k.startswith("encoder.backbone.")]))
    assert moves[1e-11] < 1e-4, moves
    assert moves[1e-9] > 1e4 * 1e-9, moves
