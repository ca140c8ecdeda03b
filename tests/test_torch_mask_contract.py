"""The BatchNorm/mask contract of the port's encoders
(`check_train_mask_contract`, a copy of pointcloud_tpu/models/pointnet.py's)
and the encoder configurations off the shipped path, against pointcloud_tpu
on the CPU.

The warning: under cfg.debug a train-mode forward with a validity mask warns
(BatchNorm statistics include masked points), in PointNet, PointNet2 and
PointMLP, and the forward then runs; without cfg.debug, in eval or without a
mask it stays silent.

The configurations: PointNet and PointNet2 with feature_dims=0, PointNet
with both STNs off, and PointNet's forward_all_features with a mask, each
against the JAX package within 1e-5 absolute and relative (fp32 on both
sides; the products sum in other orders, ~1e-6 at these widths).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_utils import ball_margin, fps_centroids, jax_variables, to_np

from pointcloud_tpu.models import pointnet as jpn
from pointcloud_tpu.models import pointnet2 as jpn2
from pointcloud_tpu_torch import cfg
from pointcloud_tpu_torch.interop import load_flax_variables
from pointcloud_tpu_torch.models.layers import init_flax_
from pointcloud_tpu_torch.models import pointmlp as tpm
from pointcloud_tpu_torch.models import pointnet as tpn
from pointcloud_tpu_torch.models import pointnet2 as tpn2

TOL = dict(atol=1e-5, rtol=1e-5)
MESSAGE = "BatchNorm statistics will include masked-out points"
ENCODERS = {
    "PointNet": lambda: tpn.PointNetEncoder(feature_dims=3),
    "PointNet2": lambda: tpn2.PointNet2Encoder(feature_dims=3),
    "PointMLP": lambda: tpm.PointMLPElite(),
}


def run(name, train, masked):
    """One forward of a freshly initialised encoder on B=2 x 256 clouds."""
    model = ENCODERS[name]()
    init_flax_(model, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.random((2, 256, 6), dtype=np.float32))
    mask = torch.from_numpy(rng.random((2, 256)) > 0.1) if masked else None
    out = model(x, train=train, mask=mask)
    assert out.shape[0] == 2 and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("name", list(ENCODERS))
def test_train_forward_with_a_mask_warns_under_debug(name, monkeypatch):
    monkeypatch.setattr(cfg, "debug", True)
    with pytest.warns(UserWarning, match=MESSAGE):
        run(name, train=True, masked=True)


@pytest.mark.parametrize("name", list(ENCODERS))
@pytest.mark.parametrize("debug,train,masked", [(False, True, True),
                                                (True, False, True),
                                                (True, True, False)])
def test_silent_otherwise(name, debug, train, masked, monkeypatch):
    monkeypatch.setattr(cfg, "debug", debug)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        run(name, train=train, masked=masked)
    assert not [w for w in caught if MESSAGE in str(w.message)]


def probe_input(seed, B, N, C):
    rng = np.random.default_rng(seed)
    x = rng.random((B, N, C), dtype=np.float32)
    mask = rng.random((B, N)) > 0.2
    return x, mask


@pytest.mark.parametrize("probe", ["pointnet_xyz_only", "pointnet_no_stn",
                                   "pointnet2_xyz_only", "all_features_masked"])
def test_off_path_configurations_match_jax(probe):
    masked = probe == "all_features_masked"
    if probe.startswith("pointnet2"):
        jm, tm = jpn2.PointNet2Encoder(feature_dims=0), tpn2.PointNet2Encoder(feature_dims=0)
        x, mask = probe_input(3, 2, 256, 3)
        c1 = fps_centroids(x, 512)  # under-full: FPS repeats points
        assert ball_margin(x, c1, 0.2) > 1e-5
        assert ball_margin(c1, fps_centroids(c1, 128), 0.4) > 1e-5
    elif probe == "pointnet_xyz_only":
        jm, tm = jpn.PointNetEncoder(feature_dims=0), tpn.PointNetEncoder(feature_dims=0)
        x, mask = probe_input(4, 2, 128, 3)
    else:
        kw = {} if masked else dict(input_transform=False, feature_transform=False)
        jm, tm = jpn.PointNetEncoder(feature_dims=3, **kw), tpn.PointNetEncoder(
            feature_dims=3, **kw)
        x, mask = probe_input(5, 2, 128, 6)
    v = jax_variables(jm, x, 7)
    load_flax_variables(tm, v)
    jmask = jnp.asarray(mask) if masked else None
    tmask = torch.from_numpy(mask) if masked else None
    with torch.inference_mode():
        if probe == "all_features_masked":
            want = jm.apply(v, jnp.asarray(x), train=False, mask=jmask,
                            method=jm.forward_all_features)
            got = tm.forward_all_features(torch.from_numpy(x), mask=tmask)
            assert got.shape == (2, 128, 64 + 1024)
        else:
            want = jm.apply(v, jnp.asarray(x), train=False)
            got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
