"""The PointMLP slice as a whole: `create_model("Autoencoder", "PointMLP" |
"PointMLPE", "Cube", loss_override="chamfer")` + `make_eval_step` and
`encode` against the JAX package's on the CPU, on the same
interop-converted (randomised) weights; one train step of each through the
default EMD loss. The Segmenter on PointMLPE and the interop of a PointMLP
variables tree are in tests/test_torch_pointmlp_seg.py; the train steps
against the JAX package's in tests/test_torch_pointmlp_train_slice.py.

Tolerances as tests/test_torch_ae_slice.py: outputs and encodings 1e-4
absolute and relative (fp32 on both sides), the Chamfer loss 1e-5 absolute.
The JAX package groups through its XLA kNN (the matmul expansion), the port
through the kernel's direct differences: the seed keeps every centroid's
24th and 25th float64 distances 1e-5 apart (relative) at all four stages,
so both pick the same neighbours (tests/test_torch_pointmlp.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_utils import jax_variables, raw_clouds, stage_margins, to_np

from pointcloud_tpu import transforms as jtf
from pointcloud_tpu.train import harness as jharness
from pointcloud_tpu_torch import transforms as ttf
from pointcloud_tpu_torch.interop import load_flax_variables
from pointcloud_tpu_torch.models.architectures import encoding_dim_of
from pointcloud_tpu_torch.train import harness as tharness

TOL = dict(atol=1e-4, rtol=1e-4)
LOSS_TOL = 1e-5
MARGIN = 1e-5
N_POINTS = 384


@pytest.mark.parametrize("backbone,width", [("PointMLP", 1024), ("PointMLPE", 256)])
def test_eval_step_and_encode_match_jax(backbone, width):
    """The real entry points at B=2 x 384 points (the decoder still emits
    the Cube scene's 2048)."""
    jspec, _ = jharness.create_model("Autoencoder", backbone, "Cube",
                                     loss_override="chamfer")
    tspec = tharness.create_model("Autoencoder", backbone, "Cube",
                                  loss_override="chamfer", device="cpu")
    assert encoding_dim_of(tspec.model.encoder.backbone) == width
    x = raw_clouds(np.random.default_rng(21), jspec.scene, 2, N_POINTS)
    y = raw_clouds(np.random.default_rng(22), jspec.scene, 2, N_POINTS)
    xyz = to_np(tspec.in_transform(torch.from_numpy(x))[0])[..., :3].copy()
    assert min(stage_margins(xyz)) > MARGIN
    assert min(stage_margins(xyz[:1])) > MARGIN  # encode's single cloud
    v = jax_variables(jspec.model, x, 1)
    load_flax_variables(tspec.model, v)

    jloss, _, jout = jharness.make_eval_step(jspec)(
        v["params"], v["batch_stats"], jnp.asarray(x), jnp.asarray(y))
    tloss, logs, tout = tharness.make_eval_step(tspec)(
        torch.from_numpy(x), torch.from_numpy(y))
    assert tout.shape == (2, 2048, 6) and tout.dtype == torch.float32
    assert logs == {}
    np.testing.assert_allclose(to_np(tout), np.asarray(jout), **TOL)
    assert abs(float(tloss) - float(jloss)) <= LOSS_TOL

    # the RL observation encoder's call: one normalised cloud
    xn = jtf.Normalize(jspec.scene.bbox)(jnp.asarray(x[0]))[0][None]
    jenc = jspec.model.apply(v, xn, train=False, method=jspec.model.encode)
    with torch.inference_mode():
        tenc = tspec.model.encode(
            ttf.Normalize(tspec.scene.bbox)(torch.from_numpy(x[:1]))[0])
    assert tenc.shape == (1, 13)
    np.testing.assert_allclose(to_np(tenc), np.asarray(jenc), **TOL)


def test_train_mode_raises_until_its_slice():
    """Train mode is ported (the name is the earlier slice's): for both
    backbones with the default EMD loss, one step of `make_train_step`
    gives a finite loss and its logs, every parameter a gradient, moves
    every parameter but round-off ones and every running statistic; a
    train-mode `encode` gives the latent."""
    for backbone in ("PointMLP", "PointMLPE"):
        spec = tharness.create_model("Autoencoder", backbone, "Cube", device="cpu")
        step = tharness.make_train_step(spec, tharness.make_optimizer(spec))
        x = torch.from_numpy(raw_clouds(np.random.default_rng(3), spec.scene, 2, 256))
        params = {k: p.detach().clone() for k, p in spec.model.named_parameters()}
        stats = {k: b.clone() for k, b in spec.model.named_buffers()}
        loss, logs = step(x, x)
        assert loss.shape == () and bool(torch.isfinite(loss))
        assert set(logs) == {"train_loss/EMD", "train_loss/feature"}
        assert all(p.grad is not None for p in spec.model.parameters())
        moved = [k for k, p in spec.model.named_parameters()
                 if not torch.equal(p, params[k])]
        assert len(moved) >= len(params) - 2, sorted(set(params) - set(moved))
        assert all(not torch.equal(b, stats[k]) for k, b in spec.model.named_buffers())
        enc = spec.model.encode(spec.in_transform(x)[0], train=True)
        assert enc.shape == (2, 13) and bool(torch.isfinite(enc).all())
