"""The PointNet2 slice as a whole: `create_model("Autoencoder", "PointNet2",
"Cube", loss_override="chamfer")` + `make_eval_step` and `encode` against
the JAX package's on the CPU, on the same interop-converted (randomised)
weights; the interop of a PointNet2 variables tree; what raises until its
slice is ported. The train step is held in
tests/test_torch_pointnet2_train_slice.py.

Tolerances as tests/test_torch_ae_slice.py: outputs and encodings 1e-4
absolute and relative (fp32 on both sides), the Chamfer loss 1e-5 absolute.
The seed keeps every float64 squared distance more than 1e-5 (relative)
away from r^2 at both SA levels, so the JAX package's XLA ball query and
the port's direct differences agree on membership
(tests/test_torch_pointnet2.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_utils import ball_margin as margin
from torch_port_utils import fps_centroids as centroids
from torch_port_utils import jax_variables, raw_clouds, to_np

from pointcloud_tpu import transforms as jtf
from pointcloud_tpu.models import AE as JAE, backbone_factory as jbackbones
from pointcloud_tpu.train import harness as jharness
from pointcloud_tpu_torch import transforms as ttf
from pointcloud_tpu_torch.interop import flax_to_state_dict, load_flax_variables
from pointcloud_tpu_torch.models import AE as TAE, backbone_factory as tbackbones
from pointcloud_tpu_torch.models.architectures import encoding_dim_of
from pointcloud_tpu_torch.train import harness as tharness

TOL = dict(atol=1e-4, rtol=1e-4)
LOSS_TOL = 1e-5
MARGIN = 1e-5


def test_eval_step_and_encode_match_jax_at_full_size():
    """The real entry points at the Cube scene's 2048 points, B=2."""
    jspec, _ = jharness.create_model("Autoencoder", "PointNet2", "Cube",
                                     loss_override="chamfer")
    tspec = tharness.create_model("Autoencoder", "PointNet2", "Cube",
                                  loss_override="chamfer", device="cpu")
    assert encoding_dim_of(tspec.model.encoder.backbone) == 1024
    x = raw_clouds(np.random.default_rng(13), jspec.scene, 2, 2048)
    y = raw_clouds(np.random.default_rng(1), jspec.scene, 2, 2048)
    xyz = to_np(tspec.in_transform(torch.from_numpy(x))[0])[..., :3].copy()
    c1 = centroids(xyz, 512)
    assert margin(xyz, c1, 0.2) > MARGIN
    assert margin(c1, centroids(c1, 128), 0.4) > MARGIN
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


def test_interop_loads_a_pointnet2_tree_exactly():
    """Every SA leaf (w{i} kept (in, out), scale/offset{i}, mean/var{i})
    lands on its state_dict key; unknown or missing leaves still raise."""
    x = np.random.default_rng(5).random((1, 64, 6), dtype=np.float32)
    jm = JAE(jbackbones["PointNet2"](feature_dims=3), out_points=8, bottleneck=13)
    tm = TAE(tbackbones["PointNet2"](feature_dims=3), out_points=8, bottleneck=13)
    v = jax_variables(jm, x, 6)
    state = flax_to_state_dict(v)
    assert set(state) == set(tm.state_dict())
    load_flax_variables(tm, v)
    sa = v["params"]["encoder"]["backbone"]["SetAbstraction_1"]
    np.testing.assert_array_equal(
        to_np(tm.encoder.backbone.SetAbstraction_1.w2), sa["w2"])
    np.testing.assert_array_equal(
        to_np(tm.encoder.backbone.SetAbstraction_2.var0),
        v["batch_stats"]["encoder"]["backbone"]["SetAbstraction_2"]["var0"])

    def edited(edit):
        tree = jax.tree_util.tree_map(lambda a: a, v)
        edit(tree)
        return tree

    with pytest.raises(KeyError, match="unknown flax leaf"):
        flax_to_state_dict(edited(lambda t: t["params"]["encoder"]["backbone"][
            "SetAbstraction_0"].__setitem__("wx", sa["w0"])))
    with pytest.raises(KeyError, match="unknown flax leaf"):  # a stat in params
        flax_to_state_dict(edited(lambda t: t["params"]["encoder"]["backbone"][
            "SetAbstraction_0"].__setitem__("mean0", sa["scale0"])))
    with pytest.raises(KeyError, match="missing"):
        load_flax_variables(tm, edited(lambda t: t["batch_stats"]["encoder"][
            "backbone"]["SetAbstraction_0"].pop("var2")))


def test_train_mode_raises_until_its_slice():
    """The PointNet2 train step is ported: it builds and the model runs in
    train mode, and the default EMD loss builds. Every model type builds on
    PointNet2 now (the MultiSegmenter's segmenting Chamfer among them); an
    unknown one raises."""
    tspec = tharness.create_model("Autoencoder", "PointNet2", "Cube",
                                  loss_override="chamfer", device="cpu")
    assert callable(tharness.make_train_step(tspec, tharness.make_optimizer(tspec)))
    out = tspec.model(torch.rand(2, 640, 6), train=True)
    assert out.shape == (2, 2048, 6) and out.requires_grad
    emd = tharness.create_model("Autoencoder", "PointNet2", "Cube", device="cpu")
    assert type(emd.loss).__name__ == "EarthMoverDistance"
    multi = tharness.create_model("MultiSegmenter", "PointNet2", "Cube", device="cpu")
    assert type(multi.loss).__name__ == "SegmentingChamferDistance"
    with pytest.raises(NotImplementedError, match="Unknown model type"):
        tharness.create_model("Classifier", "PointNet2", "Cube",
                              loss_override="chamfer", device="cpu")
