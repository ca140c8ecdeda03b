"""The PointMLP slice's other entry points against the JAX package on the
CPU: the Segmenter's eval forward on PointMLP-Elite
(`create_model("Segmenter", "PointMLPE", "Cube")`), and the interop of a
PointMLP variables tree (affine_alpha / affine_beta, PreExtraction's w{i},
bias-free Dense kernels).

Tolerances and the kNN margin as tests/test_torch_pointmlp_slice.py:
outputs 1e-4 absolute and relative (fp32 on both sides); every stage's
24th and 25th float64 distances 1e-5 apart (relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_utils import jax_variables, raw_clouds, stage_margins, to_np

from pointcloud_tpu.models import AE as JAE, backbone_factory as jbackbones
from pointcloud_tpu.train import harness as jharness
from pointcloud_tpu_torch.interop import flax_to_state_dict, load_flax_variables
from pointcloud_tpu_torch.models import AE as TAE, backbone_factory as tbackbones
from pointcloud_tpu_torch.train import harness as tharness

TOL = dict(atol=1e-4, rtol=1e-4)
MARGIN = 1e-5
N_POINTS = 384

def test_segmenter_forward_matches_jax():
    """create_model("Segmenter", "PointMLPE", "Cube"): the model's eval
    forward (xyz in the unit cube + raw logits) against the JAX package's;
    its EMD loss is held in tests/test_torch_emd_slice.py's terms, not
    here."""
    jspec, _ = jharness.create_model("Segmenter", "PointMLPE", "Cube")
    tspec = tharness.create_model("Segmenter", "PointMLPE", "Cube", device="cpu")
    x = raw_clouds(np.random.default_rng(23), jspec.scene, 2, N_POINTS)
    xn = to_np(tspec.in_transform(torch.from_numpy(x))[0])
    assert min(stage_margins(xn[..., :3].copy())) > MARGIN
    v = jax_variables(jspec.model, x, 2)
    load_flax_variables(tspec.model, v)
    jout = jspec.model.apply(v, jnp.asarray(xn), train=False)
    with torch.inference_mode():
        tout = tspec.model(torch.from_numpy(xn))
    assert tout.shape == (2, 2048, 3 + len(tspec.scene.classes))
    np.testing.assert_allclose(to_np(tout), np.asarray(jout), **TOL)
    assert type(tspec.loss).__name__ == "EarthMoverDistance"


def test_interop_loads_a_pointmlp_tree_exactly():
    """Every leaf lands on its state_dict key: PreExtraction's w{i} (in, out)
    as is, the LocalGrouper's affine_alpha / affine_beta (1, 1, 1, dim) as
    is, the bias-free Dense kernels transposed with no bias."""
    x = np.random.default_rng(5).random((1, 256, 6), dtype=np.float32)
    jm = JAE(jbackbones["PointMLPE"](feature_dims=3), out_points=8, bottleneck=13)
    tm = TAE(tbackbones["PointMLPE"](feature_dims=3), out_points=8, bottleneck=13)
    v = jax_variables(jm, x, 6)
    state = flax_to_state_dict(v)
    assert set(state) == set(tm.state_dict())
    load_flax_variables(tm, v)
    bb = v["params"]["encoder"]["backbone"]
    np.testing.assert_array_equal(
        to_np(tm.encoder.backbone.LocalGrouper_2.affine_alpha),
        bb["LocalGrouper_2"]["affine_alpha"])
    assert tm.encoder.backbone.LocalGrouper_2.affine_beta.shape == (1, 1, 1, 128)
    np.testing.assert_array_equal(to_np(tm.encoder.backbone.PreExtraction_2.w4),
                                  bb["PreExtraction_2"]["w4"])
    np.testing.assert_array_equal(
        to_np(tm.encoder.backbone.PosExtraction_0.ResBlock_0.Dense_0.weight),
        bb["PosExtraction_0"]["ResBlock_0"]["Dense_0"]["kernel"].T)
    assert "Dense_0" in bb["DenseBNAct_0"] and "bias" not in bb["DenseBNAct_0"]["Dense_0"]

    def edited(edit):
        tree = jax.tree_util.tree_map(lambda a: a, v)
        edit(tree)
        return tree

    with pytest.raises(KeyError, match="missing"):
        load_flax_variables(tm, edited(lambda t: t["params"]["encoder"]["backbone"][
            "LocalGrouper_0"].pop("affine_beta")))
    with pytest.raises(KeyError, match="unknown flax leaf"):
        flax_to_state_dict(edited(lambda t: t["params"]["encoder"]["backbone"][
            "LocalGrouper_0"].__setitem__("affine_gamma", bb["LocalGrouper_0"][
                "affine_alpha"])))
