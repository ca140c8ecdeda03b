"""The multi-scale-grouping PointNet2 slice as a whole against the JAX
package's, on the CPU, fp32, at the encoder's published widths: the
autoencoder built as `create_model("Autoencoder", ..., "Cube",
loss_override="chamfer")` builds the factory's (tests/torch_port_utils.py
`msg_spec` / `jax_msg_spec`; neither factory has an MSG entry), B=2 clouds
of 1024 points (so that level 1's 512 centroids are fewer than the points),
through `make_eval_step` and `encode` against the JAX harness's on the same
randomised variables (interop), and the interop of the whole tree. The first
train step is held in tests/test_torch_pointnet2_msg_train_slice.py.

Tolerances, as tests/test_torch_pointnet2_slice.py: outputs and encodings
1e-4, the loss 1e-5 absolute. The seed makes the JAX package's XLA ball
query (matmul expansion) and the port's direct differences agree on every
membership at each of the six (level, radius) pairs (`msg_flips`; a float64
margin of 1e-5 of r^2 cannot be had at 1024 points).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_utils import (
    jax_msg_spec,
    jax_variables,
    msg_clouds,
    msg_spec,
    raw_clouds,
    to_np,
)

from pointcloud_tpu import transforms as jtf
from pointcloud_tpu.train import harness as jharness
from pointcloud_tpu_torch import transforms as ttf
from pointcloud_tpu_torch.interop import flax_to_state_dict, load_flax_variables
from pointcloud_tpu_torch.train import harness as tharness

TOL = dict(atol=1e-4, rtol=1e-4)
SEED = 13


@pytest.fixture(scope="module")
def jspec():
    return jax_msg_spec()


def test_interop_and_names(jspec):
    """Interop loads the JAX encoder's variables with no missing or extra
    key; the levels carry flax's names."""
    x = raw_clouds(np.random.default_rng(0), jspec.scene, 1, 256)
    v = jax.eval_shape(lambda: jspec.model.init(jax.random.PRNGKey(0),
                                                jnp.asarray(x), train=False))
    keys = set(flax_to_state_dict(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), v)))
    tspec = msg_spec()
    assert keys == set(tspec.model.state_dict())
    bb = v["params"]["encoder"]["backbone"]
    assert sorted(bb) == ["SetAbstractionMsg_0", "SetAbstractionMsg_1",
                          "SetAbstraction_0"]
    assert sorted(bb["SetAbstractionMsg_1"]) == sorted(
        [f"Dense_{i}" for i in range(6)] + [f"BatchNorm_{i}" for i in range(6)]
        + [f"DenseBNMaxPool_{i}" for i in range(3)])


def test_eval_step_and_encode_match_jax(jspec):
    x, y = msg_clouds(SEED, jspec.scene)
    v = jax_variables(jspec.model, x, 1)
    tspec = msg_spec()
    load_flax_variables(tspec.model, v)
    jloss, _, jout = jharness.make_eval_step(jspec)(
        v["params"], v["batch_stats"], jnp.asarray(x), jnp.asarray(y))
    tloss, logs, tout = tharness.make_eval_step(tspec)(
        torch.from_numpy(x), torch.from_numpy(y))
    assert tout.shape == (2, 2048, 6) and logs == {}
    np.testing.assert_allclose(to_np(tout), np.asarray(jout), **TOL)
    assert abs(float(tloss) - float(jloss)) <= 1e-5

    xn = jtf.Normalize(jspec.scene.bbox)(jnp.asarray(x[0]))[0][None]
    jenc = jspec.model.apply(v, xn, train=False, method=jspec.model.encode)
    with torch.inference_mode():
        tenc = tspec.model.encode(
            ttf.Normalize(tspec.scene.bbox)(torch.from_numpy(x[:1]))[0])
    assert tenc.shape == (1, 13)
    np.testing.assert_allclose(to_np(tenc), np.asarray(jenc), **TOL)
