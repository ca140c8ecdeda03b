"""Shared pieces of the MultiSegmenter and StatePredictor slice tests
(tests/test_torch_multiseg_slice.py, tests/test_torch_state_predictor_slice.py):
batches, both packages' specs on the same flax variables, and the JAX
package's first step and three steps."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
from test_torch_train_slice import LR, params_np
from torch_port_utils import jax_variables, raw_clouds, to_np

from pointcloud_tpu.train import harness as jharness
from pointcloud_tpu_torch.interop import flax_to_state_dict, load_flax_variables
from pointcloud_tpu_torch.train import harness as tharness

N_IN = 256  # input points: PointNet takes any count; the decoders' are the scene's
B = 2
STEPS = 3


def batch(model_type, sc, seed, b=B, n=N_IN):
    """(x_raw, y_raw): clouds in the scene's bbox with rgb, and the target:
    xyz in the bbox + an integer class label as a float (MultiSegmenter), or
    a dict of raw states (StatePredictor: positions in the bbox, the other
    states normal draws)."""
    rng = np.random.default_rng(seed)
    x = raw_clouds(rng, sc, b, n)
    if model_type == "MultiSegmenter":
        y = raw_clouds(rng, sc, b, n)[..., :4]
        y[..., 3] = rng.integers(0, len(sc.classes), (b, n)).astype(np.float32)
        return x, y
    bbox = np.asarray(sc.bbox, np.float32)
    y = {}
    for name, d in zip(sc.states, sc.state_dim):
        if d == 3:
            y[name] = bbox[:, 0] + rng.random((b, 3), dtype=np.float32) * (
                bbox[:, 1] - bbox[:, 0])
        elif d > 0:
            y[name] = rng.standard_normal((b, d)).astype(np.float32)
    return x, y


def repeat(arr, b=B):
    """Cloud 0 of a batch (or of each state) repeated b times."""
    if isinstance(arr, dict):
        return {k: repeat(v, b) for k, v in arr.items()}
    return np.repeat(arr[:1], b, axis=0)


def as_jax(y):
    return {k: jnp.asarray(v) for k, v in y.items()} if isinstance(y, dict) else jnp.asarray(y)


def as_torch(y):
    if isinstance(y, dict):
        return {k: torch.from_numpy(np.array(v)) for k, v in y.items()}
    return torch.from_numpy(np.array(y))


def jax_spec(model_type, scene, x, randomize=None):
    """The JAX spec and flax variables: its init (copied to numpy), or
    random_variables drawn from the seed `randomize`."""
    jspec, _ = jharness.create_model(model_type, "PointNet", scene)
    if randomize is not None:
        return jspec, jax_variables(jspec.model, x, randomize)
    return jspec, jax.tree_util.tree_map(np.array, jspec.model.init(
        jax.random.PRNGKey(0), jnp.asarray(x[:1]), train=False))


def port_spec(model_type, scene, v):
    tspec = tharness.create_model(model_type, "PointNet", scene, device="cpu")
    load_flax_variables(tspec.model, v)
    return tspec


def jax_first_step(jspec, v, x, y):
    """(loss, state_dict-keyed gradients) of the JAX package's train-mode
    forward + loss at the variables v."""
    xn = jharness._apply_tf(jspec.in_transform, jnp.asarray(x))
    yn = as_jax(y) if jspec.dict_target else jharness._apply_tf(
        jspec.out_transform, jnp.asarray(y))
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jharness._forward_loss(
        jspec, p, v["batch_stats"], xn, yn, True)[0]))(v["params"])
    return float(loss), params_np(grads)


def jax_steps(jspec, v, x, y):
    """The JAX package's STEPS train steps from v: the losses, the
    parameters after the first step and the final state_dict-keyed
    parameters and running statistics."""
    tx = optax.adam(LR)
    params, stats = v["params"], v["batch_stats"]
    opt_state = tx.init(params)
    step = jharness.make_train_step(jspec, tx)
    losses, after1 = [], None
    for i in range(STEPS):
        params, stats, opt_state, loss, _ = step(params, stats, opt_state,
                                                 jnp.asarray(x), as_jax(y))
        losses.append(float(loss))
        if i == 0:
            after1 = params_np(params)
    final = {k: np.array(to_np(a)) for k, a in flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, {"params": params, "batch_stats": stats})
    ).items()}
    return losses, after1, final
