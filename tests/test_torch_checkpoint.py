"""The port's checkpoints: a round trip, the async snapshot's ordering,
`latest_checkpoint`, `create_model(load_dir=..., encoder_only=...)` and its
refusals, and Adam's state carried across from the JAX package.

The Adam test: the JAX package takes three optax.adam steps of the
PointNet autoencoder (Chamfer, the scene's 2048 points; each step's batch
is one cloud repeated, B=2, as in tests/test_torch_train_slice.py's
three-step test, whose STN heads then see a batch variance of exactly 0,
and each step has a cloud of its own, so that the gradients and with them
Adam's moments change from step to step), its state goes through
interop.checkpoint_from_jax, and both packages take a fourth step from it.
The fourth update is held by the train slice's first-update rule: 1e-3
relative wherever the fourth step's gradient is above noise (above 1% of
its tensor's largest entry and above 1e-6), every entry at most 2 lr apart,
the trap biases (`zero_gradient_biases`) on the loose rule alone. Two
terms are added to the tight rule, as an update near 0 carries errors that
do not scale with it. One is two roundings of the parameter (an update is
the difference of two fp32 parameters). The other is what a 1e-3 relative
change of the fourth gradient g moves the update by, lr (1 - b1) / (1 -
b1^4) 1e-3 |g| / sqrt(v_hat) (v_hat from the carried second moment and g):
g enters Adam's first moment as its share (1 - b1) g, where the carried
moment can nearly cancel it; the first-step test holds gradients to 1e-3.
Measured: 1.9e-8 apart on an update of 1.3e-7, 4.2e-9 on one of 5e-7,
both entries whose carried moment cancels the new share. Adam's
carried moments weight the update; a reset state would instead move every
entry by lr * sign(g), and test_adam_reset_fails_the_rule plants that reset
and asserts that the rule rejects it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_train_slice import (
    LR,
    SCENE,
    jax_first_step,
    params_np,
    port_params,
    raw_clouds,
)
from test_torch_train_slice import setup as jax_setup

from pointcloud_tpu.train import harness as jharness
from pointcloud_tpu_torch.interop import (
    adam_state_from_optax,
    checkpoint_from_jax,
    flax_to_state_dict,
)
from pointcloud_tpu_torch.train import harness as tharness
from pointcloud_tpu_torch.train.harness import zero_gradient_biases


def port_spec(seed=0, model_type="Autoencoder", backbone="PointNet", **kw):
    return tharness.create_model(model_type, backbone, "Cube", loss_override="chamfer",
                                 device="cpu", seed=seed, **kw)


def trained(seed=0):
    """A port spec and optimizer after one train step on random clouds."""
    spec = port_spec(seed)
    opt = tharness.make_optimizer(spec)
    x = torch.from_numpy(raw_clouds(np.random.default_rng(seed), SCENE, 2, 256))
    tharness.make_train_step(spec, opt)(x, x)
    return spec, opt, x


def assert_state_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_checkpoint_round_trip(tmp_path):
    spec, opt, _ = trained()
    path = tharness.save_checkpoint(str(tmp_path), 3, tharness.checkpoint_payload(
        spec, opt, 3, "chamfer"))
    assert path == str(tmp_path / "step_3")
    assert sorted(p.name for p in (tmp_path / "step_3").iterdir()) == ["checkpoint.pt"]
    ck = tharness.load_checkpoint_raw(path)
    assert ck.keys() == {"model", "optimizer", "epoch", "config"}
    assert ck["epoch"] == 3
    assert ck["config"] == {"model_type": "Autoencoder", "backbone": "PointNet",
                            "scene": "Cube", "loss_override": "chamfer"}
    assert_state_equal(ck["model"], spec.model.state_dict())
    want = opt.state_dict()
    assert ck["optimizer"]["param_groups"] == want["param_groups"]
    for i, s in want["state"].items():
        for k, v in s.items():
            assert torch.equal(ck["optimizer"]["state"][i][k], v), (i, k)
    # it loads into a fresh model and optimizer, which then take the same step
    spec2 = port_spec(seed=9)
    opt2 = tharness.make_optimizer(spec2)
    tharness.load_state(spec2.model, ck["model"])
    opt2.load_state_dict(ck["optimizer"])
    x = torch.from_numpy(raw_clouds(np.random.default_rng(5), SCENE, 2, 256))
    tharness.make_train_step(spec, opt)(x, x)
    tharness.make_train_step(spec2, opt2)(x, x)
    assert_state_equal(spec2.model.state_dict(), spec.model.state_dict())


def test_async_snapshot_precedes_the_next_update(tmp_path):
    """The snapshot holds the weights of the step before it, although the
    next step updates them in place before the write ends."""
    spec, opt, x = trained()
    before = {k: v.clone() for k, v in spec.model.state_dict().items()}
    tharness.save_checkpoint_async(str(tmp_path), 0, tharness.checkpoint_payload(
        spec, opt, 0))
    tharness.make_train_step(spec, opt)(x, x)
    tharness.wait_for_checkpoints()
    ck = tharness.load_checkpoint_raw(str(tmp_path / "step_0"))
    assert_state_equal(ck["model"], before)
    assert not torch.equal(spec.model.state_dict()["decoder.MLP_0.Dense_0.weight"],
                           before["decoder.MLP_0.Dense_0.weight"])
    assert {float(s["step"]) for s in ck["optimizer"]["state"].values()} == {1.0}


def test_wait_for_checkpoints_reraises(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    tharness.save_checkpoint_async(str(blocker), 0, {"epoch": 0})
    with pytest.raises(OSError):
        tharness.wait_for_checkpoints()


def test_latest_checkpoint(tmp_path):
    assert tharness.latest_checkpoint(str(tmp_path / "missing")) is None
    assert tharness.latest_checkpoint(str(tmp_path)) is None
    for name in ("step_2", "step_10", "step_9", "step_x", "other"):
        (tmp_path / name).mkdir()
    assert tharness.latest_checkpoint(str(tmp_path)) == str(tmp_path / "step_10")


@pytest.fixture
def saved(tmp_path):
    spec, opt, _ = trained(seed=1)
    path = tharness.save_checkpoint(str(tmp_path), 0, tharness.checkpoint_payload(
        spec, opt, 0))
    return path, spec.model.state_dict()


def test_load_dir_loads_every_key(saved):
    path, state = saved
    spec = port_spec(seed=2, load_dir=path)
    assert_state_equal(spec.model.state_dict(), state)


def test_encoder_only_keeps_the_decoder_fresh(saved):
    path, state = saved
    fresh = port_spec(seed=2).model.state_dict()
    got = port_spec(seed=2, load_dir=path, encoder_only=True).model.state_dict()
    decoder = [k for k in got if k.startswith("decoder.")]
    encoder = [k for k in got if k.startswith("encoder.")]
    assert decoder and encoder and len(decoder) + len(encoder) == len(got)
    for k in decoder:
        assert torch.equal(got[k], fresh[k]), k
        assert not torch.equal(got[k], state[k]) or not state[k].any(), k
    for k in encoder:
        assert torch.equal(got[k], state[k]), k
    # a Segmenter's encoder from the autoencoder's checkpoint
    seg = tharness.create_model("Segmenter", "PointNet", "Cube", device="cpu", seed=2,
                                load_dir=path, encoder_only=True).model.state_dict()
    for k in encoder:
        assert torch.equal(seg[k], state[k]), k


def test_strip_decoders_matches_the_jax_packages(saved):
    path, state = saved
    names = ["encoder", "decoder", "Decoder_0", "decoder_cube", "encoderdecoder"]
    jkept = set(jharness.strip_decoders({n: 0 for n in names}))
    tkept = {k.split(".")[0] for k in tharness.strip_decoders({f"{n}.w": 0 for n in names})}
    assert tkept == jkept == {"encoder", "encoderdecoder"}
    payload = tharness.load_checkpoint_variables(path, encoder_only=True)
    assert payload["model"] == tharness.strip_decoders(payload["model"])
    assert all(k.startswith("encoder.") for k in payload["model"])
    assert tharness.merge_variables({"a": 1, "b": 2}, {"b": 3}) == {"a": 1, "b": 3}


@pytest.mark.parametrize("edit,error", [
    (lambda s: s.pop("encoder.MLP_0.Dense_0.weight"), KeyError),
    (lambda s: s.__setitem__("encoder.extra", torch.zeros(1)), KeyError),
    (lambda s: s.__setitem__("encoder.MLP_0.Dense_0.bias", torch.zeros(3)), ValueError),
])
@pytest.mark.parametrize("encoder_only", [False, True])
def test_load_dir_refuses_a_checkpoint_that_does_not_match(tmp_path, saved, edit, error,
                                                           encoder_only):
    path, _ = saved
    ck = tharness.load_checkpoint_raw(path)
    edit(ck["model"])
    bad = tharness.save_checkpoint(str(tmp_path / "bad"), 0, ck)
    with pytest.raises(error):
        port_spec(seed=2, load_dir=bad, encoder_only=encoder_only)


def test_full_load_refuses_a_checkpoint_without_decoder(tmp_path, saved):
    path, _ = saved
    ck = tharness.load_checkpoint_variables(path, encoder_only=True)
    bad = tharness.save_checkpoint(str(tmp_path / "enc"), 0, ck)
    with pytest.raises(KeyError):
        port_spec(seed=2, load_dir=bad)
    port_spec(seed=2, load_dir=bad, encoder_only=True)


############################ Adam's state from the JAX package ############################

STEPS = 3


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's three steps, its fourth step's gradient and
    update, and its state as the JAX train() writes it."""
    rng = np.random.default_rng(1)
    batches = [tuple(np.repeat(raw_clouds(rng, SCENE, 1, SCENE.sample_points), 2, axis=0)
                     for _ in range(2)) for _ in range(STEPS + 1)]
    jspec, v = jax_setup(batches[0][0])
    tx = optax.adam(LR)
    params, stats = v["params"], v["batch_stats"]
    opt_state = tx.init(params)
    jstep = jharness.make_train_step(jspec, tx)
    for x, y in batches[:STEPS]:
        params, stats, opt_state, _, _ = jstep(params, stats, opt_state,
                                              jnp.asarray(x), jnp.asarray(y))
    host = jax.tree_util.tree_map(np.array, {"params": params, "batch_stats": stats})
    payload = {**host, "epoch": np.asarray(0), "opt_state_leaves": {
        str(i): np.array(leaf) for i, leaf in enumerate(jax.tree_util.tree_leaves(opt_state))}}
    x, y = batches[STEPS]
    _, grads = jax_first_step(jspec, host, x, y)
    params, stats, opt_state, _, _ = jstep(params, stats, opt_state,
                                          jnp.asarray(x), jnp.asarray(y))
    return {"x": x, "y": y, "payload": payload, "grads": grads,
            "before": params_np(host["params"]), "after": params_np(params)}


def port_fourth_update(j, reset=False):
    """The port's state from checkpoint_from_jax, then a fourth step:
    (parameters before, parameters after)."""
    ck = checkpoint_from_jax(j["payload"], "Autoencoder", "PointNet", "Cube", "chamfer")
    spec = port_spec(seed=3)
    opt = tharness.make_optimizer(spec)
    tharness.load_state(spec.model, ck["model"])
    if not reset:  # the planted fault: Adam starts afresh at the fourth step
        opt.load_state_dict(ck["optimizer"])
    before = port_params(spec)
    tharness.make_train_step(spec, opt)(torch.from_numpy(j["x"]), torch.from_numpy(j["y"]))
    return spec, before, port_params(spec)


def jax_moments(payload):
    """optax's mu and nu of a payload, state_dict-keyed, through JAX's own
    tree functions."""
    leaves = payload["opt_state_leaves"]
    leaves = [leaves[str(i)] for i in range(len(leaves))]
    treedef = jax.tree_util.tree_structure(payload["params"])
    n = treedef.num_leaves
    return [{k: v.numpy() for k, v in flax_to_state_dict({"params": (
        jax.tree_util.tree_unflatten(treedef, part))}).items()}
        for part in (leaves[1:1 + n], leaves[1 + n:])]


def check_carried_update(got, want, before, grads, nu, zero, b1=0.9, b2=0.999):
    """The fourth update of the port, `got`, against JAX's, `want`, given
    the fourth gradient and the carried second moment `nu` (see the module
    docstring)."""
    step = STEPS + 1
    for k, g in grads.items():
        ut, uj = got[k] - before[k], want[k] - before[k]
        assert np.abs(ut - uj).max() <= 2 * LR, k
        if k in zero:
            continue
        sig = (np.abs(g) > 1e-2 * np.abs(g).max()) & (np.abs(g) > 1e-6)
        v_hat = (b2 * nu[k] + (1 - b2) * g * g) / (1 - b2 ** step)
        moved = 1e-3 * LR * (1 - b1) / (1 - b1 ** step) * np.abs(g) / (np.sqrt(v_hat) + 1e-8)
        tol = 1e-3 * np.abs(uj) + 2 * np.spacing(np.abs(before[k])) + moved
        bad = sig & (np.abs(ut - uj) > tol)
        assert not bad.any(), (k, ut[bad][:5], uj[bad][:5])


def test_adam_state_converts_from_optax(jax_run):
    j = jax_run
    ck = checkpoint_from_jax(j["payload"], "Autoencoder", "PointNet", "Cube", "chamfer")
    assert ck["epoch"] == 0 and ck["config"]["loss_override"] == "chamfer"
    spec = port_spec()
    names = [n for n, _ in spec.model.named_parameters()]
    state = ck["optimizer"]["state"]
    assert sorted(state) == list(range(len(names)))
    leaves = [j["payload"]["opt_state_leaves"][str(i)]
              for i in range(len(j["payload"]["opt_state_leaves"]))]
    n = len(names)
    mu = flax_to_state_dict({"params": jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(j["payload"]["params"]), leaves[1:1 + n])})
    for i, name in enumerate(names):
        assert float(state[i]["step"]) == STEPS
        assert torch.equal(state[i]["exp_avg"], mu[name]), name
        assert state[i]["exp_avg_sq"].shape == mu[name].shape
        assert bool((state[i]["exp_avg_sq"] >= 0).all()), name
    weight = "decoder.MLP_0.Dense_0.weight"  # a transposed Dense kernel
    assert state[names.index(weight)]["exp_avg"].shape == spec.model.state_dict()[weight].shape


def test_adam_state_conversion_refuses_a_mismatch(jax_run):
    j = jax_run
    spec = port_spec()
    leaves = j["payload"]["opt_state_leaves"]
    with pytest.raises(ValueError):
        adam_state_from_optax(spec.model, j["payload"]["params"],
                              [leaves[str(i)] for i in range(len(leaves) - 1)])
    other = tharness.create_model("Autoencoder", "PointNet2", "Cube", device="cpu")
    with pytest.raises(KeyError):
        adam_state_from_optax(other.model, j["payload"]["params"], leaves)


def test_carried_adam_state_takes_jax_fourth_update(jax_run):
    j = jax_run
    spec, before, after = port_fourth_update(j)
    np.testing.assert_array_equal(
        np.concatenate([v.ravel() for v in before.values()]),
        np.concatenate([j["before"][k].ravel() for k in before]))
    check_carried_update(after, j["after"], before, j["grads"],
                         jax_moments(j["payload"])[1], zero_gradient_biases(spec.model))


def test_adam_reset_fails_the_rule(jax_run):
    j = jax_run
    spec, before, after = port_fourth_update(j, reset=True)
    with pytest.raises(AssertionError):
        check_carried_update(after, j["after"], before, j["grads"],
                             jax_moments(j["payload"])[1], zero_gradient_biases(spec.model))
