"""Convert flax variables of the JAX package into the port's state_dict.

The input is a flax `{"params": ..., "batch_stats": ...}` tree given as
nested dicts of numpy arrays. The port's modules carry the flax module names,
so a state_dict key is the flax path joined by dots, with these leaf rules:

  params/.../kernel (in, out)          -> .../weight (out, in), transposed
  params/.../{bias, scale, offset}     -> .../{bias, scale, offset}, as is
  batch_stats/.../{mean, var}          -> .../{mean, var} buffers, as is
  params/.../w{i} (in, out)            -> .../w{i} (in, out), as is
  params/.../{scale, offset}{i}        -> .../{scale, offset}{i}, as is
  batch_stats/.../{mean, var}{i}       -> .../{mean, var}{i} buffers, as is
  params/.../affine_{alpha, beta}      -> .../affine_{alpha, beta}, as is

(the numbered leaves are the per-layer variables of a fused chain: a
SetAbstraction level, a PointMLP PreExtraction or an MLPChainPool; the
affine pair, of shape (1, 1, 1, dim), is a
PointMLP LocalGrouper's).

Both functions are total: a collection or leaf they do not map raises
KeyError, and `load_flax_variables` raises KeyError on any state_dict key
that the tree leaves out or that the module lacks, and ValueError on a shape
that does not match.

`checkpoint_from_jax` turns the payload of a JAX package train() checkpoint
(`params`, `batch_stats`, the optax Adam state as a flat leaf list, `epoch`;
read from its orbax directory by convert_checkpoint_torch.py, which needs
JAX) into the port's checkpoint, Adam's moments and step count included.
"""

from __future__ import annotations

from typing import Mapping

import re

import numpy as np
import torch
from torch import nn

_LEAVES = {
    "params": {"kernel": "weight", "bias": "bias", "scale": "scale",
               "offset": "offset", "affine_alpha": "affine_alpha",
               "affine_beta": "affine_beta"},
    "batch_stats": {"mean": "mean", "var": "var"},
}
_NUMBERED = {
    "params": re.compile(r"(w|scale|offset)\d+"),
    "batch_stats": re.compile(r"(mean|var)\d+"),
}


def _port_leaf(collection: str, leaf: str) -> str | None:
    """The port's name of a flax leaf, None if the collection has no such
    leaf."""
    if _NUMBERED[collection].fullmatch(leaf):
        return leaf
    return _LEAVES[collection].get(leaf)


def _leaves(tree: Mapping, prefix: tuple = ()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _leaves(value, path)
        else:
            yield path, value


def flax_to_state_dict(variables: Mapping) -> dict[str, torch.Tensor]:
    """The port's state_dict for a flax variables tree: fp32 CPU tensors that
    own their memory. A tree's leaves may be read-only views of another
    package's buffers (np.asarray of a JAX CPU array is one), and an optimizer
    state built from these tensors is updated in place."""
    out: dict[str, torch.Tensor] = {}
    for collection, tree in variables.items():
        if collection not in _LEAVES:
            raise KeyError(f"unknown flax collection {collection!r}")
        for path, value in _leaves(tree):
            leaf = path[-1]
            name = _port_leaf(collection, leaf)
            if name is None:
                raise KeyError(
                    f"unknown flax leaf {collection}/{'/'.join(path)}"
                )
            arr = np.asarray(value, dtype=np.float32)
            if leaf == "kernel":
                if arr.ndim != 2:
                    raise ValueError(
                        f"{'/'.join(path)}: a Dense kernel is 2-D, got {arr.shape}"
                    )
                arr = arr.T
            key = ".".join(path[:-1] + (name,))
            if key in out:
                raise KeyError(f"two flax leaves map to {key}")
            out[key] = torch.tensor(arr)
    return out


def load_state_exactly(module: nn.Module, state: Mapping) -> nn.Module:
    """Load a state_dict into `module`: every key, exactly. A key the state
    lacks or the module lacks raises KeyError, a shape that differs
    ValueError."""
    expected = module.state_dict()
    missing = sorted(expected.keys() - state.keys())
    unknown = sorted(state.keys() - expected.keys())
    if missing or unknown:
        raise KeyError(
            f"state does not match the module: missing {missing}, "
            f"unknown {unknown}"
        )
    for key, value in state.items():
        if value.shape != expected[key].shape:
            raise ValueError(
                f"{key}: state gives {tuple(value.shape)}, module has "
                f"{tuple(expected[key].shape)}"
            )
    module.load_state_dict(state)
    return module


def load_flax_variables(module: nn.Module, variables: Mapping) -> nn.Module:
    """Load a flax variables tree into `module` (every key, exactly)."""
    return load_state_exactly(module, flax_to_state_dict(variables))


def flax_params(module: nn.Module) -> dict:
    """The flax `{"params": ...}` tree (nested dicts of fp32 numpy arrays) of
    a module made of Dense layers: flax_to_state_dict's inverse for
    .../weight (out, in) -> .../kernel (in, out) and .../bias. Any other
    state raises KeyError."""
    params: dict = {}
    for key, value in module.state_dict().items():
        *path, leaf = key.split(".")
        arr = value.detach().cpu().numpy().astype(np.float32)
        if leaf == "weight" and arr.ndim == 2:
            leaf, arr = "kernel", arr.T
        elif leaf != "bias":
            raise KeyError(f"{key}: only Dense weights and biases map to flax params")
        node = params
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = np.ascontiguousarray(arr)
    return {"params": params}


def _sorted_leaves(tree: Mapping, prefix: tuple = ()):
    """(path, value) of every leaf in the order jax.tree_util flattens a
    tree of dicts: keys sorted at every level."""
    for key in sorted(tree):
        value = tree[key]
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _sorted_leaves(value, path)
        else:
            yield path, value


def _unflatten(paths, values) -> dict:
    tree: dict = {}
    for path, value in zip(paths, values):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return tree


def adam_state_from_optax(module: nn.Module, params: Mapping,
                          opt_state_leaves) -> dict:
    """torch.optim.Adam's `state` for `module` from optax.adam's state.

    `opt_state_leaves` is the flat leaf list of optax.adam's state, in
    jax.tree_util order (a list, or the JAX harness's {"0": ..., "1": ...}):
    ScaleByAdamState's count, then mu's leaves, then nu's, each in the order
    of `params` (the flax params tree the state belongs to). mu and nu map
    to exp_avg and exp_avg_sq through flax_to_state_dict's names and Dense
    transposes; count becomes every parameter's `step`. The result is keyed
    by the position of each parameter in module.parameters()."""
    if isinstance(opt_state_leaves, Mapping):
        opt_state_leaves = [opt_state_leaves[str(i)]
                            for i in range(len(opt_state_leaves))]
    leaves = list(_sorted_leaves(params))
    n = len(leaves)
    if len(opt_state_leaves) != 1 + 2 * n:
        raise ValueError(f"optax adam state has {len(opt_state_leaves)} leaves, "
                         f"expected 1 + 2 x {n} for these params")
    count = int(np.asarray(opt_state_leaves[0]))
    paths = [path for path, _ in leaves]
    moments = []
    for part in (opt_state_leaves[1:1 + n], opt_state_leaves[1 + n:]):
        for (path, p), m in zip(leaves, part):
            if np.shape(m) != np.shape(p):
                raise ValueError(f"{'/'.join(path)}: adam moment {np.shape(m)} "
                                 f"against param {np.shape(p)}")
        moments.append(flax_to_state_dict({"params": _unflatten(paths, part)}))
    mu, nu = moments
    named = list(module.named_parameters())
    names = {name for name, _ in named}
    if names != mu.keys():
        raise KeyError(f"adam state does not match the module: missing "
                       f"{sorted(names - mu.keys())}, unknown "
                       f"{sorted(mu.keys() - names)}")
    state = {}
    for i, (name, p) in enumerate(named):
        if mu[name].shape != p.shape:
            raise ValueError(f"{name}: adam moment {tuple(mu[name].shape)}, "
                             f"module has {tuple(p.shape)}")
        state[i] = {"step": torch.tensor(float(count)), "exp_avg": mu[name],
                    "exp_avg_sq": nu[name]}
    return state


def checkpoint_from_jax(payload: Mapping, model_type: str, backbone: str,
                        scene: str, loss_override: str | None = None) -> dict:
    """The port's checkpoint (train.harness.checkpoint_payload's four parts,
    CPU tensors) from a JAX package train() checkpoint payload: the weights
    and running statistics through load_flax_variables, Adam's state through
    adam_state_from_optax, the epoch as is. A port run resumed from it takes
    the same next update as the JAX run."""
    from pointcloud_tpu_torch.train.harness import (
        checkpoint_payload,
        create_model,
        make_optimizer,
    )

    spec = create_model(model_type, backbone, scene, loss_override=loss_override,
                        device="cpu")
    load_flax_variables(spec.model, {"params": payload["params"],
                                     "batch_stats": payload["batch_stats"]})
    optimizer = make_optimizer(spec)
    state_dict = optimizer.state_dict()
    state_dict["state"] = adam_state_from_optax(spec.model, payload["params"],
                                                payload["opt_state_leaves"])
    optimizer.load_state_dict(state_dict)
    return checkpoint_payload(spec, optimizer, int(np.asarray(payload["epoch"])),
                              loss_override)
