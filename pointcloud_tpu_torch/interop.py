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

(the numbered leaves are the per-layer variables of a SetAbstraction level
or a PointMLP PreExtraction; the affine pair, of shape (1, 1, 1, dim), is a
PointMLP LocalGrouper's).

Both functions are total: a collection or leaf they do not map raises
KeyError, and `load_flax_variables` raises KeyError on any state_dict key
that the tree leaves out or that the module lacks, and ValueError on a shape
that does not match.
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
    """The port's state_dict (fp32 CPU tensors) for a flax variables tree."""
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
            out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def load_flax_variables(module: nn.Module, variables: Mapping) -> nn.Module:
    """Load a flax variables tree into `module` (every key, exactly)."""
    state = flax_to_state_dict(variables)
    expected = module.state_dict()
    missing = sorted(expected.keys() - state.keys())
    unknown = sorted(state.keys() - expected.keys())
    if missing or unknown:
        raise KeyError(
            f"flax variables do not match the module: missing {missing}, "
            f"unknown {unknown}"
        )
    for key, value in state.items():
        if value.shape != expected[key].shape:
            raise ValueError(
                f"{key}: flax gives {tuple(value.shape)}, module has "
                f"{tuple(expected[key].shape)}"
            )
    module.load_state_dict(state)
    return module
