"""Shared helpers of the port's parity tests (tests/test_torch_*.py)."""

import numpy as np
import torch

# Tier-1 runs the tests under several xdist workers: one thread each.
torch.set_num_threads(1)


def random_variables(variables, rng):
    """A flax variables tree with every leaf redrawn from `rng` (numpy), so
    that BatchNorm, the pools and the STN heads are not the identity:
    kernels ~ N(0, 1/fan_in), biases/offsets ~ N(0, 0.1), BN scales of
    random sign (some negative, which sends the pool through its min branch),
    running means ~ N(0, 0.1) and running variances in [0.5, 2]."""

    def draw(path, leaf):
        shape = np.shape(leaf)
        name = path[-1]
        if name == "kernel":
            return rng.standard_normal(shape) / np.sqrt(shape[0])
        if name == "scale":
            sign = np.where(rng.random(shape) < 0.2, -1.0, 1.0)
            return sign * rng.uniform(0.5, 1.5, shape)
        if name == "var":
            return rng.uniform(0.5, 2.0, shape)
        return 0.1 * rng.standard_normal(shape)  # bias, offset, mean

    def walk(tree, path=()):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = walk(v, path + (k,))
            else:
                out[k] = draw(path + (k,), v).astype(np.float32)
        return out

    return walk(variables)


def to_np(t):
    return np.asarray(t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t)
