"""The gym surface of the env layer: `Box`, `Dict` and the `GoalEnv` base.

Where gymnasium is installed they are gymnasium's own classes, and the
GoalEnv is gymnasium_robotics' where that is installed too, else the
JAX package's fallback (pointcloud_tpu/envs/base_env.py:22-29). Elsewhere
(the GPU machine has no gymnasium) they are host-side stand-ins with only
the surface the layer uses:
  * Box: low, high, shape, dtype, sample(), seed();
  * Dict: .spaces (keys sorted, as gymnasium sorts a plain dict's);
  * GoalEnv: reset(seed=) sets `np_random` as gymnasium.utils.seeding does,
    PCG64 over SeedSequence(seed), so goal draws are the same stream; it is
    seeded from fresh entropy when first read without a seed.
"""

from __future__ import annotations

from importlib.util import find_spec

import numpy as np


def _generator(seed=None) -> np.random.Generator:
    """gymnasium.utils.seeding.np_random(seed)'s generator."""
    return np.random.Generator(np.random.PCG64(np.random.SeedSequence(seed)))


if find_spec("gymnasium") is not None:
    import gymnasium
    from gymnasium.spaces import Box, Dict

    if find_spec("gymnasium_robotics") is not None:
        from gymnasium_robotics.core import GoalEnv
    else:

        class GoalEnv(gymnasium.Env):  # the JAX package's fallback
            def reset(self, *, seed=None, options=None):
                return super().reset(seed=seed)

    HAVE_GYMNASIUM = True
else:
    HAVE_GYMNASIUM = False

    class Box:
        """A box in R^n: low and high broadcast to `shape`."""

        def __init__(self, low, high, shape=None, dtype=np.float32):
            self.dtype = np.dtype(dtype)
            if shape is None:
                shape = np.shape(low) if np.shape(low) else np.shape(high)
            self.shape = tuple(int(s) for s in shape)
            self.low = np.full(self.shape, low, dtype=self.dtype)
            self.high = np.full(self.shape, high, dtype=self.dtype)
            self._np_random = None

        @property
        def np_random(self) -> np.random.Generator:
            if self._np_random is None:
                self._np_random = _generator()
            return self._np_random

        def seed(self, seed=None):
            """Reseed the sampler; returns the seed's entropy, as gymnasium."""
            seq = np.random.SeedSequence(seed)
            self._np_random = np.random.Generator(np.random.PCG64(seq))
            return seq.entropy

        def sample(self):
            """gymnasium's Box.sample for float boxes: uniform where bounded,
            exponential past a one-sided bound, normal where unbounded."""
            below = np.isfinite(self.low)
            above = np.isfinite(self.high)
            out = np.empty(self.shape)
            rng = self.np_random
            unbounded, bounded = ~below & ~above, below & above
            upper, lower = ~below & above, below & ~above
            out[unbounded] = rng.normal(size=unbounded[unbounded].shape)
            out[lower] = rng.exponential(size=lower[lower].shape) + self.low[lower]
            out[upper] = -rng.exponential(size=upper[upper].shape) + self.high[upper]
            out[bounded] = rng.uniform(low=self.low[bounded], high=self.high[bounded],
                                       size=bounded[bounded].shape)
            return out.astype(self.dtype)

    class Dict:
        """Named sub-spaces."""

        def __init__(self, spaces):
            self.spaces = dict(sorted(spaces.items()))

    class GoalEnv:
        """The gymnasium GoalEnv surface the env layer uses."""

        _np_random = None

        @property
        def np_random(self) -> np.random.Generator:
            if self._np_random is None:
                self._np_random = _generator()
            return self._np_random

        @property
        def unwrapped(self):
            return self

        def reset(self, *, seed=None, options=None):
            if seed is not None:
                self._np_random = _generator(seed)
