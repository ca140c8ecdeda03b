"""ObservationEncoder abstraction (a copy of pointcloud_tpu/envs/encoders.py
with the spaces of envs/spaces.py; reference: robosuite_envs/encoders.py:7-102;
tests/test_torch_env_layer.py holds the code equal to the original).

Encoders turn a sensor observation into the agent-facing encoding (O -> E)
and the achieved-goal encoding. Same public API as the reference: the
encode_observation / encode_goal / get_encoding_space / get_goal_space /
__call__ quintet plus the requires_vision / latent_encoding /
global_encoding class flags.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np

from pointcloud_tpu_torch.envs.spaces import Box


def flatten_observations(obs: dict, keys, dtype=np.float32) -> np.ndarray:
    """Gather and flatten observation values (reference encoders.py:7-10)."""
    arrs = [np.asarray(obs[key]).reshape((-1,)) for key in keys]
    return (
        np.concatenate(arrs, dtype=dtype) if arrs else np.array([], dtype=dtype)
    )


def flatten_space(observation_spec: dict, keys, low=-np.inf, high=np.inf, dtype=np.float32):
    """Box space over the flattened keys of an observation spec
    (reference flatten_robosuite_space, encoders.py:12-15)."""
    dim = 0
    for key in keys:
        v = observation_spec[key]
        dim += int(np.prod(np.shape(v))) if np.ndim(v) > 0 else 1
    return Box(low=dtype(low), high=dtype(high), shape=(dim,))


class ObservationEncoder(ABC):
    """O -> E; also produces the achieved-goal encoding (encoders.py:19-83)."""

    requires_vision = False  # encoder needs rendering/vision
    latent_encoding = False  # encoding lives in latent space (vs state space)
    global_encoding = False  # single global vector for the whole observation
    dtype = np.float32

    def __init__(self, env, obs_keys, goal_keys):
        self.env = env
        self.obs_keys = [obs_keys] if isinstance(obs_keys, str) else list(obs_keys)
        self.goal_keys = [goal_keys] if isinstance(goal_keys, str) else list(goal_keys)

    @abstractmethod
    def encode_observation(self, observation):
        """Encoding of the observation, excluding proprioception."""

    @abstractmethod
    def encode_goal(self, observation):
        """Goal-space encoding of the observation."""

    @abstractmethod
    def get_encoding_space(self, robo_env) -> Box:
        """Observation-encoding space."""

    @abstractmethod
    def get_goal_space(self, robo_env) -> Box:
        """Goal-encoding space."""

    def __call__(self, observation):
        """(observation encoding, achieved-goal encoding)."""
        return self.encode_observation(observation), self.encode_goal(observation)

    @staticmethod
    def concat_spaces(*spaces):
        lows = np.concatenate([s.low for s in spaces], axis=0)
        highs = np.concatenate([s.high for s in spaces], axis=0)
        return Box(lows, highs)


class PassthroughEncoder(ObservationEncoder):
    """Flattened ground truth as the encoding (encoders.py:87-102) — the
    control configuration and GT success checker."""

    requires_vision = False
    latent_encoding = False
    global_encoding = False

    def encode_observation(self, obs):
        return flatten_observations(obs, self.obs_keys, self.dtype)

    def encode_goal(self, obs):
        return flatten_observations(obs, self.goal_keys, self.dtype)

    def get_encoding_space(self, robo_env):
        return flatten_space(robo_env.observation_spec(), self.obs_keys, dtype=self.dtype)

    def get_goal_space(self, robo_env):
        return flatten_space(robo_env.observation_spec(), self.goal_keys, dtype=self.dtype)
