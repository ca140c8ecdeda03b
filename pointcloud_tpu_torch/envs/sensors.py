"""Sensor abstraction (a copy of pointcloud_tpu/envs/sensors.py; reference:
robosuite_envs/sensors.py:4-41; tests/test_torch_env_layer.py holds the
code equal to the original).

A Sensor converts the ground-truth simulator state into an observation dict
(S -> O) that an ObservationEncoder can encode. Same public API as the
reference: `observe(state)`, optional `reset()` and `env_kwargs`, and the
`requires_vision` class flag.
"""

from __future__ import annotations

from abc import ABC, abstractmethod


class Sensor(ABC):
    """Layer between the environment and the encoder (S -> O)."""

    requires_vision = False

    def __init__(self, env, **kwargs):
        self.env = env

    @property
    def env_kwargs(self) -> dict:
        """Extra kwargs for the simulator backend (e.g. camera settings)."""
        return {}

    def reset(self):
        pass

    @abstractmethod
    def observe(self, state: dict) -> dict:
        """Observation dict for the given ground-truth state."""


class PassthroughSensor(Sensor):
    """Identity sensor: the ground truth IS the observation — the control
    configuration used by all GT envs and as the test fixture
    (reference sensors.py:37-41)."""

    requires_vision = False

    def observe(self, state):
        return state
