"""Point-cloud sensor (port of pointcloud_tpu/vision/pc_sensor.py; reference:
pointcloud_vision/pc_sensor.py:10-43).

Fuses the backend's raw cloud into a preprocessed one on the env's device:
FilterBBox to the scene bbox, then FPS or RS downsample to the scene's point
budget (transforms.sensor_chain) — the per-env-step hot path, one `fps`
launch an observation on a card. The result is numpy, as the JAX sensor's.
"""

from __future__ import annotations

import numpy as np
import torch

from pointcloud_tpu_torch.envs.sensors import Sensor
from pointcloud_tpu_torch.transforms import sensor_chain
from pointcloud_tpu_torch.utils import resolve_device
from pointcloud_tpu_torch.utils.profiling import count, span


class PointCloudSensor(Sensor):
    """2.5D observation -> preprocessed point cloud dict compatible with the
    PointCloudDataset save format: 'points' + features ('rgb',
    'segmentation') + 'boundingbox' (reference pc_sensor.py:10-43).

    The original state stays in the observation so GT encoders keep working
    (reference pc_sensor.py:41-43). Each observation draws one integer from
    the sensor's numpy generator, as the JAX sensor draws its PRNG key; under
    RS it seeds the sampler's torch.Generator on the device.
    """

    requires_vision = True

    def __init__(self, env, require_segmentation: bool = False):
        super().__init__(env)
        self.device = resolve_device(env.device)
        self.features = ["rgb"] + (["segmentation"] if require_segmentation else [])
        self.bbox = np.asarray(env.bbox, dtype=np.float32)
        self.sampler = env.sampler
        self.sample_points = env.sample_points
        self._rng = np.random.default_rng(0)

    @property
    def env_kwargs(self):
        return {
            "camera_depths": True,
            "camera_segmentations": "instance"
            if "segmentation" in self.features
            else None,
        }

    def observe(self, state):
        with span("sensor.observe"):
            with span("sensor.capture"):
                points, feats = self.env.backend.capture_pointcloud(
                    features=tuple(self.features)
                )
            with span("sensor.pack"):
                dims = {f: feats[f].shape[-1] for f in self.features}
                pc = np.concatenate([points] + [feats[f] for f in self.features], axis=1)
                pc = torch.from_numpy(np.ascontiguousarray(pc, dtype=np.float32))
            with span("sensor.h2d"):
                pc = pc.to(self.device)
            with span("sensor.chain"):
                chain = sensor_chain(self.bbox, self.sample_points, self.sampler,
                                     int(self._rng.integers(0, 2**31)), self.device)
                out, _ = chain(pc)
            with span("sensor.d2h"):
                count("host_sync")
                out = out.cpu().numpy()

        result = dict(state)
        result["points"] = out[:, :3]
        off = 3
        for f in self.features:
            result[f] = out[:, off : off + dims[f]]
            off += dims[f]
        result["boundingbox"] = self.bbox
        return result
