"""Mesh / sharding helpers (re-exported from the train harness so library
users don't need to import the trainer; port of
pointcloud_tpu/parallel/mesh.py)."""

from pointcloud_tpu_torch.train.harness import data_mesh, replicate, shard_batch

__all__ = ["data_mesh", "replicate", "shard_batch"]
