"""Host-side data pipeline: npz datasets and batch loaders."""

from pointcloud_tpu_torch.data.dataset import (
    BatchLoader,
    PointCloudDataset,
    PointCloudGTDataset,
    obs_to_pc,
)

__all__ = ["PointCloudDataset", "PointCloudGTDataset", "obs_to_pc", "BatchLoader"]
