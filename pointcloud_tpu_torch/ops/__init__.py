"""Point-cloud ops: pairwise distances, the nearest-neighbour sweep kernel
and Chamfer distance."""

from pointcloud_tpu_torch.ops.chamfer import (  # noqa: F401
    chamfer_distance,
    masked_chamfer,
    nearest_neighbor_dists,
)
from pointcloud_tpu_torch.ops.geometry import pairwise_sqdist  # noqa: F401
from pointcloud_tpu_torch.ops.nn_sweep import (  # noqa: F401
    nn_sweep,
    nn_sweep_reference,
)
