"""Point-cloud ops: pairwise distances, Chamfer distance and its kernels (the
nearest-neighbour sweep, the fused backward, the segment-sum), and the fused
Dense -> BatchNorm-statistics -> max-pool kernels."""

from pointcloud_tpu_torch.ops.chamfer import (  # noqa: F401
    chamfer_distance,
    masked_chamfer,
    nearest_neighbor_dists,
)
from pointcloud_tpu_torch.ops.chamfer_bwd import (  # noqa: F401
    chamfer_bwd,
    chamfer_bwd_reference,
)
from pointcloud_tpu_torch.ops.dense_bn_pool import (  # noqa: F401
    dense_pool_stats,
    dense_pool_stats_bwd,
    dense_pool_stats_reference,
)
from pointcloud_tpu_torch.ops.geometry import pairwise_sqdist  # noqa: F401
from pointcloud_tpu_torch.ops.nn_sweep import (  # noqa: F401
    nn_sweep,
    nn_sweep_reference,
)
from pointcloud_tpu_torch.ops.scatter_rows import (  # noqa: F401
    scatter_rows,
    scatter_rows_reference,
)
