"""Point-cloud ops: pairwise distances, Chamfer distance and its kernels (the
nearest-neighbour sweep, the fused backward, the segment-sum), the fused
Dense -> BatchNorm-statistics -> max-pool kernels, the fused
Dense-BatchNorm-ReLU chain with its group max-pool (plain and residual),
farthest-point sampling,
the ball and kNN groupings (the set abstraction's centred ball grouping and
the legacy grouping's uncentred one), and Earth Mover's Distance matching
with its Sinkhorn kernel."""

from pointcloud_tpu_torch.ops.ball_group import (  # noqa: F401
    ball_group,
    ball_group_plan,
    ball_group_reference,
)
from pointcloud_tpu_torch.ops.chamfer import (  # noqa: F401
    chamfer_distance,
    masked_chamfer,
    nearest_neighbor_dists,
)
from pointcloud_tpu_torch.ops.chamfer_bwd import (  # noqa: F401
    chamfer_bwd,
    chamfer_bwd_plan,
    chamfer_bwd_reference,
)
from pointcloud_tpu_torch.ops.dense_bn_pool import (  # noqa: F401
    dense_pool_stats,
    dense_pool_stats_bwd,
    dense_pool_stats_reference,
    pool_bwd_plan,
    pool_fwd_plan,
)
from pointcloud_tpu_torch.ops.emd import (  # noqa: F401
    auction_match,
    emd_match,
    sinkhorn_match,
)
from pointcloud_tpu_torch.ops.fps import (  # noqa: F401
    farthest_point_sample,
    farthest_point_sample_xyz,
    fps_plan,
    fps_reference,
)
from pointcloud_tpu_torch.ops.geometry import (  # noqa: F401
    ball_query,
    first_k_in_ball,
    group_neighbors,
    index_points,
    knn,
    pairwise_sqdist,
    penalised_sqdist,
    sample_and_group,
    sample_and_group_all,
    three_nn_interpolate,
)
from pointcloud_tpu_torch.ops.group_gather import (  # noqa: F401
    group_gather,
    group_gather_plan,
    group_gather_reference,
)
from pointcloud_tpu_torch.ops.knn_group import (  # noqa: F401
    knn_group,
    knn_group_plan,
    knn_group_reference,
)
from pointcloud_tpu_torch.ops.nn_sweep import (  # noqa: F401
    nn_plan,
    nn_sweep,
    nn_sweep_reference,
)
from pointcloud_tpu_torch.ops.preextract_fused import (  # noqa: F401
    affine_scalars,
    bn_pool,
    bn_pool_plan,
    bn_pool_reference,
    bnact_mm_stats,
    bnact_mm_stats_reference,
    bwd_plan,
    chain_bwd_pass,
    chain_bwd_pass_reference,
    chain_da_reference,
    chain_dh_reference,
    chain_dw_reference,
    fwd_plan,
    mlp_pool_bwd_reference,
    mlp_pool_fused,
    mlp_pool_reference,
    mm_stats,
    mm_stats_reference,
    preextract_pool_bwd_reference,
    preextract_pool_fused,
    preextract_pool_reference,
    up_scalars,
)
from pointcloud_tpu_torch.ops.scatter_rows import (  # noqa: F401
    scatter_grouped,
    scatter_plan,
    scatter_rows,
    scatter_rows_mirror,
    scatter_rows_reference,
)
from pointcloud_tpu_torch.ops.sinkhorn import (  # noqa: F401
    eps_schedule,
    matching_difference,
    sinkhorn,
    sinkhorn_plan,
    sinkhorn_reference,
    top_two_gap,
)
