"""Models: the PointNet encoder and the autoencoder heads."""

from pointcloud_tpu_torch.models.architectures import (  # noqa: F401
    AE,
    MLP,
    PCDecoder,
    PCEncoder,
    PCEncoderDecoder,
    backbone_factory,
    encoding_dim_of,
)
from pointcloud_tpu_torch.models.pointnet import (  # noqa: F401
    STN,
    BNMaxPool,
    DenseBNMaxPool,
    PointNetEncoder,
    PointwiseMLP,
    masked_max,
)
