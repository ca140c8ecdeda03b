"""Models: the PointNet, PointNet2 (SSG and MSG) and PointMLP encoders, the
autoencoder and segmenter heads, the per-class MultiSegAE and the state
heads (GTEncoder, MultiGTEncoder)."""

from pointcloud_tpu_torch.models.architectures import (  # noqa: F401
    AE,
    MLP,
    GTEncoder,
    MultiGTEncoder,
    MultiSegAE,
    PCDecoder,
    PCEncoder,
    PCEncoderDecoder,
    PCSegmenter,
    SegAE,
    backbone_factory,
    encoding_dim_of,
)
from pointcloud_tpu_torch.models.pointmlp import (  # noqa: F401
    LocalGrouper,
    PointMLP,
    PointMLPElite,
    PointMLPModel,
    PosExtraction,
    PreExtraction,
)
from pointcloud_tpu_torch.models.pointnet import (  # noqa: F401
    STN,
    BNMaxPool,
    DenseBNMaxPool,
    MLPChainPool,
    PointNetEncoder,
    PointwiseMLP,
    check_train_mask_contract,
    masked_max,
)
from pointcloud_tpu_torch.models.pointnet2 import (  # noqa: F401
    PointNet2Encoder,
    PointNet2MSGEncoder,
    PointNet2SSGEncoder,
    SetAbstraction,
    SetAbstractionMsg,
)
