"""Model wiring and steps."""

from pointcloud_tpu_torch.train.harness import (  # noqa: F401
    TrainSpec,
    create_model,
    make_eval_step,
)
