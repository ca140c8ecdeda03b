"""Model wiring, steps, checkpoints and the training loop."""

from pointcloud_tpu_torch.train.harness import (  # noqa: F401
    TrainSpec,
    create_model,
    make_eval_step,
    make_optimizer,
    make_train_step,
    train,
    zero_gradient_biases,
)
