"""In-repo RL (port of pointcloud_tpu/rl; reference: rl/ — ReplayBuffer,
DDPG, HER, TQC hyperparams).

PyTorch implementations whose nets and update steps run on the card (or the
device the caller names); agents consume the GoalEnv dict observation
{'observation', 'achieved_goal', 'desired_goal'}.
"""

from pointcloud_tpu_torch.rl.buffers import ReplayBuffer, her_sample
from pointcloud_tpu_torch.rl.core import MLPActorCritic
from pointcloud_tpu_torch.rl.ddpg import ddpg, her
from pointcloud_tpu_torch.rl.tqc import TQC, tqc

__all__ = [
    "ReplayBuffer",
    "her_sample",
    "MLPActorCritic",
    "ddpg",
    "her",
    "TQC",
    "tqc",
]
