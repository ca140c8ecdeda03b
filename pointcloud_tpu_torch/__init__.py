"""PyTorch/CUDA port of pointcloud_tpu, for NVIDIA Hopper (H100).

The JAX package `pointcloud_tpu` stays the reference; this package imports
nothing of it, nor JAX. Kernels the JAX package wrote in Pallas are
hand-written CUDA here (csrc/), built on first use (ops/_build.py); each has
a plain PyTorch version that CPU tensors take.
"""

from pointcloud_tpu_torch import cfg  # noqa: F401  (sets the fp32 matmul precision)
