"""The program's kernel names by the work they do, as regular expressions
over the profiler's kernel names (the kernels live in anonymous namespaces:
a name is matched whole, not as a part of a longer one)."""

_W = r"(?<![A-Za-z0-9_])"
# the fused Dense-BN-ReLU-pool chain (csrc/mlp_chain.cu)
MLP_CHAIN = _W + (r"(fwd_wgmma|mm_stats|bn_pool|bwd_dh|bwd_da_wgmma|bwd_dw_wgmma"
                  r"|bwd_da_f32|bwd_dw_f32|colsum)_kernel")
# the Chamfer loss's sweep and backward (csrc/nn_sweep.cu, csrc/chamfer_bwd.cu)
CHAMFER = _W + r"(nn_sweep|chamfer_bwd)_kernel"
# Sinkhorn's sweeps and assignment (csrc/sinkhorn.cu)
SINKHORN = _W + r"(sweep|assign)_kernel"
# farthest-point sampling (csrc/fps.cu)
FPS = _W + r"fps_(block|cluster|scratch)_kernel"
