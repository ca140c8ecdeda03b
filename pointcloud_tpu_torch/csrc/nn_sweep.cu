// Bidirectional nearest-neighbour sweep for Chamfer distance (sm_90a).
//
// Replaces pointcloud_tpu/ops/pallas_kernels.py:_nn_kernel (reached through
// nearest_neighbor_pallas). For clouds x (B, N, C) and y (B, M, C), C <= 8,
// it writes, for every x point, the squared distance to its nearest valid y
// point and that point's index, and the same for every y point against x:
//   min_x (B, N) f32, amin_x (B, N) i32, min_y (B, M) f32, amin_y (B, M) i32.
// The (B, N, M) cost matrix never reaches device memory.
//
// Semantics (shared with the plain version, ops/nn_sweep.py):
//   * distance is the direct fp32 sum over C of (q - t)^2;
//   * a masked target costs exactly 1e10 (the where(mask, d, BIG) of the
//     dense path), so a query with no valid target gets 1e10 and index 0;
//   * targets are scanned in index order with a strict `<`, so the FIRST
//     minimal index wins ties, as jnp.argmin / torch.argmin do;
//   * the result is clamped at 0, and a masked query gets +1e10 on top of its
//     minimum (its index is still the nearest valid target's).
//
// Design: one thread per query point, kThreads queries per block. The block
// walks the target cloud in kTile-point tiles staged in shared memory; every
// thread reads the same target at the same time (a shared-memory broadcast)
// and keeps a running (min, argmin) in registers. Both directions run in one
// launch: blockIdx.z == 0 sweeps x against y, blockIdx.z == 1 y against x.
//
// Bound on the card: per direction and per (query, target) pair the sweep
// does C subtractions, C multiplications, C-1 additions and one comparison,
// i.e. B*N*M*3C fp32 operations on the CUDA cores (no tensor cores). Bytes are
// negligible: each cloud is read once and 8 bytes are written per point. At
// B=512, N=M=2048, C=6 that is 7.7e10 operations for both directions, about
// 1.2 ms at 67 TFLOP/s fp32. The split-bf16 MXU cross term of the TPU kernel
// is a TPU workaround and is not carried over; a tensor-core cross term and
// register tiling of several queries per thread are left to a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // queries per block, one per thread
constexpr int kTile = 256;     // targets staged in shared memory per step
constexpr float kBig = 1e10f;  // masked-point penalty (ops/geometry.py _BIG)

// Scan all targets of one cloud for the query held in registers.
template <int C, bool kTargetMask>
__device__ __forceinline__ void sweep_targets(
    const float (&qv)[C], const float* __restrict__ t,
    const uint8_t* __restrict__ t_mask, int nt, float* s_t, uint8_t* s_valid,
    float& best, int& best_j) {
  for (int base = 0; base < nt; base += kTile) {
    const int cnt = min(kTile, nt - base);
    __syncthreads();  // the previous tile is no longer read
    for (int k = threadIdx.x; k < cnt * C; k += kThreads) {
      s_t[k] = t[static_cast<int64_t>(base) * C + k];
    }
    if (kTargetMask) {
      for (int k = threadIdx.x; k < cnt; k += kThreads) {
        s_valid[k] = t_mask[base + k];
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < cnt; ++j) {
      float d = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float diff = qv[c] - s_t[j * C + c];
        d = fmaf(diff, diff, d);
      }
      if (kTargetMask && !s_valid[j]) d = kBig;
      if (d < best) {  // strict: the first minimal index wins
        best = d;
        best_j = base + j;
      }
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads) nn_sweep_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const uint8_t* __restrict__ x_mask, const uint8_t* __restrict__ y_mask,
    float* __restrict__ min_x, int* __restrict__ amin_x,
    float* __restrict__ min_y, int* __restrict__ amin_y, int n, int m) {
  __shared__ float s_t[kTile * C];
  __shared__ uint8_t s_valid[kTile];

  const bool x_side = blockIdx.z == 0;
  const int nq = x_side ? n : m;
  const int nt = x_side ? m : n;
  // whole blocks past the shorter cloud leave together, before any barrier
  if (static_cast<int>(blockIdx.x) * kThreads >= nq) return;

  const int b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool active = i < nq;
  const float* q = (x_side ? x : y) + static_cast<int64_t>(b) * nq * C;
  const float* t = (x_side ? y : x) + static_cast<int64_t>(b) * nt * C;
  const uint8_t* q_mask = x_side ? x_mask : y_mask;
  const uint8_t* t_mask = x_side ? y_mask : x_mask;

  float qv[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    // inactive threads still take part in the tile loads and barriers
    qv[c] = active ? q[static_cast<int64_t>(i) * C + c] : 0.f;
  }

  float best = __int_as_float(0x7f800000);  // +inf: index 0 wins if all BIG
  int best_j = 0;
  if (t_mask != nullptr) {
    sweep_targets<C, true>(qv, t, t_mask + static_cast<int64_t>(b) * nt, nt,
                           s_t, s_valid, best, best_j);
  } else {
    sweep_targets<C, false>(qv, t, nullptr, nt, s_t, s_valid, best, best_j);
  }

  if (active) {
    const int64_t o = static_cast<int64_t>(b) * nq + i;
    float v = fmaxf(best, 0.f);
    if (q_mask != nullptr && !q_mask[o]) v += kBig;
    (x_side ? min_x : min_y)[o] = v;
    (x_side ? amin_x : amin_y)[o] = best_j;
  }
}

template <int C>
cudaError_t launch(const float* x, const float* y, const uint8_t* x_mask,
                   const uint8_t* y_mask, float* min_x, int* amin_x,
                   float* min_y, int* amin_y, int b, int n, int m,
                   cudaStream_t stream) {
  const int longest = n > m ? n : m;
  const dim3 grid((longest + kThreads - 1) / kThreads, b, 2);
  nn_sweep_kernel<C><<<grid, kThreads, 0, stream>>>(
      x, y, x_mask, y_mask, min_x, amin_x, min_y, amin_y, n, m);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. Pointers are device pointers of contiguous
// tensors; masks are bool (one byte per point) or null. Returns the CUDA
// error code of the launch (0 on success); the caller checked the bounds.
extern "C" int nn_sweep_launch(const float* x, const float* y,
                               const uint8_t* x_mask, const uint8_t* y_mask,
                               float* min_x, int* amin_x, float* min_y,
                               int* amin_y, int b, int n, int m, int c,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NN_SWEEP_CASE(C_)                                                    \
  case C_:                                                                   \
    return launch<C_>(x, y, x_mask, y_mask, min_x, amin_x, min_y, amin_y, b, \
                      n, m, s);
  switch (c) {
    NN_SWEEP_CASE(1)
    NN_SWEEP_CASE(2)
    NN_SWEEP_CASE(3)
    NN_SWEEP_CASE(4)
    NN_SWEEP_CASE(5)
    NN_SWEEP_CASE(6)
    NN_SWEEP_CASE(7)
    NN_SWEEP_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef NN_SWEEP_CASE
}
