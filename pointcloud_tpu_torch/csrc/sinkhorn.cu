// Log-domain Sinkhorn matching for the Earth Mover's Distance (sm_90a).
//
// Replaces pointcloud_tpu/ops/pallas_kernels.py:_sinkhorn_kernel (reached
// through sinkhorn_match_pallas). For clouds x (B, N, 3) and y (B, M, 3) with
// uniform weights 1/N and 1/M it runs `iters` iterations of
//   g_j <- eps_t (log(1/M) - logsumexp_i((f_i - |x_i - y_j|^2) / eps_t))
//   f_i <- eps_t (log(1/N) - logsumexp_j((g_j - |x_i - y_j|^2) / eps_t))
// from f = g = 0 (g first, from the old f; f from the new g), then writes
//   assignment_i = argmax_j (f_i + g_j - |x_i - y_j|^2), lowest j on ties,
//   dists_i      = max(|x_i - y_assignment_i|^2, 0).
// The (B, N, M) cost matrix never reaches device memory.
//
// What differs from the TPU kernel. That kernel runs one program per cloud
// and keeps the whole (N, M) cost matrix in VMEM (16 MB at 2048^2) for its
// 2 iters + 1 sweeps. An SM has 227 KB of shared memory, so here every sweep
// recomputes the cost from the two clouds (24 KB each at 2048 points), in
// direct fp32 differences on the CUDA cores: a low-precision product would
// put ~1e-3 on a cost that is then divided by eps. And one program per cloud
// would leave the card idle, but the two half-steps are one function with the
// clouds' roles swapped,
//   out_p = eps (log_w - logsumexp_q((in_q - |a_p - b_q|^2) / eps)),
// which needs no reduction across blocks. So `sweep_kernel` runs over a grid
// of (ceil(P / 256), B) blocks, one thread per output p. A block stages the
// other cloud and its potential through shared memory in tiles of 1024
// points, (b_q, in_q log2(e)/eps) as one float4 that every thread of a warp
// reads at once (a broadcast). A thread keeps an online (max, sum) pair in
// registers, in base 2: it forms 8 exponents, folds their maximum into the
// running one, rescales the sum once and adds 8 ex2 terms, so a pair costs
// about one special-function operation. The q order is fixed and no atomics
// are used: two runs on the same inputs are bit-equal. One call of
// `sinkhorn_launch` enqueues the 2 iters sweeps and `assign_kernel` in
// stream order (the launch boundary is the barrier between half-steps); the
// eps schedule is read from host memory, one value per iteration, so a
// constant and an annealed eps are one code path. The TPU kernel's
// constant-eps "scaled domain" is an arithmetic shortcut and is not carried
// over: f and g are always stored unscaled.
//
// `assign_kernel` forms the score (f_i + g_j) - d_ij with separately rounded
// operations in the plain version's order, so for equal potentials its
// argmax and dists equal the plain version's bit for bit. The potentials
// themselves differ from the plain version's by rounding (ex2.approx and
// another summation order), so near-tied rows can flip: ops/sinkhorn.py.
//
// Bound on the card: B (N M) (2 iters + 1) pair visits. A sweep's pair costs
// one ex2 on the special-function units (16 a clock an SM, an eighth of the
// fp32 lanes) and ~13 fp32 operations (3 sub, 3 mul, 2 add for the distance,
// a fused scale-and-shift, a max, a subtraction and an addition for the online
// sum, the rescale spread over 8 pairs); the ex2 rate binds. Bytes are
// negligible: each cloud is read once and 8 bytes are written per point. At
// B=128, N=M=2048, 50 iterations: 5.4e10 pair visits, ~13 ms of ex2 against
// ~10.5 ms of fp32 at 67 TFLOP/s. This first version spends ~13 instructions
// on a pair (7 of them on the distance), and the rate at which an SM starts
// instructions, not yet the special-function units, is what limits it: 26.7
// ms there on an NVIDIA H100 80GB HBM3 at 700 W. Several outputs a thread
// (one shared-memory read for several pairs) are a later change.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // outputs per block, one per thread
constexpr int kTile = 1024;    // points of the other cloud staged per step
constexpr int kChunk = 8;      // exponents formed before one rescale of the sum
constexpr float kLn2 = 0.69314718055994531f;
constexpr double kLog2e = 1.4426950408889634;

static_assert(kTile % kChunk == 0, "a tile is padded to whole chunks");

// 2^x on the special-function unit (relative error about 2^-22; -inf -> 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// out_p = eps (log_w - logsumexp_q((in_q - |a_p - b_q|^2) / eps)) for every
// point p of cloud a (B, P, 3) against cloud b (B, Q, 3) with potential in
// (B, Q); k = log2(e) / eps.
__global__ void __launch_bounds__(kThreads) sweep_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ in, float* __restrict__ out, int p_n, int q_n,
    float eps, float k, float log_w) {
  __shared__ float4 s_b[kTile];

  const int cloud = blockIdx.y;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const bool active = p < p_n;
  // inactive threads take part in the tile loads and barriers on point 0
  const float* ap = a + (static_cast<int64_t>(cloud) * p_n + (active ? p : 0)) * 3;
  const float ax = ap[0], ay = ap[1], az = ap[2];
  const float* bq = b + static_cast<int64_t>(cloud) * q_n * 3;
  const float* inq = in + static_cast<int64_t>(cloud) * q_n;

  float m = -INFINITY;  // running maximum of the base-2 exponents
  float s = 0.f;        // sum of 2^(t - m)
  for (int base = 0; base < q_n; base += kTile) {
    const int cnt = min(kTile, q_n - base);
    const int padded = (cnt + kChunk - 1) / kChunk * kChunk;
    __syncthreads();  // the previous tile is no longer read
    for (int j = threadIdx.x; j < padded; j += kThreads) {
      float4 v = make_float4(0.f, 0.f, 0.f, -INFINITY);  // padding adds 2^-inf
      if (j < cnt) {
        const float* r = bq + static_cast<int64_t>(base + j) * 3;
        v = make_float4(r[0], r[1], r[2], inq[base + j] * k);
      }
      s_b[j] = v;
    }
    __syncthreads();
    for (int j0 = 0; j0 < padded; j0 += kChunk) {
      float t[kChunk];
      float cmax = -INFINITY;
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const float4 v = s_b[j0 + u];
        const float dx = ax - v.x, dy = ay - v.y, dz = az - v.z;
        float d = dx * dx;
        d = fmaf(dy, dy, d);
        d = fmaf(dz, dz, d);
        t[u] = fmaf(-k, d, v.w);  // (in_q - d) log2(e) / eps
        cmax = fmaxf(cmax, t[u]);
      }
      // every chunk holds a real point, so new_m is finite; the first chunk
      // rescales the empty sum by 2^-inf = 0
      const float new_m = fmaxf(m, cmax);
      float s0 = s * ex2(m - new_m), s1 = 0.f;
#pragma unroll
      for (int u = 0; u < kChunk; u += 2) {
        s0 += ex2(t[u] - new_m);
        s1 += ex2(t[u + 1] - new_m);
      }
      s = s0 + s1;
      m = new_m;
    }
  }
  if (active) {
    out[static_cast<int64_t>(cloud) * p_n + p] =
        eps * (log_w - kLn2 * (m + log2f(s)));
  }
}

// assignment_i = argmax_j ((f_i + g_j) - d_ij) with the lowest j on ties and
// dists_i = max(d at the assignment, 0); d = (dx^2 + dy^2) + dz^2, every
// operation rounded on its own, as the plain version's.
__global__ void __launch_bounds__(kThreads) assign_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ f, const float* __restrict__ g,
    float* __restrict__ dists, int* __restrict__ assign, int n, int m) {
  __shared__ float4 s_y[kTile];

  const int cloud = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool active = i < n;
  const int64_t row = static_cast<int64_t>(cloud) * n + (active ? i : 0);
  const float xx = x[row * 3], xy = x[row * 3 + 1], xz = x[row * 3 + 2];
  const float fi = f[row];
  const float* yq = y + static_cast<int64_t>(cloud) * m * 3;
  const float* gq = g + static_cast<int64_t>(cloud) * m;

  float best = -INFINITY, best_d = 0.f;
  int best_j = 0;
  for (int base = 0; base < m; base += kTile) {
    const int cnt = min(kTile, m - base);
    __syncthreads();
    for (int j = threadIdx.x; j < cnt; j += kThreads) {
      const float* r = yq + static_cast<int64_t>(base + j) * 3;
      s_y[j] = make_float4(r[0], r[1], r[2], gq[base + j]);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < cnt; ++j) {
      const float4 v = s_y[j];
      const float dx = __fsub_rn(xx, v.x);
      const float dy = __fsub_rn(xy, v.y);
      const float dz = __fsub_rn(xz, v.z);
      const float d = __fadd_rn(
          __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      const float score = __fsub_rn(__fadd_rn(fi, v.w), d);
      if (score > best) {  // strict: the lowest index wins ties
        best = score;
        best_d = d;
        best_j = base + j;
      }
    }
  }
  if (active) {
    dists[row] = fmaxf(best_d, 0.f);
    assign[row] = best_j;
  }
}

}  // namespace

// Plain C entry point for ctypes. x (b, n, 3), y (b, m, 3), f (b, n), g (b, m),
// dists (b, n) and assign (b, n) are device pointers of contiguous tensors; f
// must hold zeros, g is scratch. eps_schedule is a HOST pointer to `iters`
// floats. Enqueues 2 iters + 1 kernels on `stream`; returns the first CUDA
// error of a launch (0 on success). The caller checked the bounds.
extern "C" int sinkhorn_launch(const float* x, const float* y, float* f,
                               float* g, float* dists, int* assign,
                               const float* eps_schedule, int iters, int b,
                               int n, int m, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid_x((n + kThreads - 1) / kThreads, b);
  const dim3 grid_y((m + kThreads - 1) / kThreads, b);
  const float log_mu = static_cast<float>(-log(static_cast<double>(n)));
  const float log_nu = static_cast<float>(-log(static_cast<double>(m)));
  for (int t = 0; t < iters; ++t) {
    const float eps = eps_schedule[t];
    const float k = static_cast<float>(kLog2e / static_cast<double>(eps));
    sweep_kernel<<<grid_y, kThreads, 0, s>>>(y, x, f, g, m, n, eps, k, log_nu);
    sweep_kernel<<<grid_x, kThreads, 0, s>>>(x, y, g, f, n, m, eps, k, log_mu);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  assign_kernel<<<grid_x, kThreads, 0, s>>>(x, y, f, g, dists, assign, n, m);
  return static_cast<int>(cudaGetLastError());
}
