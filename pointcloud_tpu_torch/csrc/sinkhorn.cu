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
// recomputes the cost from the two clouds (24 KB each at 2048 points) on the
// fp32 CUDA cores: a low-precision product would put ~1e-3 on a cost that is
// then divided by eps. And one program per cloud would leave the card idle,
// but the two half-steps are one function with the clouds' roles swapped,
//   out_p = eps (log_w - logsumexp_q((in_q - |a_p - b_q|^2) / eps)),
// which needs no reduction across blocks. So `sweep_kernel` runs over a grid
// of (blocks, B), 256 threads a block. The eps schedule is read from host
// memory, one value per iteration, so a constant and an annealed eps are one
// code path; f and g are always stored unscaled (the TPU kernel's
// constant-eps "scaled domain" is an arithmetic shortcut not carried over).
//
// A sweep's pair (p, q) needs one ex2 on the special-function units (16 a
// clock an SM, against 128 fp32 lanes), so past ~8 issued instructions a
// pair the issue rate, not the ex2 units, binds. A pair here issues about 10:
//   - four outputs a thread, so one shared-memory read of (b_q, k in_q)
//     serves four pairs;
//   - no running maximum a pair: a thread sums 2^(t - m) against a
//     reference m, per chunk of 8 q's, and only when a chunk's sum passes
//     2^64 (or is not finite) does it take the chunk's maximum as the new m,
//     rescale its sum and redo the chunk. m is always a value some term took,
//     so the sum holds a term >= 1 and at most 2^11 x 2^64 at 2048 points:
//     no overflow, and an underflowing term is below the sum's rounding. The
//     first chunk starts from m = -inf and always takes this path;
//   - the reference folded into the distance: with mk = m / k,
//       t - m = k in_q - k (|a_p - b_q|^2 + mk),
//     three differences, three FMAs from mk, one FMA, the ex2 and the sum.
//     The distance stays in direct fp32 differences: the expansion
//     |a|^2 - 2 a.b + |b|^2 (three FMAs a pair) rounds at the size of |b|^2
//     instead of the pair's distance, which sent the row of a one-to-three
//     matching, whose three scores tie by construction, to another target.
// Where B alone gives too few blocks, the q range of each staged tile is
// split over 2, 4 or 8 groups of warps (`split`), whose (m, sum) pairs are
// merged in group order at the end (ops/sinkhorn.py sinkhorn_plan picks
// it). The q order within a group, the groups' order and the merge are
// fixed and no atomics are used: two runs on the same inputs are bit-equal.
// One call of `sinkhorn_launch` enqueues the 2 iters sweeps and
// `assign_kernel` in stream order (the launch boundary is the barrier
// between half-steps).
//
// `assign_kernel` forms the score (f_i + g_j) - d_ij with separately rounded
// operations in the plain version's order, in direct differences, so for
// equal potentials its argmax and dists equal the plain version's bit for
// bit. The potentials themselves differ from the plain version's by rounding
// (ex2.approx, another summation order), so near-tied rows can flip:
// ops/sinkhorn.py.
//
// Bound on the card: B (N M) (2 iters + 1) pair visits, each sweep's pair
// one ex2 (special-function units, an eighth of the fp32 lanes) and the
// exponent's 3 differences, 4 FMAs and the sum's add on the fp32 lanes
// (11 operations); the ex2 rate binds. Bytes
// are negligible: each cloud is read once and 8 bytes are written per point.
// At B=128, N=M=2048, 50 iterations: 5.4e10 pair visits, 12.8 ms of ex2 on
// an H100 (ex2 at 16 a clock an SM).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads a block
constexpr int kOut = 4;        // outputs a thread
constexpr int kTile = 1024;    // points of the other cloud staged per step
constexpr int kChunk = 8;      // q's summed against one reference maximum
constexpr float kLn2 = 0.69314718055994531f;
constexpr double kLog2e = 1.4426950408889634;
constexpr float kBig = 18446744073709551616.f;  // 2^64: a chunk's largest sum

static_assert(kTile % kChunk == 0, "a tile is padded to whole chunks");

// 2^x on the special-function unit (relative error about 2^-22; -inf -> 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The cold path of a sweep: the chunk of kChunk staged q's at `q` summed
// past 2^64 for the output at (ax, ay, az). Its largest exponent
// t = k (in_q - d) becomes the reference (mk = t / k, if above the old one),
// the sum so far s is rescaled to it and the chunk summed again. Returns
// (mk, s, the chunk's sum).
__device__ __forceinline__ float3 rescale_chunk(const float4* q, float ax, float ay, float az,
                                             float mk, float s, float k) {
  float cmax = -INFINITY;
  for (int u = 0; u < kChunk; ++u) {
    const float4 v = q[u];
    const float dx = ax - v.x, dy = ay - v.y, dz = az - v.z;
    cmax = fmaxf(cmax, fmaf(-k, fmaf(dz, dz, fmaf(dy, dy, dx * dx)), v.w));
  }
  const float mn = fmaxf(mk, cmax / k);
  float cs = 0.f;
  for (int u = 0; u < kChunk; ++u) {
    const float4 v = q[u];
    const float dx = ax - v.x, dy = ay - v.y, dz = az - v.z;
    cs += ex2(fmaf(-k, fmaf(dz, dz, fmaf(dy, dy, fmaf(dx, dx, mn))), v.w));
  }
  return make_float3(mn, s * ex2(k * (mk - mn)), cs);
}

// out_p = eps (log_w - logsumexp_q((in_q - |a_p - b_q|^2) / eps)) for every
// point p of cloud a (B, P, 3) against cloud b (B, Q, 3) with potential in
// (B, Q); k = log2(e) / eps. The block's threads are `split` groups of
// kThreads / split (whole warps); group h sums its share of each staged
// tile's chunks for the block's kThreads / split * kOut outputs, thread o of
// a group the outputs o, o + kThreads / split, ...
__global__ void __launch_bounds__(kThreads) sweep_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ in, float* __restrict__ out, int p_n, int q_n,
    float eps, float k, float log_w, int split) {
  __shared__ float4 s_b[kTile];
  __shared__ float2 s_ms[kThreads * kOut];  // the groups' (mk, sum), merged at the end

  const int cloud = blockIdx.y;
  const int lanes = kThreads / split, o = threadIdx.x % lanes, h = threadIdx.x / lanes;
  const int p0 = blockIdx.x * lanes * kOut + o;
  // per output: the point, the reference mk = m / k of its exponents
  // t = k (in_q - d) and the sum of 2^(t - k mk)
  float ax[kOut], ay[kOut], az[kOut], mk[kOut], s[kOut];
#pragma unroll
  for (int r = 0; r < kOut; ++r) {
    const int p = p0 + r * lanes;
    // outputs past P run on point 0 and are not written
    const float* ap = a + (static_cast<int64_t>(cloud) * p_n + (p < p_n ? p : 0)) * 3;
    ax[r] = ap[0];
    ay[r] = ap[1];
    az[r] = ap[2];
    mk[r] = -INFINITY;
    s[r] = 0.f;
  }
  const float* bq = b + static_cast<int64_t>(cloud) * q_n * 3;
  const float* inq = in + static_cast<int64_t>(cloud) * q_n;
  const float nk = -k;

  for (int base = 0; base < q_n; base += kTile) {
    const int cnt = min(kTile, q_n - base);
    const int chunks = (cnt + kChunk - 1) / kChunk;
    __syncthreads();  // the previous tile is no longer read
    for (int j = threadIdx.x; j < chunks * kChunk; j += kThreads) {
      float4 v = make_float4(0.f, 0.f, 0.f, -INFINITY);  // padding adds 2^-inf
      if (j < cnt) {
        const float* r = bq + static_cast<int64_t>(base + j) * 3;
        v = make_float4(r[0], r[1], r[2], inq[base + j] * k);
      }
      s_b[j] = v;
    }
    __syncthreads();
    const int ch_end = (h + 1) * chunks / split;
    for (int ch = h * chunks / split; ch < ch_end; ++ch) {
      const float4* q = s_b + ch * kChunk;
      float cs[kOut];
#pragma unroll
      for (int r = 0; r < kOut; ++r) cs[r] = 0.f;
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const float4 v = q[u];
#pragma unroll
        for (int r = 0; r < kOut; ++r) {
          const float dx = ax[r] - v.x, dy = ay[r] - v.y, dz = az[r] - v.z;
          const float d = fmaf(dz, dz, fmaf(dy, dy, fmaf(dx, dx, mk[r])));
          cs[r] += ex2(fmaf(nk, d, v.w));  // 2^(t - k mk)
        }
      }
      // a chunk past 2^64 (or inf, or NaN from mk = -inf) takes the cold path
      bool fine = true;
#pragma unroll
      for (int r = 0; r < kOut; ++r) fine = fine && cs[r] <= kBig;
      if (__builtin_expect(!fine, 0)) {
#pragma unroll
        for (int r = 0; r < kOut; ++r) {
          if (cs[r] <= kBig) continue;
          const float3 v = rescale_chunk(q, ax[r], ay[r], az[r], mk[r], s[r], k);
          mk[r] = v.x;
          s[r] = v.y;
          cs[r] = v.z;
        }
      }
#pragma unroll
      for (int r = 0; r < kOut; ++r) s[r] += cs[r];
    }
  }
  if (split > 1) {
#pragma unroll
    for (int r = 0; r < kOut; ++r) s_ms[(h * kOut + r) * lanes + o] = make_float2(mk[r], s[r]);
    __syncthreads();
    if (h != 0) return;
#pragma unroll
    for (int r = 0; r < kOut; ++r) {
      float mx = mk[r];
      for (int g = 1; g < split; ++g) mx = fmaxf(mx, s_ms[(g * kOut + r) * lanes + o].x);
      float sum = 0.f;
      for (int g = 0; g < split; ++g) {
        const float2 v = s_ms[(g * kOut + r) * lanes + o];
        sum += v.y * ex2(k * (v.x - mx));
      }
      mk[r] = mx;
      s[r] = sum;
    }
  }
#pragma unroll
  for (int r = 0; r < kOut; ++r) {
    const int p = p0 + r * lanes;
    if (p < p_n)
      out[static_cast<int64_t>(cloud) * p_n + p] = eps * (log_w - kLn2 * (k * mk[r] + log2f(s[r])));
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
// floats. split_x / split_y (1, 2, 4 or 8): the q split of the sweeps over
// x's and over y's points (ops/sinkhorn.py sinkhorn_plan). Enqueues
// 2 iters + 1 kernels on `stream`; returns the first CUDA error of a launch
// (0 on success). The caller checked the bounds.
extern "C" int sinkhorn_launch(const float* x, const float* y, float* f,
                               float* g, float* dists, int* assign,
                               const float* eps_schedule, int iters, int b,
                               int n, int m, int split_x, int split_y, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (const int sp : {split_x, split_y})
    if (sp != 1 && sp != 2 && sp != 4 && sp != 8) return static_cast<int>(cudaErrorInvalidValue);
  const auto blocks = [](int p, int sp) {
    const int per = kThreads / sp * kOut;
    return (p + per - 1) / per;
  };
  const dim3 grid_x(blocks(n, split_x), b);
  const dim3 grid_y(blocks(m, split_y), b);
  const float log_mu = static_cast<float>(-log(static_cast<double>(n)));
  const float log_nu = static_cast<float>(-log(static_cast<double>(m)));
  for (int t = 0; t < iters; ++t) {
    const float eps = eps_schedule[t];
    const float k = static_cast<float>(kLog2e / static_cast<double>(eps));
    sweep_kernel<<<grid_y, kThreads, 0, s>>>(y, x, f, g, m, n, eps, k, log_nu, split_y);
    sweep_kernel<<<grid_x, kThreads, 0, s>>>(x, y, g, f, n, m, eps, k, log_mu, split_x);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid_a((n + kThreads - 1) / kThreads, b);
  assign_kernel<<<grid_a, kThreads, 0, s>>>(x, y, f, g, dists, assign, n, m);
  return static_cast<int>(cudaGetLastError());
}
