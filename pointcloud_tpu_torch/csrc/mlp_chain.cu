// The fused Dense -> BatchNorm -> ReLU chain with a group max-pool, forward
// and backward, for sm_90a: the PointNet++ set-abstraction body (plain
// chain, masked pool) and PointMLP's PreExtraction (residual chain).
//
// Replaces the four Pallas kernels of pointcloud_tpu/ops/preextract_fused.py
// in both of their modes (mlp_pool_fused and preextract_pool_fused):
//   _mm_stats_kernel        -> mm_stats_kernel<T, false, kResNone>
//   _bnact_mm_stats_kernel  -> mm_stats_kernel<T, true, RES> (+ write_r)
//   _bn_respool_kernel      -> bn_pool_kernel<T, RES>
//   _bwd_pass_kernel        -> bwd_da_kernel + bwd_dw_kernel (one pass;
//                              res_mode, skip_pool, skip_dense)
//
// With rows = B * R flattened rows, T the activation type (fp32 or bf16) and
// every statistic, scalar and sum in fp32:
//   forward, layer 0:  h0 = T(x @ w0); column sums of h0 and h0^2 over all
//            rows (masked rows too);
//   forward, layer u:  a = T(max(pre, 0)) with pre = (h_{u-1} - mean) * mul
//            + beta [+ res], h_u = T(a @ w_u), its column sums. `a` lives in
//            shared memory only (a layer reads one tensor and writes one),
//            unless r_out asks for it: PointMLP stores a block's output there
//            as a later layer's residual;
//   the residual `res` (PointMLP): relu(BN0(h0)) from h0 and its scalars
//            (RES_BNRELU) or a stored block output r (RES_DENSE), at the
//            same row and channel;
//   pool:    v = pre_last [+ res] [- pen[row]]; per group of `pool`
//            consecutive rows the max of v with the lowest row winning ties,
//            that row, and h_last there; out = max(v, 0) (or v when
//            final_relu is 0), and with pen -1e9 where the max is below -5e8
//            (no valid row). The residual chain has no pen;
//   backward pass of layer u: dh = T(c1 dz_u - c4 - c3 (h_u - mu)) where dz_u
//            is a dense tensor or, at the pooled layer, `dosel` at row `amax`
//            of each group and 0 elsewhere; da = dh @ w_u^T;
//            dw_u = in^T @ dh with in = a_u (recomputed from h_{u-1} with its
//            residual) or x;
//            below a BatchNorm: da += the skip shares of a block's input (the
//            pooled cotangent's `dosel` at its rows, skip_pool; a stored dz,
//            skip_dense), in that order; dz_{u-1} = T(da 1[pre_{u-1} > 0])
//            with pre_{u-1} including its residual, and the column sums
//            Sd = sum dz_{u-1}, Se = sum dz_{u-1} zhat_{u-1} of the rounded
//            values; at the input layer dx = T(da).
// pre is formed with separately rounded operations (__fsub_rn, __fmul_rn,
// __fadd_rn, then __fadd_rn of the residual), da's shares with __fadd_rn, dh
// too, so that they equal the plain PyTorch version's bits and the ReLU masks
// and bf16 roundings of the two agree.
//
// Design. The TPU kernels walk the batch in a sequential grid and carry the
// sums and dw in VMEM from step to step; CUDA blocks run in parallel with no
// carry. Every product runs on the 64 x 128 tiles of tile_mma.cuh (bf16:
// wmma tensor-core tiles with fp32 accumulators; fp32: CUDA cores), staged
// through shared memory in depth chunks of 32 with zero padding, so a depth
// of 6, 131 or 259 and ragged widths need no special path; PointMLP-Elite's
// mid widths of 16, 32 and 64 fill part of a tile. The prologue (BatchNorm +
// residual + ReLU, or the dh formula) is applied while an operand tile is
// staged, the epilogue (rounding, statistics, skip shares, the ReLU mask)
// while the accumulator tile sits in shared memory. A thread stages one
// channel of a tile and keeps that channel's scalars (and the residual's) in
// registers. The kernels are bound by memory latency (scalar loads, two
// barriers a chunk), so resident blocks count: mm_stats and bwd_da are held
// to 80 registers (three blocks an SM), bwd_dw with its two accumulators to
// 128 (two). Measured on an H100: one block more each spills and is slower,
// and so is a 128-deep chunk, whose shared memory halves the resident blocks.
//   mm_stats: a block owns 128 output channels and a chunk of rows; per
//            64-row tile it forms the product, rounds, stores h and adds to
//            per-thread column sums; per-chunk partials, then colsum_kernel
//            sums them in a fixed order (32 strided lanes per column, then
//            the 32 lanes in order). With r_out the blocks of the first
//            column tile store `a` as they stage it (every column tile stages
//            the same values).
//   bn_pool: no product. One thread per (group, channel) walks its group's
//            rows in order with a strict >, so the lowest row wins ties and
//            no merge between blocks is needed.
//   backward pass: two products with different reduction dimensions, so two
//            launches. bwd_da: a block owns a chunk of rows and 128 input
//            channels and reduces over the output channels; it writes
//            dz_{u-1} (or dx) and per-chunk partials of Sd and Se. bwd_dw: a
//            block owns a 128 x 128 tile of dw and a chunk of rows and
//            reduces over the rows; per-chunk partials, summed by
//            colsum_kernel. dh is recomputed in both (one read of h_u).
//            K = 24 rows a group do not divide the 64-row tile, so a group
//            straddles tiles and chunks: the sparse cotangent and the pooled
//            skip share test each row's own `row % pool` against amax.
// Switches. The residual mode RES is a template argument: it adds loads to
// the staging loop of mm_stats and bwd_dw and to bwd_da's epilogue. r_out,
// pen, skip_pool and skip_dense are run-time pointers (NULL when absent):
// each adds one uniform branch and one access per element outside the
// product's inner loop, and as templates they would multiply the
// instantiations (T x RES x write_r x skip_pool x skip_dense). The chain
// never puts a residual below its sparse top layer or the input layer, so
// bwd_pass instantiates RES only with a dense dz and a BatchNorm below.
// No fp32 atomics anywhere: the same inputs give the same bits on every run.
//
// Bound on the card: bytes. At the set-abstraction shapes (4.2M rows of
// 64..128 channels, 2.1M of 128..256) and PointMLP's (786K rows of 128
// channels at its first stage) a layer's product is 2 rows Cd Cu operations,
// a few tenths of a millisecond at 989 TFLOP/s dense bf16, while reading and
// writing the (rows, C) tensors once takes 0.1 to 0.5 ms at 3.35 TB/s; a
// residual adds one more (rows, C) read. This design stages with scalar
// loads and re-reads an input once per 128-channel output tile; vector
// loads, a resident w, cp.async / TMA pipelines and wgmma are left to a
// later change.

#include "tile_mma.cuh"

namespace {

using namespace tile;

constexpr int kARows = 128;  // A-tile rows: two 64-row halves in bwd_dw
static_assert(kARows == TN && kThreads == 2 * TN, "bwd_dw's staging map");

// residual modes (pointcloud_tpu/ops/preextract_fused.py RES_*)
constexpr int kResNone = 0, kResBnRelu = 1, kResDense = 2;

// Shared memory: A (AROWS x KC) and B (KC x TN) operand tiles in T and one
// TM x TN fp32 tile for epilogues; AROWS is TM in mm_stats and bwd_da, kARows
// in bwd_dw. Leading dimensions are multiples of 8 (bf16) or 4 (fp32)
// elements, as wmma requires.
template <typename T, int AROWS>
struct Lds {
  static constexpr int A = KC + Ty<T>::kPad;
  static constexpr int B = TN + Ty<T>::kPad;
  static constexpr int Z = TN + 4;
  static constexpr int bytes_a = AROWS * A * sizeof(T);
  static constexpr int bytes_b = KC * B * sizeof(T);
  static constexpr int bytes_z = TM * Z * 4;
  static constexpr int total = bytes_a + bytes_b + bytes_z;
};

template <typename T, int AROWS>
struct Smem {
  using L = Lds<T, AROWS>;
  T* a;
  T* b;
  float* z;
  __device__ explicit Smem(unsigned char* base) {
    a = reinterpret_cast<T*>(base);
    b = reinterpret_cast<T*>(base + L::bytes_a);
    z = reinterpret_cast<float*>(base + L::bytes_a + L::bytes_b);
  }
};

// (h - mean) * mul + beta, each operation rounded on its own (no FMA)
__device__ __forceinline__ float bn_pre(float h, float mean, float mul,
                                        float beta) {
  return __fadd_rn(__fmul_rn(__fsub_rn(h, mean), mul), beta);
}

// A channel's scalars, loaded once per thread and staged chunk: sc rows
// mean, mul, beta (a BatchNorm); uc rows c1, c4, c3, mu (a backward pass).
struct Sc3 {
  float mean, mul, beta;
  __device__ __forceinline__ Sc3(const float* __restrict__ sc, int ch, int width,
                                 bool ok) {
    mean = ok ? sc[ch] : 0.f;
    mul = ok ? sc[width + ch] : 0.f;
    beta = ok ? sc[2 * width + ch] : 0.f;
  }
};
struct Uc4 {
  float c1, c4, c3, mu;
  __device__ __forceinline__ Uc4(const float* __restrict__ uc, int c, int width,
                                 bool ok) {
    c1 = ok ? uc[c] : 0.f;
    c4 = ok ? uc[width + c] : 0.f;
    c3 = ok ? uc[2 * width + c] : 0.f;
    mu = ok ? uc[3 * width + c] : 0.f;
  }
};

// The residual of one channel, added to a pre-activation at element i of a
// tensor of the same width: RES_BNRELU reads h0 (src) and applies
// relu(BN0(.)) with its scalars sc; RES_DENSE reads the stored r (src).
template <typename T, int RES>
struct Residual {
  const T* __restrict__ src;
  Sc3 s;
  __device__ __forceinline__ Residual(const T* src_, const float* sc, int ch,
                                      int width, bool ok)
      : src(src_), s(sc, ch, width, RES == kResBnRelu && ok) {}
  __device__ __forceinline__ float add(float pre, int64_t i) const {
    if constexpr (RES == kResBnRelu) {
      const float r = bn_pre(Ty<T>::to_f(src[i]), s.mean, s.mul, s.beta);
      return __fadd_rn(pre, fmaxf(r, 0.f));
    } else if constexpr (RES == kResDense) {
      return __fadd_rn(pre, Ty<T>::to_f(src[i]));
    } else {
      return pre;
    }
  }
};

// The layer input from the stored tensor `in` at element i: T(max(pre, 0))
// with pre = BN(in) + residual below a BatchNorm, else in[i] itself.
template <typename T, bool BN, int RES>
__device__ __forceinline__ T act(const T* __restrict__ in, int64_t i,
                                 const Sc3& s, const Residual<T, RES>& res) {
  if constexpr (BN) {
    const float pre = res.add(bn_pre(Ty<T>::to_f(in[i]), s.mean, s.mul, s.beta), i);
    return Ty<T>::from_f(fmaxf(pre, 0.f));
  } else {
    return in[i];
  }
}

// The pooled cotangent at (row, c) of a tensor of width `width`: dosel[group,
// c] at row amax[group, c] of its group of `pool` rows, else 0 (rows < 2^31:
// 32-bit division). A group may straddle tiles: each row tests its own
// position in its group.
__device__ __forceinline__ float pooled_at(const float* __restrict__ dosel,
                                           const int* __restrict__ amax,
                                           int64_t row, int c, int width,
                                           int pool) {
  const int g = static_cast<int>(row) / pool;
  const int within = static_cast<int>(row) - g * pool;
  const int64_t ge = static_cast<int64_t>(g) * width + c;
  return (amax[ge] == within) ? dosel[ge] : 0.f;
}

// dh[row, c] = T(c1 dz - c4 - c3 (h_u - mu)). SPARSE: dz is the pooled
// cotangent (pooled_at), else the dense dz.
template <typename T, bool SPARSE>
__device__ __forceinline__ T dh_at(const T* __restrict__ hu,
                                   const T* __restrict__ dz,
                                   const float* __restrict__ dosel,
                                   const int* __restrict__ amax, const Uc4& u,
                                   int64_t row, int c, int cu, int pool) {
  float d;
  if constexpr (SPARSE) {
    d = pooled_at(dosel, amax, row, c, cu, pool);
  } else {
    d = Ty<T>::to_f(dz[row * cu + c]);
  }
  const float hv = Ty<T>::to_f(hu[row * cu + c]);
  const float v = __fsub_rn(__fsub_rn(__fmul_rn(u.c1, d), u.c4),
                            __fmul_rn(u.c3, __fsub_rn(hv, u.mu)));
  return Ty<T>::from_f(v);
}

// Adds the second half's two per-thread column sums to the first half's and
// writes them as this chunk's partials: part[chunk, 0, :] and part[chunk, 1, :].
__device__ __forceinline__ void write_partials(float* z, float* __restrict__ part,
                                               int chunk, int width, int c,
                                               bool col_ok, float s0, float s1) {
  const int col = threadIdx.x % TN;
  const int half = threadIdx.x / TN;
  if (half == 1) {
    z[col] = s0;
    z[TN + col] = s1;
  }
  __syncthreads();
  if (half == 0 && col_ok) {
    float* p = part + static_cast<int64_t>(chunk) * 2 * width;
    p[c] = s0 + z[col];
    p[width + c] = s1 + z[TN + col];
  }
}

// ---------------- forward ----------------

// h_out = T(act(a_in) @ w) for a_in (rows, cd), w (cd, cu); per-chunk column
// sums of h_out and h_out^2 into part (n_chunks, 2, cu); with r_out, the
// staged act(a_in) (rows, cd) too.
template <typename T, bool BN, int RES>
__global__ void __launch_bounds__(kThreads, 3) mm_stats_kernel(
    const T* __restrict__ a_in, const float* __restrict__ sc,
    const T* __restrict__ res_src, const float* __restrict__ res_sc,
    const T* __restrict__ w, T* __restrict__ h_out, T* __restrict__ r_out,
    float* __restrict__ part, int64_t rows, int cd, int cu, int chunk_rows) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  using L = Lds<T, TM>;
  const Smem<T, TM> sm(smem_raw);
  const T zero = Ty<T>::from_f(0.f);
  const int c0 = blockIdx.x * TN;
  const int64_t r_begin = static_cast<int64_t>(blockIdx.y) * chunk_rows;
  const int64_t r_end = rows < r_begin + chunk_rows ? rows : r_begin + chunk_rows;
  const int col = threadIdx.x % TN;
  const int half = threadIdx.x / TN;  // rows [32 half, 32 half + 32) of a tile
  const int c = c0 + col;
  const bool col_ok = c < cu;
  T* const r_dst = blockIdx.x == 0 ? r_out : nullptr;  // one column tile stores a

  float sum = 0.f, sq = 0.f;
  for (int64_t r0 = r_begin; r0 < r_end; r0 += TM) {
    Mma<T> mma;
    mma.zero();
    for (int k0 = 0; k0 < cd; k0 += KC) {
      {  // a thread stages one depth column k of the chunk, 8 rows of it
        const int k = threadIdx.x % KC, kk = k0 + k;
        const bool k_ok = kk < cd;
        const Sc3 s3(sc, kk, cd, BN && k_ok);
        const Residual<T, RES> res(res_src, res_sc, kk, cd, k_ok);
        for (int r = threadIdx.x / KC; r < TM; r += kThreads / KC) {
          const int64_t row = r0 + r;
          T v = zero;
          if (row < r_end && k_ok) {
            const int64_t i = row * cd + kk;
            v = act<T, BN, RES>(a_in, i, s3, res);
            if (r_dst != nullptr) r_dst[i] = v;
          }
          sm.a[r * L::A + k] = v;
        }
      }
      for (int e = threadIdx.x; e < KC * TN; e += kThreads) {
        const int k = e / TN, j = e % TN;
        sm.b[k * L::B + j] =
            (k0 + k < cd && c0 + j < cu)
                ? w[static_cast<int64_t>(k0 + k) * cu + c0 + j]
                : zero;
      }
      __syncthreads();
      mma.run(sm.a, L::A, sm.b, L::B, KC);
      __syncthreads();
    }
    mma.store(sm.z, L::Z);
    __syncthreads();
    if (col_ok) {
      for (int i = 0; i < TM / 2; ++i) {
        const int rr = half * (TM / 2) + i;
        const int64_t row = r0 + rr;
        if (row >= r_end) break;
        const T hv = Ty<T>::from_f(sm.z[rr * L::Z + col]);
        h_out[row * cu + c] = hv;
        const float f = Ty<T>::to_f(hv);
        sum += f;
        sq += f * f;
      }
    }
    __syncthreads();  // sm.z is rewritten by the next tile
  }
  write_partials(sm.z, part, blockIdx.y, cu, c, col_ok, sum, sq);
}

// One thread per (group, channel): v = pre [+ res] [- pen] over the group's
// rows in order; strict > keeps the lowest row on ties.
template <typename T, int RES>
__global__ void __launch_bounds__(kThreads) bn_pool_kernel(
    const T* __restrict__ h, const float* __restrict__ sc,
    const T* __restrict__ res_src, const float* __restrict__ res_sc,
    const float* __restrict__ pen, T* __restrict__ out, float* __restrict__ maxv,
    int* __restrict__ amax, float* __restrict__ hsel, int64_t groups, int C,
    int pool, int final_relu) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= groups * C) return;
  const int64_t g = e / C;
  const int c = static_cast<int>(e - g * C);
  const float mean = sc[c], mul = sc[C + c], beta = sc[2 * C + c];
  const Residual<T, RES> res(res_src, res_sc, c, C, true);
  const int64_t row0 = g * pool;
  float best = 0.f, best_h = 0.f;
  int best_i = 0;
  for (int i = 0; i < pool; ++i) {
    const int64_t idx = (row0 + i) * C + c;
    const float hv = Ty<T>::to_f(h[idx]);
    float v = res.add(bn_pre(hv, mean, mul, beta), idx);
    if (pen != nullptr) v = __fsub_rn(v, pen[row0 + i]);
    if (i == 0 || v > best) {
      best = v;
      best_i = i;
      best_h = hv;
    }
  }
  float o = final_relu ? fmaxf(best, 0.f) : best;
  if (pen != nullptr && best < -5e8f) o = -1e9f;  // no valid row in the group
  out[e] = Ty<T>::from_f(o);
  maxv[e] = best;
  amax[e] = best_i;
  hsel[e] = best_h;
}

// out[j] = sum_i part[i, j], i = 0 .. n-1: lane ty of 32 adds rows ty, ty+32,
// .. in order, then the 32 lanes are added in order. 1024 threads a block.
__global__ void __launch_bounds__(1024) colsum_kernel(
    const float* __restrict__ part, float* __restrict__ out, int n,
    int64_t cols) {
  __shared__ float s[32][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int64_t j = static_cast<int64_t>(blockIdx.x) * 32 + tx;
  float acc = 0.f;
  if (j < cols) {
    for (int i = ty; i < n; i += 32) acc += part[static_cast<int64_t>(i) * cols + j];
  }
  s[ty][tx] = acc;
  __syncthreads();
  if (ty == 0 && j < cols) {
    float t = 0.f;
    for (int k = 0; k < 32; ++k) t += s[k][tx];
    out[j] = t;
  }
}

// ---------------- backward ----------------

// da = dh @ w^T for a chunk of rows and 128 input channels i0..; then
// DOWN_BN: da += the skip shares (skip_dosel at row skip_amax of each group,
//          then skip_dz; either may be NULL), dzd = T(da 1[pre > 0]) with
//          pre from hd = h_{u-1} (scd rows: mean, mul, beta, rsig) and its
//          residual, and the chunk's partials of Sd and Se;
// else:    dzd = T(da), the gradient of the chain's input.
template <typename T, bool SPARSE, bool DOWN_BN, int RES>
__global__ void __launch_bounds__(kThreads, 3) bwd_da_kernel(
    const T* __restrict__ hu, const T* __restrict__ dz,
    const float* __restrict__ dosel, const int* __restrict__ amax,
    const float* __restrict__ uc, const T* __restrict__ w,
    const T* __restrict__ hd, const float* __restrict__ scd,
    const T* __restrict__ res_src, const float* __restrict__ res_sc,
    const float* __restrict__ skip_dosel, const int* __restrict__ skip_amax,
    const T* __restrict__ skip_dz, T* __restrict__ dzd, float* __restrict__ part,
    int64_t rows, int cd, int cu, int pool, int chunk_rows) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  using L = Lds<T, TM>;
  const Smem<T, TM> sm(smem_raw);
  const T zero = Ty<T>::from_f(0.f);
  const int i0 = blockIdx.x * TN;
  const int64_t r_begin = static_cast<int64_t>(blockIdx.y) * chunk_rows;
  const int64_t r_end = rows < r_begin + chunk_rows ? rows : r_begin + chunk_rows;
  const int col = threadIdx.x % TN;
  const int half = threadIdx.x / TN;
  const int ch = i0 + col;
  const bool col_ok = ch < cd;
  float mean = 0.f, mul = 0.f, beta = 0.f, rsig = 0.f;
  if (DOWN_BN && col_ok) {
    mean = scd[ch];
    mul = scd[cd + ch];
    beta = scd[2 * cd + ch];
    rsig = scd[3 * cd + ch];
  }
  const Residual<T, RES> res(res_src, res_sc, ch, cd, col_ok);

  float sd = 0.f, se = 0.f;
  for (int64_t r0 = r_begin; r0 < r_end; r0 += TM) {
    Mma<T> mma;
    mma.zero();
    for (int k0 = 0; k0 < cu; k0 += KC) {
      {  // dh chunk: a thread stages one channel k of it, 8 rows
        const int k = threadIdx.x % KC, kk = k0 + k;
        const bool k_ok = kk < cu;
        const Uc4 u4(uc, kk, cu, k_ok);
        for (int r = threadIdx.x / KC; r < TM; r += kThreads / KC) {
          const int64_t row = r0 + r;
          sm.a[r * L::A + k] =
              (row < r_end && k_ok)
                  ? dh_at<T, SPARSE>(hu, dz, dosel, amax, u4, row, kk, cu, pool)
                  : zero;
        }
      }
      for (int e = threadIdx.x; e < KC * TN; e += kThreads) {  // w^T chunk
        const int i = e / KC, k = e % KC;
        sm.b[k * L::B + i] =
            (i0 + i < cd && k0 + k < cu)
                ? w[static_cast<int64_t>(i0 + i) * cu + k0 + k]
                : zero;
      }
      __syncthreads();
      mma.run(sm.a, L::A, sm.b, L::B, KC);
      __syncthreads();
    }
    mma.store(sm.z, L::Z);
    __syncthreads();
    if (col_ok) {
      for (int i = 0; i < TM / 2; ++i) {
        const int rr = half * (TM / 2) + i;
        const int64_t row = r0 + rr;
        if (row >= r_end) break;
        float da = sm.z[rr * L::Z + col];
        if constexpr (DOWN_BN) {
          const int64_t at = row * cd + ch;
          const float hv = Ty<T>::to_f(hd[at]);
          const float pre = res.add(bn_pre(hv, mean, mul, beta), at);
          if (skip_dosel != nullptr) {
            da = __fadd_rn(da, pooled_at(skip_dosel, skip_amax, row, ch, cd, pool));
          }
          if (skip_dz != nullptr) da = __fadd_rn(da, Ty<T>::to_f(skip_dz[at]));
          const T dv = Ty<T>::from_f(pre > 0.f ? da : 0.f);
          dzd[at] = dv;
          const float f = Ty<T>::to_f(dv);
          sd += f;
          se += f * ((hv - mean) * rsig);
        } else {
          dzd[row * cd + ch] = Ty<T>::from_f(da);
        }
      }
    }
    __syncthreads();
  }
  if constexpr (DOWN_BN) {
    write_partials(sm.z, part, blockIdx.y, cd, ch, col_ok, sd, se);
  }
}

// dw partial of a chunk of rows: in^T @ dh for input channels i0 .. i0+127
// and output channels c0 .. c0+127, in = act(ain) with its residual
// (DOWN_BN: ain = h_{u-1}) or ain itself (the chain's input).
template <typename T, bool SPARSE, bool DOWN_BN, int RES>
__global__ void __launch_bounds__(kThreads, 2) bwd_dw_kernel(
    const T* __restrict__ hu, const T* __restrict__ dz,
    const float* __restrict__ dosel, const int* __restrict__ amax,
    const float* __restrict__ uc, const T* __restrict__ ain,
    const float* __restrict__ scd, const T* __restrict__ res_src,
    const float* __restrict__ res_sc, float* __restrict__ dw_part, int64_t rows,
    int cd, int cu, int pool, int chunk_rows) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  using L = Lds<T, kARows>;
  const Smem<T, kARows> sm(smem_raw);
  const T zero = Ty<T>::from_f(0.f);
  const int c0 = blockIdx.x * TN;
  const int i0 = blockIdx.y * kARows;
  const int64_t r_begin = static_cast<int64_t>(blockIdx.z) * chunk_rows;
  const int64_t r_end = rows < r_begin + chunk_rows ? rows : r_begin + chunk_rows;
  Mma<T> acc_lo, acc_hi;  // input channels i0 .. i0+63 and i0+64 .. i0+127
  acc_lo.zero();
  acc_hi.zero();
  // kARows == TN == kThreads / 2: a thread stages one input channel and one
  // output channel for the whole kernel, every second row of a chunk
  const int lane = threadIdx.x % TN, r_first = threadIdx.x / TN;
  const int ci = i0 + lane, cj = c0 + lane;
  const bool i_ok = ci < cd, j_ok = cj < cu;
  const Sc3 s3(scd, ci, cd, DOWN_BN && i_ok);
  const Residual<T, RES> res(res_src, res_sc, ci, cd, i_ok);
  const Uc4 u4(uc, cj, cu, j_ok);
  for (int64_t r0 = r_begin; r0 < r_end; r0 += KC) {
    for (int r = r_first; r < KC; r += kThreads / TN) {
      const int64_t row = r0 + r;
      const bool row_ok = row < r_end;
      sm.a[lane * L::A + r] =  // in^T chunk
          (row_ok && i_ok) ? act<T, DOWN_BN, RES>(ain, row * cd + ci, s3, res) : zero;
      sm.b[r * L::B + lane] =  // dh chunk
          (row_ok && j_ok)
              ? dh_at<T, SPARSE>(hu, dz, dosel, amax, u4, row, cj, cu, pool)
              : zero;
    }
    __syncthreads();
    acc_lo.run(sm.a, L::A, sm.b, L::B, KC);
    acc_hi.run(sm.a + TM * L::A, L::A, sm.b, L::B, KC);
    __syncthreads();
  }
  float* out = dw_part + static_cast<int64_t>(blockIdx.z) * cd * cu;
  for (int h = 0; h < 2; ++h) {
    if (h == 0) {
      acc_lo.store(sm.z, L::Z);
    } else {
      acc_hi.store(sm.z, L::Z);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < TM * TN; e += kThreads) {
      const int r = e / TN, j = e % TN;
      const int i = i0 + h * TM + r;
      if (i < cd && c0 + j < cu) {
        out[static_cast<int64_t>(i) * cu + c0 + j] = sm.z[r * L::Z + j];
      }
    }
    __syncthreads();
  }
}

// ---------------- launches ----------------

constexpr int kBadArgs = static_cast<int>(cudaErrorInvalidValue);

template <typename L>
cudaError_t set_smem(const void* kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              L::total);
}

int colsum(const float* part, float* out, int n, int64_t cols, cudaStream_t s) {
  colsum_kernel<<<static_cast<unsigned>((cols + 31) / 32), 1024, 0, s>>>(
      part, out, n, cols);
  return static_cast<int>(cudaGetLastError());
}

int chunks_of(int64_t rows, int chunk_rows) {
  return static_cast<int>((rows + chunk_rows - 1) / chunk_rows);
}

template <typename T, bool BN, int RES>
int mm_stats(const T* a_in, const float* sc, const T* res_src,
             const float* res_sc, const T* w, T* h_out, T* r_out, float* stats,
             float* part, int64_t rows, int cd, int cu, int chunk_rows,
             cudaStream_t s) {
  const int n_chunks = chunks_of(rows, chunk_rows);
  using L = Lds<T, TM>;
  cudaError_t err =
      set_smem<L>(reinterpret_cast<const void*>(&mm_stats_kernel<T, BN, RES>));
  if (err != cudaSuccess) return static_cast<int>(err);
  mm_stats_kernel<T, BN, RES><<<dim3((cu + TN - 1) / TN, n_chunks), kThreads,
                                L::total, s>>>(a_in, sc, res_src, res_sc, w, h_out,
                                               r_out, part, rows, cd, cu, chunk_rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  return colsum(part, stats, n_chunks, 2 * static_cast<int64_t>(cu), s);
}

template <typename T>
int mm_stats_any(const void* a_in, const float* sc, int res_mode,
                 const void* res_src, const float* res_sc, const void* w,
                 void* h_out, void* r_out, float* stats, float* part,
                 int64_t rows, int cd, int cu, int chunk_rows, cudaStream_t s) {
  const T* a = static_cast<const T*>(a_in);
  const T* rs = static_cast<const T*>(res_src);
  const T* wt = static_cast<const T*>(w);
  T* h = static_cast<T*>(h_out);
  T* r = static_cast<T*>(r_out);
#define MLP_CHAIN_MM(BN, RES) \
  return mm_stats<T, BN, RES>(a, sc, rs, res_sc, wt, h, r, stats, part, rows, \
                              cd, cu, chunk_rows, s)
  if (sc == nullptr) {  // layer 0: the chain's input as it is
    if (res_mode != kResNone || r_out != nullptr) return kBadArgs;
    MLP_CHAIN_MM(false, kResNone);
  }
  if (res_mode == kResNone) MLP_CHAIN_MM(true, kResNone);
  if (res_mode == kResBnRelu) MLP_CHAIN_MM(true, kResBnRelu);
  if (res_mode == kResDense) MLP_CHAIN_MM(true, kResDense);
#undef MLP_CHAIN_MM
  return kBadArgs;
}

template <typename T, int RES>
int bn_pool(const T* h, const float* sc, const T* res_src, const float* res_sc,
            const float* pen, T* out, float* maxv, int* amax, float* hsel,
            int64_t groups, int C, int pool, int final_relu, cudaStream_t s) {
  const int64_t n = groups * C;
  bn_pool_kernel<T, RES><<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                           kThreads, 0, s>>>(h, sc, res_src, res_sc, pen, out,
                                             maxv, amax, hsel, groups, C, pool,
                                             final_relu);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bn_pool_any(const void* h, const float* sc, int res_mode, const void* res_src,
                const float* res_sc, const float* pen, void* out, float* maxv,
                int* amax, float* hsel, int64_t groups, int C, int pool,
                int final_relu, cudaStream_t s) {
  const T* ht = static_cast<const T*>(h);
  const T* rs = static_cast<const T*>(res_src);
  T* o = static_cast<T*>(out);
#define MLP_CHAIN_POOL(RES) \
  return bn_pool<T, RES>(ht, sc, rs, res_sc, pen, o, maxv, amax, hsel, groups, \
                         C, pool, final_relu, s)
  if (res_mode == kResNone) MLP_CHAIN_POOL(kResNone);
  if (res_mode == kResBnRelu) MLP_CHAIN_POOL(kResBnRelu);
  if (res_mode == kResDense) MLP_CHAIN_POOL(kResDense);
#undef MLP_CHAIN_POOL
  return kBadArgs;
}

// Pointers of one backward pass, typed.
template <typename T>
struct BwdArgs {
  const T* hu;
  const T* dz;
  const float* dosel;
  const int* amax;
  const float* uc;
  const T* w;
  const T* ain;
  const float* scd;
  const T* res_src;
  const float* res_sc;
  const float* skip_dosel;
  const int* skip_amax;
  const T* skip_dz;
  T* dzd;
  float* sdse;
  float* dw;
  float* part;
  float* dw_part;
};

template <typename T, bool SPARSE, bool DOWN_BN, int RES>
int bwd_pass(const BwdArgs<T>& a, int64_t rows, int cd, int cu, int pool,
             int chunk_rows, int dw_chunk_rows, cudaStream_t s) {
  cudaError_t err;
  if (a.dzd != nullptr) {
    const int n_chunks = chunks_of(rows, chunk_rows);
    using L = Lds<T, TM>;
    err = set_smem<L>(
        reinterpret_cast<const void*>(&bwd_da_kernel<T, SPARSE, DOWN_BN, RES>));
    if (err != cudaSuccess) return static_cast<int>(err);
    bwd_da_kernel<T, SPARSE, DOWN_BN, RES>
        <<<dim3((cd + TN - 1) / TN, n_chunks), kThreads, L::total, s>>>(
            a.hu, a.dz, a.dosel, a.amax, a.uc, a.w, a.ain, a.scd, a.res_src,
            a.res_sc, a.skip_dosel, a.skip_amax, a.skip_dz, a.dzd, a.part, rows,
            cd, cu, pool, chunk_rows);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    if (DOWN_BN) {
      const int rc = colsum(a.part, a.sdse, n_chunks, 2 * static_cast<int64_t>(cd), s);
      if (rc != 0) return rc;
    }
  }
  const int dw_chunks = chunks_of(rows, dw_chunk_rows);
  using L = Lds<T, kARows>;
  err = set_smem<L>(
      reinterpret_cast<const void*>(&bwd_dw_kernel<T, SPARSE, DOWN_BN, RES>));
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dw_kernel<T, SPARSE, DOWN_BN, RES>
      <<<dim3((cu + TN - 1) / TN, (cd + kARows - 1) / kARows, dw_chunks),
         kThreads, L::total, s>>>(a.hu, a.dz, a.dosel, a.amax, a.uc, a.ain,
                                  a.scd, a.res_src, a.res_sc, a.dw_part, rows,
                                  cd, cu, pool, dw_chunk_rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  return colsum(a.dw_part, a.dw, dw_chunks, static_cast<int64_t>(cd) * cu, s);
}

template <typename T>
int bwd_pass_any(const BwdArgs<T>& a, int res_mode, int64_t rows, int cd,
                 int cu, int pool, int chunk_rows, int dw_chunk_rows,
                 cudaStream_t s) {
  const bool sparse = a.dz == nullptr, down_bn = a.scd != nullptr;
  const bool skips = a.skip_dosel != nullptr || a.skip_dz != nullptr;
  if ((res_mode != kResNone || skips) && (sparse || !down_bn)) return kBadArgs;
#define MLP_CHAIN_PASS(S, D, R) \
  return bwd_pass<T, S, D, R>(a, rows, cd, cu, pool, chunk_rows, dw_chunk_rows, s)
  if (sparse && down_bn) MLP_CHAIN_PASS(true, true, kResNone);
  if (sparse) MLP_CHAIN_PASS(true, false, kResNone);
  if (!down_bn) MLP_CHAIN_PASS(false, false, kResNone);
  if (res_mode == kResNone) MLP_CHAIN_PASS(false, true, kResNone);
  if (res_mode == kResBnRelu) MLP_CHAIN_PASS(false, true, kResBnRelu);
  if (res_mode == kResDense) MLP_CHAIN_PASS(false, true, kResDense);
#undef MLP_CHAIN_PASS
  return kBadArgs;
}

template <typename T>
BwdArgs<T> bwd_args(const void* hu, const void* dz, const float* dosel,
                    const int* amax, const float* uc, const void* w,
                    const void* ain, const float* scd, const void* res_src,
                    const float* res_sc, const float* skip_dosel,
                    const int* skip_amax, const void* skip_dz, void* dzd,
                    float* sdse, float* dw, float* part, float* dw_part) {
  return {static_cast<const T*>(hu), static_cast<const T*>(dz), dosel, amax, uc,
          static_cast<const T*>(w), static_cast<const T*>(ain), scd,
          static_cast<const T*>(res_src), res_sc, skip_dosel, skip_amax,
          static_cast<const T*>(skip_dz), static_cast<T*>(dzd), sdse, dw, part,
          dw_part};
}

}  // namespace

// Plain C entry points for ctypes. Device pointers of contiguous tensors;
// is_bf16 picks T (bf16 when 1, fp32 when 0). res_mode is 0 (no residual),
// 1 (RES_BNRELU: res_src = h0 (rows, C) with res_sc (>= 3, C) fp32 rows mean,
// mul, beta) or 2 (RES_DENSE: res_src = r (rows, C), res_sc NULL), C being
// the width of the pre-activation it joins. Each returns the CUDA error of
// its launches (0 on success; cudaErrorInvalidValue for a combination the
// chain never takes); the caller checked shapes and bounds.

// h_out (rows, cu) = T(act(a_in) @ w) and stats (2, cu) = column sums of
// h_out and h_out^2. sc (>= 3, cd) fp32 rows mean, mul, beta selects the
// BatchNorm + residual + ReLU prologue; sc == NULL takes a_in as it is (no
// residual, no r_out). r_out (rows, cd), or NULL: the staged act(a_in).
// Scratch: part (ceil(rows / chunk_rows), 2, cu) fp32; chunk_rows is a
// multiple of 64.
extern "C" int mlp_mm_stats_launch(const void* a_in, const float* sc,
                                   int res_mode, const void* res_src,
                                   const float* res_sc, const void* w,
                                   void* h_out, void* r_out, float* stats,
                                   float* part, long long rows, int cd, int cu,
                                   int chunk_rows, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return mm_stats_any<bf16>(a_in, sc, res_mode, res_src, res_sc, w, h_out,
                              r_out, stats, part, rows, cd, cu, chunk_rows, s);
  }
  return mm_stats_any<float>(a_in, sc, res_mode, res_src, res_sc, w, h_out,
                             r_out, stats, part, rows, cd, cu, chunk_rows, s);
}

// The pool pass over h (groups * pool, C): out (groups, C) in T, maxv and
// hsel fp32, amax int32; sc (>= 3, C) fp32; pen (groups * pool,) fp32, or
// NULL (no mask, no sentinel).
extern "C" int mlp_bn_pool_launch(const void* h, const float* sc, int res_mode,
                                  const void* res_src, const float* res_sc,
                                  const float* pen, void* out, float* maxv,
                                  int* amax, float* hsel, long long groups,
                                  int c, int pool, int final_relu, int is_bf16,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return bn_pool_any<bf16>(h, sc, res_mode, res_src, res_sc, pen, out, maxv,
                             amax, hsel, groups, c, pool, final_relu, s);
  }
  return bn_pool_any<float>(h, sc, res_mode, res_src, res_sc, pen, out, maxv,
                            amax, hsel, groups, c, pool, final_relu, s);
}

// One backward pass. hu (rows, cu), uc (4, cu) fp32, w (cd, cu), ain (rows,
// cd). dz (rows, cu), or NULL for the pooled layer with dosel (rows / pool,
// cu) fp32 and amax int32. scd (4, cd) fp32 when ain = h_{u-1} lies below a
// BatchNorm, NULL when ain is the chain's input. Below a BatchNorm with a
// dense dz only: the residual of pre_{u-1} (res_mode, res_src, res_sc as
// above, at width cd) and the skip shares added to da, skip_dosel (rows /
// pool, cd) fp32 at row skip_amax (int32) of each group, and skip_dz (rows,
// cd); NULL when absent. Outputs: dzd (rows, cd), or NULL to skip it (input
// layer only); sdse (2, cd) fp32 with scd; dw (cd, cu) fp32. Scratch: part
// (ceil(rows / chunk_rows), 2, cd) and dw_part (ceil(rows / dw_chunk_rows),
// cd, cu) fp32; both chunk sizes are multiples of 64.
extern "C" int mlp_bwd_pass_launch(
    const void* hu, const void* dz, const float* dosel, const int* amax,
    const float* uc, const void* w, const void* ain, const float* scd,
    int res_mode, const void* res_src, const float* res_sc,
    const float* skip_dosel, const int* skip_amax, const void* skip_dz,
    void* dzd, float* sdse, float* dw, float* part, float* dw_part,
    long long rows, int cd, int cu, int pool, int chunk_rows, int dw_chunk_rows,
    int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return bwd_pass_any<bf16>(
        bwd_args<bf16>(hu, dz, dosel, amax, uc, w, ain, scd, res_src, res_sc,
                       skip_dosel, skip_amax, skip_dz, dzd, sdse, dw, part, dw_part),
        res_mode, rows, cd, cu, pool, chunk_rows, dw_chunk_rows, s);
  }
  return bwd_pass_any<float>(
      bwd_args<float>(hu, dz, dosel, amax, uc, w, ain, scd, res_src, res_sc,
                      skip_dosel, skip_amax, skip_dz, dzd, sdse, dw, part, dw_part),
      res_mode, rows, cd, cu, pool, chunk_rows, dw_chunk_rows, s);
}
