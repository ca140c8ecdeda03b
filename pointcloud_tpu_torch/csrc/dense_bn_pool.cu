// Fused Dense -> BatchNorm statistics -> signed block max-pool (sm_90a),
// forward and backward.
//
// Replaces pointcloud_tpu/ops/dense_bn_pool.py:_fwd_kernel and _bwd_kernel
// (reached through dense_pool_stats). With x (rows, Cin) in T (fp32 or bf16)
// (rows = B * R, the flattened batch), w (Cin, C) and bias (C,) in T, a sign
// s (C,) in {+1, -1} fp32, an optional penalty pen (rows,) fp32 and pool
// blocks of `pool` consecutive rows:
//   z      = T(x @ w + bias), the fp32 accumulation plus the bias rounded
//            once to T (flax's Dense output);
//   forward: ssum[c] = sum_r z, ssq[c] = sum_r z^2 over ALL rows, and per
//            block p and channel c the max of s_c z - pen_r with the lowest
//            row winning ties: psel (T) and its row in the block, asel;
//   backward, given dpsel, dssum, dssq:
//            dz = dssum + 2 dssq z + s sparse(asel, dpsel), cast to T,
//            dx = dz @ w^T (T), dw = x^T @ dz (fp32), db = sum_r dz (fp32).
// z and dz never reach device memory: each is recomputed tile by tile from x
// and w and consumed in shared memory or registers.
//
// Design, forward. bf16 with Cin <= 128 and Cin, C multiples of 8, at a
// pool of 16 or 32 rows or a multiple of 64 (every driven shape: PointNet's
// 128 -> 1024 at 2048, the MSG branches' 32-128 -> 64-256 at 16-128;
// ops/dense_bn_pool.py pool_fwd_plan) runs on TMA + wgmma
// (pool_fwd_wgmma_kernel, its note below): a block owns 128 channels of C,
// their w resident in shared memory (two 64-channel atoms, one a consumer
// warpgroup), and a chunk of whole pool blocks whose 64-row x tiles a
// producer streams by TMA (128-byte swizzle) through a ring of mbarriers.
// z = x @ w is a wgmma product with fp32 accumulators in registers; the
// epilogue reads the accumulator registers: z rounded to T after the bias,
// the thread's column sums of z and z^2, its running (max, row) of
// s z - pen. A pool block's
// pairs are merged over lanes (shuffles) and warps (shared memory), lowest
// row on ties, when its last tile is done. z never leaves the registers, no
// pool spans two blocks (no atomics, no key decode), and the column sums go
// to per-chunk partials summed by colsum_kernel (launch 2). The blocks of
// one row chunk run side by side (channel blocks fastest), so the C / 128
// reads of x mostly hit L2.
//   fp32 (the card-vs-CPU checks), ragged widths and other pools take the
//   tile route: every product on one 64 x 128 output tile per block of 256
//   threads (tile_mma.cuh), staged through shared memory in depth chunks of
//   32: bf16 operands through the tensor cores with nvcuda::wmma 16x16x16
//   tiles and fp32 accumulators; fp32 operands on the CUDA cores (4 x 8
//   outputs a thread), so fp32 stays fp32 (no TF32).
//   fwd_kernel (launch 1): a block owns 128 channels and a chunk of 512 rows.
//            Per 64-row tile it forms z in shared memory; each thread then
//            walks one channel over 32 rows, adding to its sum and sum of
//            squares and keeping a running (max, row) per pool block. The
//            pool result of a block that spans several chunks is merged with
//            a 64-bit atomicMax on (order-preserving bits of the value,
//            complement of the row): the max with lowest-row ties is
//            independent of the order of the merges, so it is deterministic.
//            The sums go to per-chunk partials.
//   (launches 2-3) decode the pool keys into psel / asel; sum the partials
//            of ssum and ssq over the chunks in a fixed order.
// Design, backward. Two products, each launch recomputing z from x and w and
// forming dz where it is consumed, so neither reaches device memory (at
// PointNet's 524,288 rows x 1024 channels each would be 1 GB of bf16).
//   bf16 with Cin <= 128 and Cin, C multiples of 8, at pools whose tables
//   fit (below; every driven shape: ops/dense_bn_pool.py pool_bwd_plan) runs
//   on TMA + wgmma (hopper.cuh). A block is one producer warpgroup, whose one
//   thread issues the TMA loads (x and w with the 128-byte swizzle) into
//   mbarrier rings of 5 stages, and two consumer warpgroups that issue wgmma
//   with fp32 accumulators in registers. Each stage also carries, by TMA, the
//   asel and dpsel of the pool blocks its rows meet (a few hundred bytes to
//   tens of KB: what bounds the pool from below), so the sparse term is a
//   shared-memory lookup (read through L1, its latency held up every
//   epilogue).
//   dx (dx_wgmma_kernel): a block walks a chunk of 128-row tiles, each
//            consumer a 64-row half, with the tile's x (rows x Cin, K-major)
//            resident in one of two slots (the next tile's load overlaps).
//            w streams in chunks of 64 channels of C (Cin rows x 128 bytes).
//            Per chunk: z = x @ w_chunk (m64n64, w's chunk read MN-major),
//            then dz in registers: z rounded to T after the bias, dz = dssum
//            + 2 dssq z, plus sign dpsel at the pooled row, zero past the
//            rows or C; packed to bf16 in the accumulator's own order it is
//            the A operand of dx += dz @ w_chunk^T (register-A m64n{64,128}
//            k16, the same w chunk read K-major): no shared-memory trip for
//            dz. dz is formed while the last chunk's dx product runs (two
//            A-operand buffers, chunks unrolled by two so that they stay
//            registers), then the next chunk's z and this chunk's dx are
//            issued; a stage is released two chunks on.
//   dw (dw_wgmma_kernel): computes dw^T. A block owns 128 channels of C (a
//            64-channel atom each consumer) and a chunk of rows walked in
//            64-row steps; its w atoms stay resident, x streams through the
//            ring. Per step each consumer forms z and dz of its atom as above
//            (and adds dz in fp32 to its column sums for db), writes dz to
//            shared memory (MN-major, swizzled, two buffers), then adds
//            dz^T @ x (m64n{64,128}, both operands MN-major) to its dw^T
//            tile: it reads only its own dz, so the consumers meet at no
//            barrier. The next step's z is issued before this step's dw; the
//            last step's dw runs while dz is formed. The tensor cores' fp32
//            sums are not rounded to nearest: each 4 steps (256 rows) are
//            summed by them, then added into fp32 registers. dw and db go to
//            per-chunk partials.
//   fp32 (the card-vs-CPU checks), Cin > 128 and widths that are no
//   multiple of 8 (TMA wants 16-byte rows) take the tile route:
//   bwd_dx_kernel: a block owns 64 rows and 128 input channels; for each
//            128-channel tile of C it recomputes z, forms dz in shared memory
//            and accumulates dx += dz @ w^T in registers.
//   bwd_dw_kernel: a block owns 128 channels of C, 128 of Cin and a chunk of
//            rows; it recomputes z and dz per 64-row tile, accumulates dw +=
//            x^T @ dz and the column sums of dz for db, and writes per-chunk
//            partials.
//   Both routes end with colsum_kernel summing the dw and db partials over
//   the chunks in a fixed order. No fp32 atomics anywhere: the same inputs
//   give the same bits on every run.
// The TPU kernels run one grid step per batch block, carrying the sums and
// dw from step to step in VMEM; CUDA blocks run in parallel with no carry,
// hence the partials and the second passes.
//
// Bound on the card: operations. The forward is one product, 2 rows Cin C
// operations (1.37e11 at rows = 256 x 2048, Cin 128, C 1024: 0.139 ms at the
// dense bf16 tensor-core rate of 989 TFLOP/s); its bytes (x once, w, the
// pooled outputs) take 0.040 ms at 3.35 TB/s. What keeps the TMA + wgmma
// forward from it is its epilogue: ~8.5 issued instructions per z element
// (bias, rounding, two sums, the signed value, the running max and row)
// against 128 multiply-adds of the product at Cin 128, about as many issue
// slots as the tensor cores take clocks; a consumer's epilogue runs beside
// the other consumer's product. The backward needs three such products (z, dx,
// dw): 0.417 ms. The bf16
// backward computes four (z once in each launch): the bound's 4/3, to keep
// 2 GB of z and dz out of device memory.

#include <type_traits>

#include "hopper.cuh"
#include "tile_mma.cuh"

namespace {

using namespace tile;

constexpr int kDwRows = 128;  // input channels a dw block owns (two tiles)

// Leading dimensions (elements) of the shared-memory tiles. Multiples of 8
// for bf16 and 4 for fp32, as wmma requires.
template <typename T>
struct Lds {
  static constexpr int A = KC + Ty<T>::kPad;  // A tile: up to 128 x KC
  static constexpr int B = TN + Ty<T>::kPad;  // B tile: KC x TN
  static constexpr int Z = TN + 4;            // z tile: TM x TN fp32
  static constexpr int D = TN + Ty<T>::kPad;  // dz tile: TM x TN in T
  static constexpr int bytes_a = kDwRows * A * sizeof(T);
  static constexpr int bytes_b = KC * B * sizeof(T);
  static constexpr int bytes_z = TM * Z * 4;
  static constexpr int bytes_d = TM * D * sizeof(T);
  static constexpr int total = bytes_a + bytes_b + bytes_z + bytes_d;
};

template <typename T>
struct Smem {
  T* a;
  T* b;
  float* z;
  T* d;
  __device__ explicit Smem(unsigned char* base) {
    a = reinterpret_cast<T*>(base);
    b = reinterpret_cast<T*>(base + Lds<T>::bytes_a);
    z = reinterpret_cast<float*>(base + Lds<T>::bytes_a + Lds<T>::bytes_b);
    d = reinterpret_cast<T*>(base + Lds<T>::bytes_a + Lds<T>::bytes_b +
                             Lds<T>::bytes_z);
  }
};

// ---- staging from device memory into shared memory (zero outside) ----

// a[r][k] = x[row0 + r, k0 + k] for r < TM, k < KC
template <typename T>
__device__ __forceinline__ void stage_x_rows(T* a, const T* __restrict__ x,
                                             int64_t row0, int64_t rows,
                                             int cin, int k0) {
  const T zero = Ty<T>::from_f(0.f);
  for (int e = threadIdx.x; e < TM * KC; e += kThreads) {
    const int r = e / KC, k = e % KC;
    const int64_t row = row0 + r;
    a[r * Lds<T>::A + k] =
        (row < rows && k0 + k < cin) ? x[row * cin + k0 + k] : zero;
  }
}

// b[k][c] = w[k0 + k, c0 + c] for k < KC, c < TN
template <typename T>
__device__ __forceinline__ void stage_w(T* b, const T* __restrict__ w, int cin,
                                        int C, int k0, int c0) {
  const T zero = Ty<T>::from_f(0.f);
  for (int e = threadIdx.x; e < KC * TN; e += kThreads) {
    const int k = e / TN, c = e % TN;
    b[k * Lds<T>::B + c] = (k0 + k < cin && c0 + c < C)
                               ? w[static_cast<int64_t>(k0 + k) * C + c0 + c]
                               : zero;
  }
}

// b[k][i] = w[i0 + i, c0 + k] (a chunk of w^T) for k < KC, i < TN
template <typename T>
__device__ __forceinline__ void stage_wt(T* b, const T* __restrict__ w, int cin,
                                         int C, int c0, int i0) {
  const T zero = Ty<T>::from_f(0.f);
  for (int e = threadIdx.x; e < KC * TN; e += kThreads) {
    const int i = e / KC, k = e % KC;
    b[k * Lds<T>::B + i] = (i0 + i < cin && c0 + k < C)
                               ? w[static_cast<int64_t>(i0 + i) * C + c0 + k]
                               : zero;
  }
}

// a[i][r] = x[row0 + r, i0 + i] (a chunk of x^T) for i < kDwRows, r < KC
template <typename T>
__device__ __forceinline__ void stage_xt(T* a, const T* __restrict__ x,
                                         int64_t row0, int64_t row_end, int cin,
                                         int i0) {
  const T zero = Ty<T>::from_f(0.f);
  for (int e = threadIdx.x; e < kDwRows * KC; e += kThreads) {
    const int r = e / kDwRows, i = e % kDwRows;
    const int64_t row = row0 + r;
    a[i * Lds<T>::A + r] =
        (row < row_end && i0 + i < cin) ? x[row * cin + i0 + i] : zero;
  }
}

// z tile (TM x TN, fp32 without the bias) of rows row0.. and channels c0..
// into sm.z. Ends with a barrier.
template <typename T>
__device__ __forceinline__ void z_tile(const Smem<T>& sm, const T* x,
                                       const T* w, int64_t row0, int64_t rows,
                                       int cin, int C, int c0) {
  Mma<T> mma;
  mma.zero();
  for (int k0 = 0; k0 < cin; k0 += KC) {
    stage_x_rows(sm.a, x, row0, rows, cin, k0);
    stage_w(sm.b, w, cin, C, k0, c0);
    __syncthreads();
    mma.run(sm.a, Lds<T>::A, sm.b, Lds<T>::B, KC);
    __syncthreads();
  }
  mma.store(sm.z, Lds<T>::Z);
  __syncthreads();
}

// Order-preserving map of a float onto uint32 (larger float, larger key).
__device__ __forceinline__ unsigned ordered_bits(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float from_ordered_bits(unsigned o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

__device__ __forceinline__ void merge_pool(unsigned long long* keys,
                                           int64_t blk, int C, int c,
                                           float best, int within) {
  const unsigned long long key =
      (static_cast<unsigned long long>(ordered_bits(best)) << 32) |
      static_cast<unsigned long long>(0xffffffffu - static_cast<unsigned>(within));
  atomicMax(keys + blk * C + c, key);
}

// ---------------- forward ----------------

template <typename T>
__global__ void __launch_bounds__(kThreads) fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
    const float* __restrict__ sign, const float* __restrict__ pen,
    unsigned long long* __restrict__ keys, float* __restrict__ part,
    int64_t rows, int cin, int C, int pool, int chunk_rows) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Smem<T> sm(smem_raw);
  const int c0 = blockIdx.x * TN;
  const int64_t r_begin = static_cast<int64_t>(blockIdx.y) * chunk_rows;
  const int64_t r_end = rows < r_begin + chunk_rows ? rows : r_begin + chunk_rows;
  const int col = threadIdx.x % TN;
  const int half = threadIdx.x / TN;  // rows [32 half, 32 half + 32) of a tile
  const int c = c0 + col;
  const bool col_ok = c < C;
  const float b_c = col_ok ? Ty<T>::to_f(bias[c]) : 0.f;
  const float s_c = col_ok ? sign[c] : 1.f;

  float sum = 0.f, sq = 0.f;
  int64_t cur_blk = -1;
  float best = 0.f;
  int best_within = 0;
  for (int64_t r0 = r_begin; r0 < r_end; r0 += TM) {
    z_tile(sm, x, w, r0, r_end, cin, C, c0);
    if (col_ok) {
      for (int i = 0; i < TM / 2; ++i) {
        const int rr = half * (TM / 2) + i;
        const int64_t row = r0 + rr;
        if (row >= r_end) break;
        const float z = Ty<T>::to_f(Ty<T>::from_f(sm.z[rr * Lds<T>::Z + col] + b_c));
        sum += z;
        sq += z * z;
        float v = s_c * z;
        if (pen != nullptr) v -= pen[row];
        if (v == 0.f) v = 0.f;  // -0 and +0 tie, as they compare equal
        const int64_t blk = row / pool;
        const int within = static_cast<int>(row - blk * pool);
        if (blk != cur_blk) {
          if (cur_blk >= 0) merge_pool(keys, cur_blk, C, c, best, best_within);
          cur_blk = blk;
          best = v;
          best_within = within;
        } else if (v > best) {  // strict: the lowest row wins ties
          best = v;
          best_within = within;
        }
      }
    }
    __syncthreads();  // sm.z is rewritten by the next tile
  }
  if (col_ok && cur_blk >= 0) merge_pool(keys, cur_blk, C, c, best, best_within);

  // per-chunk partials: the second half's sums, then added to the first's
  if (half == 1) {
    sm.z[col] = sum;
    sm.z[TN + col] = sq;
  }
  __syncthreads();
  if (half == 0 && col_ok) {
    float* p = part + static_cast<int64_t>(blockIdx.y) * 2 * C;
    p[c] = sum + sm.z[col];
    p[C + c] = sq + sm.z[TN + col];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) pool_decode_kernel(
    const unsigned long long* __restrict__ keys, T* __restrict__ psel,
    int* __restrict__ asel, int64_t n) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= n) return;
  const unsigned long long key = keys[e];
  psel[e] = Ty<T>::from_f(from_ordered_bits(static_cast<unsigned>(key >> 32)));
  asel[e] = static_cast<int>(0xffffffffu - static_cast<unsigned>(key & 0xffffffffu));
}

// out[j] = sum_i part[i, j] over i = 0 .. n-1, in that order
__global__ void __launch_bounds__(kThreads) colsum_kernel(
    const float* __restrict__ part, float* __restrict__ out, int n,
    int64_t cols) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= cols) return;
  float s = 0.f;
  for (int i = 0; i < n; ++i) s += part[i * cols + j];
  out[j] = s;
}

// ---------------- backward ----------------

// dz of the tile in sm.z (fp32, without the bias) into sm.d as T; adds the
// fp32 column sums of this thread's rows to *db_sum when db_sum != nullptr.
template <typename T>
__device__ __forceinline__ void dz_tile(
    const Smem<T>& sm, const T* __restrict__ bias, const float* __restrict__ sign,
    const int* __restrict__ asel, const float* __restrict__ dpsel,
    const float* __restrict__ dssum, const float* __restrict__ dssq,
    int64_t row0, int64_t row_end, int C, int c0, int pool, float* db_sum) {
  const int col = threadIdx.x % TN;
  const int half = threadIdx.x / TN;
  const int c = c0 + col;
  const bool col_ok = c < C;
  const float b_c = col_ok ? Ty<T>::to_f(bias[c]) : 0.f;
  const float s_c = col_ok ? sign[c] : 0.f;
  const float a_c = col_ok ? dssum[c] : 0.f;
  const float q_c = col_ok ? 2.f * dssq[c] : 0.f;
  int64_t cur_blk = -1;
  int pick = -1;
  float dpick = 0.f;
  for (int i = 0; i < TM / 2; ++i) {
    const int rr = half * (TM / 2) + i;
    const int64_t row = row0 + rr;
    float dz = 0.f;
    if (col_ok && row < row_end) {
      const float z = Ty<T>::to_f(Ty<T>::from_f(sm.z[rr * Lds<T>::Z + col] + b_c));
      dz = a_c + q_c * z;
      const int64_t blk = row / pool;
      if (blk != cur_blk) {
        cur_blk = blk;
        pick = asel[blk * C + c];
        dpick = dpsel[blk * C + c] * s_c;
      }
      if (row - blk * pool == pick) dz += dpick;
      if (db_sum != nullptr) *db_sum += dz;
    }
    sm.d[rr * Lds<T>::D + col] = Ty<T>::from_f(dz);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) bwd_dx_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
    const float* __restrict__ sign, const int* __restrict__ asel,
    const float* __restrict__ dpsel, const float* __restrict__ dssum,
    const float* __restrict__ dssq, T* __restrict__ dx, int64_t rows, int cin,
    int C, int pool) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Smem<T> sm(smem_raw);
  const int i0 = blockIdx.x * TN;
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * TM;
  Mma<T> acc;
  acc.zero();
  for (int c0 = 0; c0 < C; c0 += TN) {
    z_tile(sm, x, w, r0, rows, cin, C, c0);
    dz_tile(sm, bias, sign, asel, dpsel, dssum, dssq, r0, rows, C, c0, pool,
            static_cast<float*>(nullptr));
    __syncthreads();
    for (int k0 = 0; k0 < TN; k0 += KC) {  // dx += dz[:, k0..] @ w^T[k0.., :]
      stage_wt(sm.b, w, cin, C, c0 + k0, i0);
      __syncthreads();
      acc.run(sm.d + k0, Lds<T>::D, sm.b, Lds<T>::B, KC);
      __syncthreads();
    }
  }
  acc.store(sm.z, Lds<T>::Z);
  __syncthreads();
  for (int e = threadIdx.x; e < TM * TN; e += kThreads) {
    const int r = e / TN, i = e % TN;
    const int64_t row = r0 + r;
    if (row < rows && i0 + i < cin) {
      dx[row * cin + i0 + i] = Ty<T>::from_f(sm.z[r * Lds<T>::Z + i]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) bwd_dw_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
    const float* __restrict__ sign, const int* __restrict__ asel,
    const float* __restrict__ dpsel, const float* __restrict__ dssum,
    const float* __restrict__ dssq, float* __restrict__ dw_part,
    float* __restrict__ db_part, int64_t rows, int cin, int C, int pool,
    int chunk_rows) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Smem<T> sm(smem_raw);
  const int c0 = blockIdx.x * TN;
  const int i0 = blockIdx.y * kDwRows;
  const int64_t r_begin = static_cast<int64_t>(blockIdx.z) * chunk_rows;
  const int64_t r_end = rows < r_begin + chunk_rows ? rows : r_begin + chunk_rows;
  const bool does_db = blockIdx.y == 0;
  Mma<T> acc_lo, acc_hi;  // input channels i0 .. i0+63 and i0+64 .. i0+127
  acc_lo.zero();
  acc_hi.zero();
  float db_sum = 0.f;
  for (int64_t r0 = r_begin; r0 < r_end; r0 += TM) {
    z_tile(sm, x, w, r0, r_end, cin, C, c0);
    dz_tile(sm, bias, sign, asel, dpsel, dssum, dssq, r0, r_end, C, c0, pool,
            does_db ? &db_sum : static_cast<float*>(nullptr));
    __syncthreads();
    for (int k0 = 0; k0 < TM; k0 += KC) {  // dw += x^T[:, k0..] @ dz[k0.., :]
      stage_xt(sm.a, x, r0 + k0, r_end, cin, i0);
      __syncthreads();
      acc_lo.run(sm.a, Lds<T>::A, sm.d + k0 * Lds<T>::D, Lds<T>::D, KC);
      acc_hi.run(sm.a + TM * Lds<T>::A, Lds<T>::A, sm.d + k0 * Lds<T>::D,
                 Lds<T>::D, KC);
      __syncthreads();
    }
  }
  float* out = dw_part + static_cast<int64_t>(blockIdx.z) * cin * C;
  for (int h = 0; h < 2; ++h) {
    if (h == 0) {
      acc_lo.store(sm.z, Lds<T>::Z);
    } else {
      acc_hi.store(sm.z, Lds<T>::Z);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < TM * TN; e += kThreads) {
      const int r = e / TN, c = e % TN;
      const int i = i0 + h * TM + r;
      if (i < cin && c0 + c < C) {
        out[static_cast<int64_t>(i) * C + c0 + c] = sm.z[r * Lds<T>::Z + c];
      }
    }
    __syncthreads();
  }
  if (does_db) {
    const int col = threadIdx.x % TN;
    const int half = threadIdx.x / TN;
    if (half == 1) sm.z[col] = db_sum;
    __syncthreads();
    if (half == 0 && c0 + col < C) {
      db_part[static_cast<int64_t>(blockIdx.z) * C + c0 + col] = db_sum + sm.z[col];
    }
  }
}

template <typename T>
cudaError_t set_smem(const void* kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Lds<T>::total);
}

unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

template <typename T>
int forward(const T* x, const T* w, const T* bias, const float* sign,
            const float* pen, T* psel, int* asel, float* stats,
            unsigned long long* keys, float* part, int64_t rows, int cin,
            int C, int pool, int chunk_rows, cudaStream_t s) {
  const int64_t n_keys = rows / pool * C;
  const int n_chunks = static_cast<int>((rows + chunk_rows - 1) / chunk_rows);
  cudaError_t err = cudaMemsetAsync(keys, 0, n_keys * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = set_smem<T>(reinterpret_cast<const void*>(&fwd_kernel<T>));
  if (err != cudaSuccess) return static_cast<int>(err);
  fwd_kernel<T><<<dim3((C + TN - 1) / TN, n_chunks), kThreads, Lds<T>::total, s>>>(
      x, w, bias, sign, pen, keys, part, rows, cin, C, pool, chunk_rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  pool_decode_kernel<T><<<blocks_for(n_keys), kThreads, 0, s>>>(keys, psel, asel, n_keys);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  colsum_kernel<<<blocks_for(2 * C), kThreads, 0, s>>>(part, stats, n_chunks, 2 * C);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int backward(const T* x, const T* w, const T* bias, const float* sign,
             const int* asel, const float* dpsel, const float* dssum,
             const float* dssq, T* dx, float* dw, float* db, float* dw_part,
             float* db_part, int64_t rows, int cin, int C, int pool,
             int chunk_rows, cudaStream_t s) {
  const int n_chunks = static_cast<int>((rows + chunk_rows - 1) / chunk_rows);
  cudaError_t err;
  err = set_smem<T>(reinterpret_cast<const void*>(&bwd_dx_kernel<T>));
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dx_kernel<T><<<dim3((cin + TN - 1) / TN, static_cast<unsigned>((rows + TM - 1) / TM)),
                     kThreads, Lds<T>::total, s>>>(
      x, w, bias, sign, asel, dpsel, dssum, dssq, dx, rows, cin, C, pool);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  err = set_smem<T>(reinterpret_cast<const void*>(&bwd_dw_kernel<T>));
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dw_kernel<T><<<dim3((C + TN - 1) / TN, (cin + kDwRows - 1) / kDwRows, n_chunks),
                     kThreads, Lds<T>::total, s>>>(
      x, w, bias, sign, asel, dpsel, dssum, dssq, dw_part, db_part, rows, cin,
      C, pool, chunk_rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  colsum_kernel<<<blocks_for(static_cast<int64_t>(cin) * C), kThreads, 0, s>>>(
      dw_part, dw, n_chunks, static_cast<int64_t>(cin) * C);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  colsum_kernel<<<blocks_for(C), kThreads, 0, s>>>(db_part, db, n_chunks, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  return 0;
}

// ---------------- backward, bf16: TMA + wgmma ----------------

constexpr int kWg = 128;             // threads of a warpgroup
constexpr int kWgThreads = 3 * kWg;  // producer + 2 consumers
constexpr int kDxRows = 128;         // rows of a dx tile: a 64-row half a consumer
constexpr int kChunk = 64;           // channels of C in a dx w chunk: 128 bytes of bf16
constexpr int kStages = 5;           // ring stages of both launches
constexpr int kStepRows = 64;        // rows of a dw step
constexpr int kDwCols = 128;         // channels of C a dw block owns
constexpr int kPromote = 4;          // dw steps a tensor-core sum spans
constexpr int kAtom = 64 * 64;       // a 64 x 64 bf16 atom (elements)
constexpr int kSmemLimit = 232448;   // dynamic shared memory a block may have
constexpr int kBadArgs = static_cast<int>(cudaErrorInvalidValue);

// Pool blocks that `window` consecutive rows starting at a multiple of
// `window` can meet: the rows of a ring stage's asel / dpsel tables.
__host__ __device__ constexpr int groups_met(int window, int pool) {
  return (window - 1) / pool + 2;
}

// The per-channel scalars of dz: dz = dssum + 2 dssq T(z + bias) + sign
// dpsel at the row asel of each pool block (see the note at the top).
struct DzArgs {
  const bf16* bias;
  const float* sign;
  const float* dssum;
  const float* dssq;
  int C;
  int pool;
};

// (bias, sign, dssum, 2 dssq) of channel c, zeros past C.
__device__ __forceinline__ float4 dz_scalars(const DzArgs& za, int c) {
  if (c >= za.C) return make_float4(0.f, 0.f, 0.f, 0.f);
  return make_float4(__bfloat162float(za.bias[c]), za.sign[c], za.dssum[c],
                     2.f * za.dssq[c]);
}

// dz at one row (row `within` of its pool block) and two neighbouring
// channels from their products z0, z1 (no bias yet), in the tile route's
// arithmetic: z rounded to bf16 after the bias, fma(2 dssq, z, dssum), then
// + sign dpsel at the pooled row. sel / dps: the stage's asel and dpsel
// tables, `at` the entry of the row's pool block and the first channel.
__device__ __forceinline__ float2 dz_pair(float z0, float z1, const float4& s0,
                                          const float4& s1, const int* sel,
                                          const float* dps, int at, int within) {
  const float r0 = __bfloat162float(__float2bfloat16_rn(__fadd_rn(z0, s0.x)));
  const float r1 = __bfloat162float(__float2bfloat16_rn(__fadd_rn(z1, s1.x)));
  float d0 = __fmaf_rn(s0.w, r0, s0.z);
  float d1 = __fmaf_rn(s1.w, r1, s1.z);
  const int2 k = *reinterpret_cast<const int2*>(sel + at);
  if (k.x == within) d0 = __fadd_rn(d0, __fmul_rn(dps[at], s0.y));
  if (k.y == within) d1 = __fadd_rn(d1, __fmul_rn(dps[at + 1], s1.y));
  return make_float2(d0, d1);
}

__device__ __forceinline__ uint32_t pack_bf16(float2 v) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);  // .x: the low half
  return *reinterpret_cast<const uint32_t*>(&h);
}

// z (64 rows x 64 channels, the warpgroup's fragment) = x_rows @ w_atom over
// the depth Cin (CP / 16 steps): x's CP / 64 K-major atoms (`rows_off`
// elements into each: the warpgroup's 64 rows), w's atom MN-major (Cin rows
// of 128 bytes). Issues and commits one group.
template <int CP, int XROWS>
__device__ __forceinline__ void z_product(float (&z)[32], const bf16 (*x)[XROWS * 64],
                                          int rows_off, const bf16* w) {
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < CP / 16; ++kk) {
    hopper::wgmma_m64n64k16<0, 1>(
        z, hopper::desc_sw128(x[kk / 4] + rows_off + (kk % 4) * 16, 16, 1024),
        hopper::desc_sw128(w + kk * 16 * 64, kAtom * 2, 1024), kk > 0);
  }
  hopper::wgmma_commit();
}

// The fragment's rows (16 warp + lane / 4 and + 8 of a 64-row block): in
// range, their rows within the pool block and the pool blocks' rows in the
// stage's tables (pool block - g0, the first block of the stage's window).
struct FragRows {
  bool ok_a, ok_b;
  int in_a, in_b, gl_a, gl_b;
  __device__ FragRows(int64_t row_a, int64_t end, int pool, int64_t g0) {
    const int64_t row_b = row_a + 8;
    const int64_t grp_a = row_a / pool, grp_b = row_b / pool;
    ok_a = row_a < end;
    ok_b = row_b < end;
    in_a = static_cast<int>(row_a - grp_a * pool);
    in_b = static_cast<int>(row_b - grp_b * pool);
    gl_a = static_cast<int>(grp_a - g0);
    gl_b = static_cast<int>(grp_b - g0);
  }
};

// Shared memory of a dx block: the struct (1024-aligned), then each ring
// stage's asel and dpsel tables (ng pool blocks x 64 channels of 4 bytes
// each, packed as TMA writes them) and the scalars of every channel of C.
template <int CP>
struct alignas(128) DxSmem {
  bf16 x[2][CP / 64][kDxRows * 64];  // two slots of a tile's x: CP / 64 atoms
  bf16 w[kStages][CP * 64];          // w chunks: Cin (to CP) rows x 64 channels
  uint64_t x_full[2], x_empty[2], full[kStages], empty[kStages];
};
template <int CP>
constexpr int dx_smem_bytes(int C, int pool) {
  return 1024 + static_cast<int>(sizeof(DxSmem<CP>)) +
         kStages * 2 * groups_met(kDxRows, pool) * kChunk * 4 + 16 * C;
}

// dx of a chunk of 128-row tiles: both consumers walk every w chunk, each on
// its 64-row half. Per chunk: wait for its z, form dz (the A operand, two
// buffers) while the last chunk's dx product runs, issue the next chunk's z
// and this chunk's dx. A stage is released (by all 8 consumer warps) once
// the dx product that read it is known done, two chunks on.
template <int CP>
__global__ void __launch_bounds__(kWgThreads, 1) dx_wgmma_kernel(
    const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
    const __grid_constant__ CUtensorMap map_sel, const __grid_constant__ CUtensorMap map_dps,
    DzArgs za, bf16* __restrict__ dx, int64_t rows, int cin, int chunk_rows) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = hopper::align1024(smem_raw);
  DxSmem<CP>& sm = *reinterpret_cast<DxSmem<CP>*>(base);
  const int ng = groups_met(kDxRows, za.pool);
  const int tab = ng * kChunk;  // entries of one table
  int* tabs = reinterpret_cast<int*>(base + sizeof(DxSmem<CP>));  // [stage][sel, dps][tab]
  float4* sc = reinterpret_cast<float4*>(tabs + kStages * 2 * tab);
  const int C = za.C;
  const int64_t r_begin = static_cast<int64_t>(blockIdx.x) * chunk_rows;
  const int64_t r_end = rows < r_begin + chunk_rows ? rows : r_begin + chunk_rows;
  const int tiles = static_cast<int>((r_end - r_begin + kDxRows - 1) / kDxRows);
  const int chunks = (C + kChunk - 1) / kChunk;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      hopper::mbar_init(&sm.full[i], 1);
      hopper::mbar_init(&sm.empty[i], 8);  // the 8 warps of both consumers
    }
    for (int i = 0; i < 2; ++i) {
      hopper::mbar_init(&sm.x_full[i], 1);
      hopper::mbar_init(&sm.x_empty[i], 8);
    }
    hopper::fence_barrier_init();
  }
  for (int c = threadIdx.x; c < C; c += kWgThreads) sc[c] = dz_scalars(za, c);
  __syncthreads();

  if (threadIdx.x < kWg) {  // producer
    hopper::regs_release<40>();
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < tiles; ++t) {
        const int slot = t & 1;
        const int row0 = static_cast<int>(r_begin) + t * kDxRows;
        const int g0 = row0 / za.pool;
        hopper::mbar_wait(&sm.x_empty[slot], ((t >> 1) & 1) ^ 1);
        hopper::mbar_expect_tx(&sm.x_full[slot], CP / 64 * kDxRows * 64 * 2);
        for (int a = 0; a < CP / 64; ++a)
          hopper::tma_load_2d(sm.x[slot][a], &map_x, &sm.x_full[slot], 64 * a, row0);
        for (int ch = 0; ch < chunks; ++ch) {
          hopper::mbar_wait(&sm.empty[stage], phase ^ 1);
          hopper::mbar_expect_tx(&sm.full[stage], CP * 64 * 2 + 2 * tab * 4);
          hopper::tma_load_2d(sm.w[stage], &map_w, &sm.full[stage], ch * kChunk, 0);
          int* t2 = tabs + stage * 2 * tab;
          hopper::tma_load_2d(t2, &map_sel, &sm.full[stage], ch * kChunk, g0);
          hopper::tma_load_2d(t2 + tab, &map_dps, &sm.full[stage], ch * kChunk, g0);
          if (++stage == kStages) stage = 0, phase ^= 1;
        }
      }
    }
    return;
  }

  hopper::regs_claim<232>();  // 40 x 128 + 232 x 256 = the block's 168 x 384
  const int g = threadIdx.x / kWg - 1;  // rows 64 g .. of each tile
  const int tid = threadIdx.x % kWg, warp = tid / 32, lane = tid % 32;
  const int rq = warp * 16 + lane / 4, cq = 2 * (lane % 4);
  float z[32], acc[CP / 2];
  uint32_t a[2][4][4];  // dz of a chunk, the A operand of its 4 depth slices
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) a[b][i][j] = 0u;
  for (int t = 0; t < tiles; ++t) {
    const int slot = t & 1;
    const int64_t row0 = r_begin + static_cast<int64_t>(t) * kDxRows;
    const int64_t row_a = row0 + 64 * g + rq;
    const FragRows fr(row_a, r_end, za.pool, row0 / za.pool);
    hopper::mbar_wait(&sm.x_full[slot], (t >> 1) & 1);
#pragma unroll
    for (int i = 0; i < CP / 2; ++i) acc[i] = 0.f;
    const int pos0 = t * chunks;  // ring position of the tile's first chunk
    hopper::mbar_wait(&sm.full[pos0 % kStages], (pos0 / kStages) & 1);
    z_product<CP, kDxRows>(z, sm.x[slot], 64 * g * 64, sm.w[pos0 % kStages]);
    // one chunk; P = ch % 2 picks the A operand's buffer at compile time
    // (registers indexed at run time would live in local memory)
    const auto chunk_step = [&](auto parity, int ch) {
      constexpr int P = decltype(parity)::value;
      const int pos = pos0 + ch, stage = pos % kStages;
      // this chunk's z is done (and the dx product two chunks back); the
      // last chunk's dx product may still run
      if (ch == 0) {
        hopper::wgmma_wait<0>();
      } else {
        hopper::wgmma_wait<1>();
      }
      hopper::fence_regs(z);
#pragma unroll
      for (int i = 0; i < 4; ++i) hopper::fence_regs(a[P][i]);
      if (ch >= 2 && lane == 0) hopper::mbar_arrive(&sm.empty[(pos - 2) % kStages]);
      const int* sel = tabs + stage * 2 * tab;
      const float* dps = reinterpret_cast<const float*>(sel + tab);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cl = 8 * j + cq, col = ch * kChunk + cl;
        float2 va = make_float2(0.f, 0.f), vb = va;
        if (col < C) {  // C is a multiple of 8: both channels or neither
          const float4 s0 = sc[col], s1 = sc[col + 1];
          if (fr.ok_a)
            va = dz_pair(z[4 * j], z[4 * j + 1], s0, s1, sel, dps, fr.gl_a * kChunk + cl,
                         fr.in_a);
          if (fr.ok_b)
            vb = dz_pair(z[4 * j + 2], z[4 * j + 3], s0, s1, sel, dps,
                         fr.gl_b * kChunk + cl, fr.in_b);
        }
        a[P][j / 2][(j % 2) * 2] = pack_bf16(va);
        a[P][j / 2][(j % 2) * 2 + 1] = pack_bf16(vb);
      }
      if (ch + 1 < chunks) {  // the next chunk's z, then this chunk's dx
        const int next = (pos + 1) % kStages;
        hopper::mbar_wait(&sm.full[next], ((pos + 1) / kStages) & 1);
        z_product<CP, kDxRows>(z, sm.x[slot], 64 * g * 64, sm.w[next]);
      }
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hopper::wgmma_m64nNk16_rs<CP, 0>(
            acc, a[P][kk], hopper::desc_sw128(sm.w[stage] + kk * 16, 16, 1024), 1);
      }
      hopper::wgmma_commit();
    };
    for (int ch = 0; ch < chunks; ch += 2) {
      chunk_step(std::integral_constant<int, 0>{}, ch);
      if (ch + 1 < chunks) chunk_step(std::integral_constant<int, 1>{}, ch + 1);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int i = 0; i < 4; ++i) hopper::fence_regs(a[b][i]);
    if (lane == 0) {
      const int last = pos0 + chunks - 1;
      if (chunks >= 2) hopper::mbar_arrive(&sm.empty[(last - 1) % kStages]);
      hopper::mbar_arrive(&sm.empty[last % kStages]);
      hopper::mbar_arrive(&sm.x_empty[slot]);
    }
#pragma unroll
    for (int j = 0; j < CP / 8; ++j) {
      const int col = 8 * j + cq;
      if (col < cin) {
        if (fr.ok_a)
          *reinterpret_cast<uint32_t*>(dx + row_a * cin + col) =
              pack_bf16(make_float2(acc[4 * j], acc[4 * j + 1]));
        if (fr.ok_b)
          *reinterpret_cast<uint32_t*>(dx + (row_a + 8) * cin + col) =
              pack_bf16(make_float2(acc[4 * j + 2], acc[4 * j + 3]));
      }
    }
  }
}

// Shared memory of a dw block: the struct, then each ring stage's asel and
// dpsel tables (ng pool blocks x the block's 128 channels).
template <int CP>
struct alignas(128) DwSmem {
  bf16 x[kStages][CP / 64][kStepRows * 64];  // x steps: CP / 64 atoms of 64 rows
  bf16 w[2][CP * 64];                        // the block's w: two 64-channel atoms
  bf16 dz[2][2][kStepRows * 64];             // [step parity][atom]: 64 rows x 64, MN-major
  float4 sc[kDwCols];                        // (bias, sign, dssum, 2 dssq)
  float red[2][4][64];                       // db: [consumer][warp][channel]
  uint64_t full[kStages], empty[kStages], w_full;
};
template <int CP>
constexpr int dw_smem_bytes(int pool) {
  return 1024 + static_cast<int>(sizeof(DwSmem<CP>)) +
         kStages * 2 * groups_met(kStepRows, pool) * kDwCols * 4;
}

// dw and db partials of a chunk of rows for 128 channels of C (c0..): the
// consumer g owns the 64 channels c0 + 64 g .. (an atom); per step it forms
// their z and dz, writes dz to shared memory (MN-major, swizzled, two
// buffers) and adds dw^T (its 64 channels x Cin) += dz^T @ x (both operands
// MN-major): each consumer reads only its own dz, so the two meet at no
// barrier. Per step: wait for its z (the last step's dw product may still
// run), form dz, issue the next step's z, then this step's dw. Each kPromote
// steps the dw sums are waited for and added into fp32 registers. A consumer
// whose atom lies past C only releases the stages.
template <int CP>
__global__ void __launch_bounds__(kWgThreads, 1) dw_wgmma_kernel(
    const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
    const __grid_constant__ CUtensorMap map_sel, const __grid_constant__ CUtensorMap map_dps,
    DzArgs za, float* __restrict__ dw_part, float* __restrict__ db_part, int64_t rows,
    int cin, int chunk_rows) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = hopper::align1024(smem_raw);
  DwSmem<CP>& sm = *reinterpret_cast<DwSmem<CP>*>(base);
  const int ng = groups_met(kStepRows, za.pool);
  const int tab = ng * kDwCols;
  int* tabs = reinterpret_cast<int*>(base + sizeof(DwSmem<CP>));  // [stage][sel, dps][tab]
  const int C = za.C;
  const int c0 = blockIdx.x * kDwCols;
  const int64_t r_begin = static_cast<int64_t>(blockIdx.y) * chunk_rows;
  const int64_t r_end = rows < r_begin + chunk_rows ? rows : r_begin + chunk_rows;
  const int steps = static_cast<int>((r_end - r_begin + kStepRows - 1) / kStepRows);
  const int c_atoms = min(2, (C - c0 + 63) / 64);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      hopper::mbar_init(&sm.full[i], 1);
      hopper::mbar_init(&sm.empty[i], 8);
    }
    hopper::mbar_init(&sm.w_full, 1);
    hopper::fence_barrier_init();
  }
  for (int c = threadIdx.x; c < kDwCols; c += kWgThreads) sm.sc[c] = dz_scalars(za, c0 + c);
  __syncthreads();

  if (threadIdx.x < kWg) {  // producer
    hopper::regs_release<40>();
    if (threadIdx.x == 0) {
      hopper::mbar_expect_tx(&sm.w_full, c_atoms * CP * 64 * 2);
      for (int a = 0; a < c_atoms; ++a)
        hopper::tma_load_2d(sm.w[a], &map_w, &sm.w_full, c0 + 64 * a, 0);
      int stage = 0;
      uint32_t phase = 0;
      for (int s = 0; s < steps; ++s) {
        const int row = static_cast<int>(r_begin) + s * kStepRows;
        hopper::mbar_wait(&sm.empty[stage], phase ^ 1);
        hopper::mbar_expect_tx(&sm.full[stage], CP / 64 * kAtom * 2 + 2 * tab * 4);
        for (int a = 0; a < CP / 64; ++a)
          hopper::tma_load_2d(sm.x[stage][a], &map_x, &sm.full[stage], 64 * a, row);
        int* t2 = tabs + stage * 2 * tab;
        hopper::tma_load_2d(t2, &map_sel, &sm.full[stage], c0, row / za.pool);
        hopper::tma_load_2d(t2 + tab, &map_dps, &sm.full[stage], c0, row / za.pool);
        if (++stage == kStages) stage = 0, phase ^= 1;
      }
    }
    return;
  }

  hopper::regs_claim<232>();
  const int g = threadIdx.x / kWg - 1;
  const int tid = threadIdx.x % kWg, warp = tid / 32, lane = tid % 32;
  const int rq = warp * 16 + lane / 4, cq = 2 * (lane % 4);
  if (g >= c_atoms) {  // no channel of C: release the stages as they come
    for (int s = 0; s < steps; ++s) {
      hopper::mbar_wait(&sm.full[s % kStages], (s / kStages) & 1);
      if (lane == 0) hopper::mbar_arrive(&sm.empty[s % kStages]);
    }
    return;
  }
  hopper::mbar_wait(&sm.w_full, 0);
  float z[32], d[CP / 2], acc[CP / 2], db[16];
#pragma unroll
  for (int i = 0; i < CP / 2; ++i) d[i] = acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) db[i] = 0.f;
  hopper::mbar_wait(&sm.full[0], 0);
  z_product<CP, kStepRows>(z, sm.x[0], 0, sm.w[g]);
  for (int s = 0; s < steps; ++s) {
    const int stage = s % kStages;
    // this step's z is done (and the dw product two steps back); the last
    // step's dw product may still run, but not across a promotion
    const bool promote = s > 0 && (s - 1) % kPromote == kPromote - 1;
    if (s == 0 || promote) {
      hopper::wgmma_wait<0>();
    } else {
      hopper::wgmma_wait<1>();
    }
    hopper::fence_regs(z);
    hopper::fence_regs(d);
    if (promote) {
#pragma unroll
      for (int i = 0; i < CP / 2; ++i) acc[i] += d[i];
    }
    if (s >= 2 && lane == 0) hopper::mbar_arrive(&sm.empty[(s - 2) % kStages]);
    const int64_t row0 = r_begin + static_cast<int64_t>(s) * kStepRows;
    const FragRows fr(row0 + rq, r_end, za.pool, row0 / za.pool);
    const int* sel = tabs + stage * 2 * tab;
    const float* dps = reinterpret_cast<const float*>(sel + tab);
    bf16* dzt = sm.dz[s & 1][g];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int cl = 64 * g + 8 * j + cq;
      float2 va = make_float2(0.f, 0.f), vb = va;
      if (c0 + cl < C) {
        const float4 s0 = sm.sc[cl], s1 = sm.sc[cl + 1];
        if (fr.ok_a)
          va = dz_pair(z[4 * j], z[4 * j + 1], s0, s1, sel, dps, fr.gl_a * kDwCols + cl,
                       fr.in_a);
        if (fr.ok_b)
          vb = dz_pair(z[4 * j + 2], z[4 * j + 3], s0, s1, sel, dps, fr.gl_b * kDwCols + cl,
                       fr.in_b);
      }
      db[2 * j] += va.x;
      db[2 * j] += vb.x;
      db[2 * j + 1] += va.y;
      db[2 * j + 1] += vb.y;
      // (row, channel) of an MN-major swizzled atom: 128-byte rows, 16-byte
      // chunk j of row r at chunk j ^ (r % 8); rows rq and rq + 8 share it
      const int at = (j ^ (rq & 7)) * 8 + cq;
      *reinterpret_cast<uint32_t*>(dzt + rq * 64 + at) = pack_bf16(va);
      *reinterpret_cast<uint32_t*>(dzt + (rq + 8) * 64 + at) = pack_bf16(vb);
    }
    hopper::fence_proxy_async();
    if (s + 1 < steps) {  // the next step's z runs while this step's dw is issued
      const int next = (s + 1) % kStages;
      hopper::mbar_wait(&sm.full[next], ((s + 1) / kStages) & 1);
      z_product<CP, kStepRows>(z, sm.x[next], 0, sm.w[g]);
    }
    hopper::named_sync(2 + g, kWg);  // the consumer's dz written
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kStepRows / 16; ++kk) {
      hopper::wgmma_m64nNk16<CP, 1, 1>(
          d, hopper::desc_sw128(dzt + kk * 16 * 64, kAtom * 2, 1024),
          hopper::desc_sw128(sm.x[stage][0] + kk * 16 * 64, kAtom * 2, 1024),
          kk > 0 || s % kPromote != 0);
    }
    hopper::wgmma_commit();
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(d);
  if (steps > 0) {
#pragma unroll
    for (int i = 0; i < CP / 2; ++i) acc[i] += d[i];
  }
  // dw^T's fragment: rows are channels of C, columns channels of Cin
  const int64_t chunk = blockIdx.y;
  float* out = dw_part + chunk * cin * C;
#pragma unroll
  for (int j = 0; j < CP / 8; ++j) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = c0 + 64 * g + rq + 8 * (q >> 1), i = 8 * j + cq + (q & 1);
      if (i < cin && c < C) out[static_cast<int64_t>(i) * C + c] = acc[4 * j + q];
    }
  }
  // db: the 8 lanes of a channel pair, then the 4 warps, in a fixed order
#pragma unroll
  for (int i = 0; i < 16; ++i) {
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) db[i] += __shfl_xor_sync(0xffffffffu, db[i], off);
  }
  if (lane < 4) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sm.red[g][warp][8 * j + cq] = db[2 * j];
      sm.red[g][warp][8 * j + cq + 1] = db[2 * j + 1];
    }
  }
  hopper::named_sync(2 + g, kWg);
  if (tid < 64 && c0 + 64 * g + tid < C) {
    const float* r = &sm.red[g][0][tid];
    db_part[chunk * C + c0 + 64 * g + tid] = ((r[0] + r[64]) + r[128]) + r[192];
  }
}

// ---------------- forward, bf16: TMA + wgmma ----------------

constexpr int kFwdStages = 6;  // ring stages of 64-row x tiles
constexpr int kFwdTile = 64;   // rows of a tile: one m64 product a consumer

// Shared memory of a forward block: the ring of x tiles (CP / 64 K-major
// atoms of 64 rows each), the block's w (two 64-channel atoms, MN-major),
// the pool reductions' (value, row) per [parity][consumer][warp][channel],
// the column sums per [consumer][warp][sum, sq][channel] and the mbarriers.
template <int CP>
struct alignas(128) FwdSmem {
  bf16 x[kFwdStages][CP / 64][kFwdTile * 64];
  bf16 w[2][CP * 64];
  float red_v[2][2][4][64];
  int red_r[2][2][4][64];
  float stat[2][4][2][64];
  uint64_t full[kFwdStages], empty[kFwdStages], w_full;
};
template <int CP>
constexpr int fwd_smem_bytes() {
  return 1024 + static_cast<int>(sizeof(FwdSmem<CP>));
}

// (value, row) b replaces a if larger, or equal at a lower row: a total
// order on distinct rows, so any merge order gives the same pair.
__device__ __forceinline__ void pool_take(float& v, int& r, float v2, int r2) {
  if (v2 > v || (v2 == v && r2 < r)) {
    v = v2;
    r = r2;
  }
}

// One block: channels c0 = 128 blockIdx.x .. (two 64-channel atoms of w,
// resident) over the chunk of rows blockIdx.y, walked in 64-row tiles that
// the producer streams through a ring. Consumer g takes atom g of every tile;
// where the block has one atom (C - c0 <= 64) and a tile holds whole pool
// blocks (pool <= 64), the consumers take alternate tiles of atom 0 instead
// (at larger pools consumer 1 idles). Per tile, z = x_tile @ w_atom
// (m64n64, fp32 in registers), then the epilogue on the accumulator
// registers: z rounded to bf16 after the bias, added to the thread's column
// sums of z and z^2 (its rows in order), and folded into the thread's
// running (max, row) of s z - pen per channel. At a pool block's last tile
// the (max, row) pairs are merged over the 8 lanes of a channel pair
// (shuffles), then over the warps that share the pool block (shared
// memory), lowest row on ties, and written. The chunk holds whole pool
// blocks, so no pool spans two blocks. At the end the sums are reduced over
// lanes, warps and consumers in a fixed order into part[chunk, 0 / 1, :].
// z never leaves the registers; the two consumers' products and epilogues
// overlap each other.
template <int CP>
__global__ void __launch_bounds__(kWgThreads, 1) pool_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
    const bf16* __restrict__ bias, const float* __restrict__ sign,
    const float* __restrict__ pen, bf16* __restrict__ psel, int* __restrict__ asel,
    float* __restrict__ part, int64_t rows, int C, int pool, int chunk_rows) {
  extern __shared__ unsigned char smem_raw[];
  FwdSmem<CP>& sm = *reinterpret_cast<FwdSmem<CP>*>(hopper::align1024(smem_raw));
  const int c0 = blockIdx.x * kDwCols;
  const int64_t r_begin = static_cast<int64_t>(blockIdx.y) * chunk_rows;
  const int64_t r_end = rows < r_begin + chunk_rows ? rows : r_begin + chunk_rows;
  const int tiles = static_cast<int>((r_end - r_begin + kFwdTile - 1) / kFwdTile);
  const int atoms = min(2, (C - c0 + 63) / 64);
  const bool alternate = atoms == 1 && pool <= kFwdTile;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kFwdStages; ++i) {
      hopper::mbar_init(&sm.full[i], 1);
      hopper::mbar_init(&sm.empty[i], atoms == 2 ? 8 : 4);  // the warps reading a stage
    }
    hopper::mbar_init(&sm.w_full, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  // the warpgroup, broadcast from lane 0: ptxas then sees warp-uniform
  // branches around the products
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / kWg, 0);

  if (wg == 0) {  // producer
    hopper::regs_release<40>();
    if (threadIdx.x == 0) {
      hopper::mbar_expect_tx(&sm.w_full, atoms * CP * 64 * 2);
      for (int a = 0; a < atoms; ++a)
        hopper::tma_load_2d(sm.w[a], &map_w, &sm.w_full, c0 + 64 * a, 0);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < tiles; ++t) {
        hopper::mbar_wait(&sm.empty[stage], phase ^ 1);
        hopper::mbar_expect_tx(&sm.full[stage], CP / 64 * kAtom * 2);
        for (int a = 0; a < CP / 64; ++a)
          hopper::tma_load_2d(sm.x[stage][a], &map_x, &sm.full[stage], 64 * a,
                              static_cast<int>(r_begin) + t * kFwdTile);
        if (++stage == kFwdStages) stage = 0, phase ^= 1;
      }
    }
    return;
  }

  hopper::regs_claim<232>();
  const int g = wg - 1;
  const int tid = threadIdx.x % kWg, warp = tid / 32, lane = tid % 32;
  const int rq = warp * 16 + lane / 4, cq = 2 * (lane % 4);
  const int atom = alternate ? 0 : g;
  const int t0 = alternate ? g : 0, dt = alternate ? 2 : 1;
  const int mine = atom < atoms ? (tiles - t0 + dt - 1) / dt : 0;  // this consumer's tiles
  const int cb = c0 + 64 * atom;  // the atom's first channel
  // warps that share a pool block (1, 2 or 4) and pool blocks a tile holds
  const int wpb = (pool < kFwdTile ? pool : kFwdTile) / 16, per_tile = 4 / wpb;
  float bb[16], sg[16], sum[16], sq[16], best[16];
  int brow[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int c = cb + 8 * (i / 2) + cq + (i % 2);
    bb[i] = c < C ? __bfloat162float(bias[c]) : 0.f;
    sg[i] = c < C ? sign[c] : 1.f;
    sum[i] = sq[i] = 0.f;
    best[i] = -INFINITY;
    brow[i] = 0;
  }
  int reductions = 0;

  // rows fit int32 (ops/dense_bn_pool.py _MAX_ROWS): the tile's row
  // arithmetic stays 32-bit
  const int row_begin = static_cast<int>(r_begin), row_end = static_cast<int>(r_end);
  const int blocks = static_cast<int>(rows / pool), in_q = rq % pool;
  // the epilogue of tile t from its accumulator fragment z; `at`: the tile's
  // first row within its pool block (0 where pool <= 64)
  const auto epilogue = [&](float (&z)[32], int t, int at) {
    const int row0 = row_begin + t * kFwdTile, ra = row0 + rq;
    // a 16-row warp slice lies in or past the rows: lane 0's answer, a
    // warp-uniform branch around the reads of the accumulators
    const bool ok = __shfl_sync(0xffffffffu, ra < row_end, 0);
    const int in_a = at + in_q, in_b = in_a + 8;
    if (at == 0) {  // a new pool block
#pragma unroll
      for (int i = 0; i < 16; ++i) best[i] = -INFINITY, brow[i] = in_a;
    }
    if (ok) {
      const float npa = pen != nullptr ? -pen[ra] : -0.f;
      const float npb = pen != nullptr ? -pen[ra + 8] : -0.f;  // ra + 8 < row_end
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // rounded to bf16 in pairs and widened back by a shift and a mask
        const uint32_t ha = pack_bf16(
            make_float2(__fadd_rn(z[4 * j], bb[2 * j]), __fadd_rn(z[4 * j + 1], bb[2 * j + 1])));
        const uint32_t hb = pack_bf16(make_float2(__fadd_rn(z[4 * j + 2], bb[2 * j]),
                                                  __fadd_rn(z[4 * j + 3], bb[2 * j + 1])));
        const float za[2] = {__uint_as_float(ha << 16), __uint_as_float(ha & 0xffff0000u)};
        const float zb[2] = {__uint_as_float(hb << 16), __uint_as_float(hb & 0xffff0000u)};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 2 * j + h;
          sum[i] = __fadd_rn(__fadd_rn(sum[i], za[h]), zb[h]);
          sq[i] = __fmaf_rn(zb[h], zb[h], __fmaf_rn(za[h], za[h], sq[i]));
          // s z - pen in one rounding (s z is exact), strict: the lower row
          // wins ties (-0 and +0 compare equal)
          const float va = __fmaf_rn(sg[i], za[h], npa);
          if (va > best[i]) best[i] = va, brow[i] = in_a;
          const float vb = __fmaf_rn(sg[i], zb[h], npb);
          if (vb > best[i]) best[i] = vb, brow[i] = in_b;
        }
      }
    }
    if (at + kFwdTile < pool) return;  // the pool block goes on
    // the pool block's (max, row): the 8 lanes of a channel pair, then its warps
#pragma unroll
    for (int i = 0; i < 16; ++i) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        pool_take(best[i], brow[i], __shfl_xor_sync(0xffffffffu, best[i], off),
                  __shfl_xor_sync(0xffffffffu, brow[i], off));
    }
    const int blk0 = row0 / pool;
    if (wpb == 1) {  // a warp holds a whole pool block
      const int64_t blk = blk0 + warp;
      if (lane < 4 && blk < blocks) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = cb + 8 * j + cq;
          if (c < C) {
            *reinterpret_cast<__nv_bfloat162*>(psel + blk * C + c) =
                __floats2bfloat162_rn(best[2 * j] + 0.f, best[2 * j + 1] + 0.f);
            *reinterpret_cast<int2*>(asel + blk * C + c) = make_int2(brow[2 * j], brow[2 * j + 1]);
          }
        }
      }
      return;
    }
    const int par = reductions++ & 1;
    if (lane < 4) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int cl = 8 * (i / 2) + cq + (i % 2);
        sm.red_v[par][g][warp][cl] = best[i];
        sm.red_r[par][g][warp][cl] = brow[i];
      }
    }
    hopper::named_sync(2 + g, kWg);
    for (int e = tid; e < per_tile * 64; e += kWg) {
      const int pb = e / 64, cl = e % 64, c = cb + cl;
      const int64_t blk = blk0 + pb;  // pb = 0 where pool >= 64
      float v = sm.red_v[par][g][pb * wpb][cl];
      int r = sm.red_r[par][g][pb * wpb][cl];
      for (int w = 1; w < wpb; ++w)
        pool_take(v, r, sm.red_v[par][g][pb * wpb + w][cl], sm.red_r[par][g][pb * wpb + w][cl]);
      if (c < C && blk < blocks) {
        psel[blk * C + c] = __float2bfloat16_rn(v + 0.f);  // -0 as +0
        asel[blk * C + c] = r;
      }
    }
  };

  // tile by tile: the product, waited for at once, then the stage released
  // and the epilogue on the accumulators. (Issuing the next tile's product
  // into a second accumulator before this epilogue makes ptxas serialize
  // every wgmma, C7514: its reads of one buffer fall inside the other's
  // pipeline stage; measured slower than this order.)
  float acc[32];
  if (mine > 0) hopper::mbar_wait(&sm.w_full, 0);
  int at = (row_begin + t0 * kFwdTile) % pool;  // the tile's first row in its pool block
  for (int i = 0; i < mine; ++i) {
    const int t = t0 + i * dt, stage = t % kFwdStages;
    hopper::mbar_wait(&sm.full[stage], (t / kFwdStages) & 1);
    z_product<CP, kFwdTile>(acc, sm.x[stage], 0, sm.w[atom]);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    if (lane == 0) hopper::mbar_arrive(&sm.empty[stage]);
    epilogue(acc, t, pool > kFwdTile ? at : 0);
    if ((at += dt * kFwdTile) >= pool) at -= pool;
  }
  // column sums: the 8 lanes of a channel pair, the warps in order, the
  // consumers in order where they shared the atom
#pragma unroll
  for (int i = 0; i < 16; ++i) {
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], off);
      sq[i] += __shfl_xor_sync(0xffffffffu, sq[i], off);
    }
  }
  if (lane < 4) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int cl = 8 * (i / 2) + cq + (i % 2);
      sm.stat[g][warp][0][cl] = sum[i];
      sm.stat[g][warp][1][cl] = sq[i];
    }
  }
  hopper::named_sync(1, 2 * kWg);
  // consumer g writes atom g; where the consumers shared atom 0, consumer 0
  // adds both in order (thread tid: sum or sum of squares of channel tid % 64)
  if (atoms == 2 || g == 0) {
    const int q = tid / 64, cl = tid % 64, c = c0 + 64 * g + cl;
    float s = 0.f;
    for (int h = atoms == 2 ? g : 0; h <= (atoms == 2 ? g : 1); ++h)
      for (int w = 0; w < 4; ++w) s += sm.stat[h][w][q][cl];
    if (c < C) part[(static_cast<int64_t>(blockIdx.y) * 2 + q) * C + c] = s;
  }
}

bool misaligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) != 0; }

template <int CP>
int forward_wgmma(const bf16* x, const bf16* w, const bf16* bias, const float* sign,
                  const float* pen, bf16* psel, int* asel, float* stats, float* part,
                  int64_t rows, int cin, int C, int pool, int chunk_rows, cudaStream_t s) {
  if (chunk_rows < 1 || chunk_rows % kFwdTile != 0 || chunk_rows % pool != 0 ||
      rows % pool != 0 || pool < 16 || (pool % kFwdTile != 0 && kFwdTile % pool != 0) ||
      misaligned(x) || misaligned(w) || fwd_smem_bytes<CP>() > kSmemLimit)
    return kBadArgs;
  CUtensorMap map_x, map_w;
  if (!hopper::bf16_map(&map_x, x, cin, rows, cin, 64, kFwdTile) ||
      !hopper::bf16_map(&map_w, w, C, cin, C, 64, CP))
    return kBadArgs;
  const void* kernel = reinterpret_cast<const void*>(&pool_fwd_wgmma_kernel<CP>);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         fwd_smem_bytes<CP>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = static_cast<int>((rows + chunk_rows - 1) / chunk_rows);
  pool_fwd_wgmma_kernel<CP><<<dim3((C + kDwCols - 1) / kDwCols, chunks), kWgThreads,
                              fwd_smem_bytes<CP>(), s>>>(map_x, map_w, bias, sign, pen, psel,
                                                         asel, part, rows, C, pool, chunk_rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  colsum_kernel<<<blocks_for(2 * C), kThreads, 0, s>>>(part, stats, chunks, 2 * C);
  return static_cast<int>(cudaGetLastError());
}

template <int CP>
int backward_wgmma(const bf16* x, const bf16* w, const int* asel, const float* dpsel,
                   const DzArgs& za, bf16* dx, float* dw, float* db, float* dw_part,
                   float* db_part, int64_t rows, int cin, int dx_chunk_rows,
                   int dw_chunk_rows, cudaStream_t s) {
  const int C = za.C;
  const int64_t groups = rows / za.pool;
  if (dx_chunk_rows % kDxRows != 0 || dw_chunk_rows % kStepRows != 0 ||
      dx_chunk_rows < 1 || dw_chunk_rows < 1 || rows % za.pool != 0 || misaligned(x) ||
      misaligned(w) || misaligned(asel) || misaligned(dpsel) ||
      dx_smem_bytes<CP>(C, za.pool) > kSmemLimit || dw_smem_bytes<CP>(za.pool) > kSmemLimit)
    return kBadArgs;
  CUtensorMap map_w;
  if (!hopper::bf16_map(&map_w, w, C, cin, C, 64, CP)) return kBadArgs;
  // dx: one block a chunk of 128-row tiles
  const int dx_ng = groups_met(kDxRows, za.pool);
  CUtensorMap dx_x, dx_sel, dx_dps;
  if (!hopper::bf16_map(&dx_x, x, cin, rows, cin, 64, kDxRows) ||
      !hopper::b32_map(&dx_sel, asel, C, groups, C, kChunk, dx_ng) ||
      !hopper::b32_map(&dx_dps, dpsel, C, groups, C, kChunk, dx_ng))
    return kBadArgs;
  const void* dx_kernel = reinterpret_cast<const void*>(&dx_wgmma_kernel<CP>);
  const int dx_smem = dx_smem_bytes<CP>(C, za.pool);
  cudaError_t err =
      cudaFuncSetAttribute(dx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dx_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned dx_chunks = static_cast<unsigned>((rows + dx_chunk_rows - 1) / dx_chunk_rows);
  dx_wgmma_kernel<CP><<<dx_chunks, kWgThreads, dx_smem, s>>>(dx_x, map_w, dx_sel, dx_dps, za,
                                                             dx, rows, cin, dx_chunk_rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  // dw and db: a block 128 channels of C over a split-K chunk, the chunks'
  // partials summed in order
  const int dw_ng = groups_met(kStepRows, za.pool);
  CUtensorMap dw_x, dw_sel, dw_dps;
  if (!hopper::bf16_map(&dw_x, x, cin, rows, cin, 64, kStepRows) ||
      !hopper::b32_map(&dw_sel, asel, C, groups, C, kDwCols, dw_ng) ||
      !hopper::b32_map(&dw_dps, dpsel, C, groups, C, kDwCols, dw_ng))
    return kBadArgs;
  const void* dw_kernel = reinterpret_cast<const void*>(&dw_wgmma_kernel<CP>);
  const int dw_smem = dw_smem_bytes<CP>(za.pool);
  err = cudaFuncSetAttribute(dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dw_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = static_cast<int>((rows + dw_chunk_rows - 1) / dw_chunk_rows);
  dw_wgmma_kernel<CP><<<dim3((C + kDwCols - 1) / kDwCols, chunks), kWgThreads, dw_smem, s>>>(
      dw_x, map_w, dw_sel, dw_dps, za, dw_part, db_part, rows, cin, dw_chunk_rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  colsum_kernel<<<blocks_for(static_cast<int64_t>(cin) * C), kThreads, 0, s>>>(
      dw_part, dw, chunks, static_cast<int64_t>(cin) * C);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  colsum_kernel<<<blocks_for(C), kThreads, 0, s>>>(db_part, db, chunks, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  return 0;
}

}  // namespace

// Plain C entry points for ctypes. Device pointers of contiguous tensors;
// is_bf16 picks T (bf16 when 1, fp32 when 0). stats (2, C) fp32 receives
// ssum then ssq; part (ceil(rows / chunk_rows), 2, C) fp32 is scratch. Each
// returns the CUDA error of its launches (0 on success;
// cudaErrorInvalidValue for a geometry its route does not take); the caller
// checked shapes and bounds.
// The forward. route 0 (tile): T from is_bf16, blocks of chunk_rows rows,
// keys (rows / pool * C) uint64 scratch. route 1 (TMA + wgmma, bf16 only):
// Cin <= 128 and C multiples of 8, cin_pad = 64 for Cin <= 64 else 128, a
// pool of 16 or 32 rows or a multiple of 64, chunk_rows a multiple of 64 and
// of the pool, x and w 16-byte aligned (ops/dense_bn_pool.py pool_fwd_plan);
// keys unused.
extern "C" int dense_pool_stats_fwd_launch(
    const void* x, const void* w, const void* bias, const float* sign,
    const float* pen, void* psel, int* asel, float* stats, void* keys,
    float* part, long long rows, int cin, int c, int pool, int chunk_rows,
    int route, int cin_pad, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows < 1 || cin < 1 || c < 1 || pool < 1) return kBadArgs;
  if (route == 1) {
    if (!is_bf16 || cin % 8 != 0 || c % 8 != 0 || cin > 128 ||
        cin_pad != (cin <= 64 ? 64 : 128))
      return kBadArgs;
    const auto* xb = static_cast<const bf16*>(x);
    const auto* wb = static_cast<const bf16*>(w);
    const auto* bb = static_cast<const bf16*>(bias);
    auto* pb = static_cast<bf16*>(psel);
    return cin_pad == 64 ? forward_wgmma<64>(xb, wb, bb, sign, pen, pb, asel, stats, part, rows,
                                             cin, c, pool, chunk_rows, s)
                         : forward_wgmma<128>(xb, wb, bb, sign, pen, pb, asel, stats, part,
                                              rows, cin, c, pool, chunk_rows, s);
  }
  if (route != 0 || chunk_rows < 1) return kBadArgs;
  auto* k = static_cast<unsigned long long*>(keys);
  if (is_bf16) {
    return forward<bf16>(static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                         static_cast<const bf16*>(bias), sign, pen,
                         static_cast<bf16*>(psel), asel, stats, k, part, rows,
                         cin, c, pool, chunk_rows, s);
  }
  return forward<float>(static_cast<const float*>(x), static_cast<const float*>(w),
                        static_cast<const float*>(bias), sign, pen,
                        static_cast<float*>(psel), asel, stats, k, part, rows,
                        cin, c, pool, chunk_rows, s);
}

// The backward. route 0 (tile): T from is_bf16, dw partials over chunks of
// dw_chunk_rows rows (a multiple of 32). route 1 (TMA + wgmma, bf16 only):
// Cin <= 128 and C multiples of 8, cin_pad = 64 for Cin <= 64 else 128,
// dx_chunk_rows a multiple of 128 and dw_chunk_rows of 64, x and w 16-byte
// aligned, asel and dpsel 16-byte aligned, shared memory within the card's
// at this pool (ops/dense_bn_pool.py pool_bwd_plan). Scratch: dw_part (ceil(rows /
// dw_chunk_rows), Cin, C) and db_part (that many, C) fp32.
extern "C" int dense_pool_stats_bwd_launch(
    const void* x, const void* w, const void* bias, const float* sign,
    const int* asel, const float* dpsel, const float* dssum, const float* dssq,
    void* dx, float* dw, float* db, float* dw_part, float* db_part,
    long long rows, int cin, int c, int pool, int route, int cin_pad,
    int dx_chunk_rows, int dw_chunk_rows, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows < 1 || cin < 1 || c < 1 || pool < 1) return kBadArgs;
  if (route == 1) {
    if (!is_bf16 || cin % 8 != 0 || c % 8 != 0 || cin > 128 ||
        cin_pad != (cin <= 64 ? 64 : 128))
      return kBadArgs;
    const DzArgs za{static_cast<const bf16*>(bias), sign, dssum, dssq, c, pool};
    const auto* xb = static_cast<const bf16*>(x);
    const auto* wb = static_cast<const bf16*>(w);
    auto* dxb = static_cast<bf16*>(dx);
    return cin_pad == 64
               ? backward_wgmma<64>(xb, wb, asel, dpsel, za, dxb, dw, db, dw_part, db_part,
                                    rows, cin, dx_chunk_rows, dw_chunk_rows, s)
               : backward_wgmma<128>(xb, wb, asel, dpsel, za, dxb, dw, db, dw_part,
                                     db_part, rows, cin, dx_chunk_rows, dw_chunk_rows, s);
  }
  if (route != 0 || dw_chunk_rows < 1 || dw_chunk_rows % KC != 0) return kBadArgs;
  if (is_bf16) {
    return backward<bf16>(static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                          static_cast<const bf16*>(bias), sign, asel, dpsel,
                          dssum, dssq, static_cast<bf16*>(dx), dw, db, dw_part,
                          db_part, rows, cin, c, pool, dw_chunk_rows, s);
  }
  return backward<float>(static_cast<const float*>(x), static_cast<const float*>(w),
                         static_cast<const float*>(bias), sign, asel, dpsel,
                         dssum, dssq, static_cast<float*>(dx), dw, db, dw_part,
                         db_part, rows, cin, c, pool, dw_chunk_rows, s);
}
