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
// and w and consumed in shared memory.
//
// Design. Every product runs on one 64 x 128 output tile per block of 256
// threads (tile_mma.cuh), staged through shared memory in depth chunks of
// 32: bf16 operands go through the tensor cores with nvcuda::wmma 16x16x16
// tiles and fp32 accumulators; fp32 operands run on the CUDA cores (4 x 8
// outputs a thread), so fp32 stays fp32 (no TF32).
//   forward  (launch 1): a block owns 128 channels and a chunk of 512 rows.
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
//   backward (launch 1): a block owns 64 rows and 128 input channels. For
//            each 128-channel tile of C it recomputes z, forms dz in shared
//            memory and accumulates dx += dz @ w^T in registers.
//   (launch 2): a block owns 128 channels of C, 128 of Cin and a chunk of
//            rows: it recomputes z and dz per 64-row tile and accumulates
//            dw += x^T @ dz in registers, and the column sums of dz for db;
//            it writes per-chunk partials.
//   (launches 3-4) sum the dw and db partials over the chunks in a fixed
//            order. No fp32 atomics anywhere: the same inputs give the same
//            bits on every run.
// The TPU kernels run one grid step per batch block, carrying the sums and
// dw from step to step in VMEM; CUDA blocks run in parallel with no carry,
// hence the partials and the second passes.
//
// Bound on the card: operations. The forward is one product, 2 rows Cin C
// operations (1.37e11 at rows = 256 x 2048, Cin 128, C 1024: 0.139 ms at the
// dense bf16 tensor-core rate of 989 TFLOP/s); its bytes (x once, w, the
// pooled outputs) take 0.040 ms at 3.35 TB/s. The backward needs three such
// products (z, dx, dw): 0.417 ms. This design recomputes z twice in the
// backward (four products). Pipelined loads (cp.async / TMA) and wgmma are
// left to a later change.

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
  cudaError_t err = set_smem<T>(reinterpret_cast<const void*>(&bwd_dx_kernel<T>));
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
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. Device pointers of contiguous tensors;
// is_bf16 picks T (bf16 when 1, fp32 when 0). Forward scratch: keys
// (rows / pool * C) uint64 and part (n_chunks, 2, C) fp32; stats (2, C) fp32
// receives ssum then ssq. Backward scratch: dw_part (n_chunks, Cin, C) and
// db_part (n_chunks, C) fp32. Each returns the CUDA error of its launches
// (0 on success); the caller checked shapes and bounds.
extern "C" int dense_pool_stats_fwd_launch(
    const void* x, const void* w, const void* bias, const float* sign,
    const float* pen, void* psel, int* asel, float* stats, void* keys,
    float* part, long long rows, int cin, int c, int pool, int chunk_rows,
    int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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

extern "C" int dense_pool_stats_bwd_launch(
    const void* x, const void* w, const void* bias, const float* sign,
    const int* asel, const float* dpsel, const float* dssum, const float* dssq,
    void* dx, float* dw, float* db, float* dw_part, float* db_part,
    long long rows, int cin, int c, int pool, int chunk_rows, int is_bf16,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return backward<bf16>(static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                          static_cast<const bf16*>(bias), sign, asel, dpsel,
                          dssum, dssq, static_cast<bf16*>(dx), dw, db, dw_part,
                          db_part, rows, cin, c, pool, chunk_rows, s);
  }
  return backward<float>(static_cast<const float*>(x), static_cast<const float*>(w),
                         static_cast<const float*>(bias), sign, asel, dpsel,
                         dssum, dssq, static_cast<float*>(dx), dw, db, dw_part,
                         db_part, rows, cin, c, pool, chunk_rows, s);
}
