// The fused Dense -> BatchNorm -> ReLU chain with a group max-pool, forward
// and backward, for sm_90a: the PointNet++ set-abstraction body (plain
// chain, masked pool) and PointMLP's PreExtraction (residual chain).
//
// Replaces the four Pallas kernels of pointcloud_tpu/ops/preextract_fused.py
// in both of their modes (mlp_pool_fused and preextract_pool_fused):
//   _mm_stats_kernel        -> fwd_wgmma_kernel<WN, false, kResNone> (bf16),
//                              mm_stats_kernel<T, false, kResNone>
//   _bnact_mm_stats_kernel  -> fwd_wgmma_kernel<WN, true, RES> (bf16),
//                              mm_stats_kernel<T, true, RES> (+ write_r)
//   _bn_respool_kernel      -> bn_pool_kernel<T, RES, V>
//   _bwd_pass_kernel        -> one pass: bwd_dh_kernel, then bwd_da and bwd_dw
//                              (bf16: *_wgmma_kernel; fp32: *_f32_kernel);
//                              res_mode, skip_pool, skip_dense
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
//            below a BatchNorm: da += the skip shares of a block's input (the
//            pooled cotangent's `dosel` at its rows, skip_pool; a stored dz,
//            skip_dense), in that order; dz_{u-1} = T(da 1[pre_{u-1} > 0])
//            with pre_{u-1} including its residual, the column sums
//            Sd = sum dz_{u-1}, Se = sum dz_{u-1} zhat_{u-1} of the rounded
//            values, and a_up = T(relu(pre_{u-1})); at the input layer
//            dx = T(da) and a_up = x; dw_u = a_up^T @ dh.
// pre is formed with separately rounded operations (__fsub_rn, __fmul_rn,
// __fadd_rn, then __fadd_rn of the residual), da's shares with __fadd_rn, dh
// too, so that they equal the plain PyTorch version's bits and the ReLU masks
// and bf16 roundings of the two agree.
//
// Design, forward. The TPU kernels walk the batch in a sequential grid and
// carry the sums and dw in VMEM from step to step; CUDA blocks run in
// parallel with no carry. bf16 products (every driven path) run on
// fwd_wgmma_kernel (its note below): a resident panel of activated rows,
// each input element read and activated once, w streamed by TMA to two
// consumer warpgroups on wgmma, a statistics epilogue and a TMA store of h;
// ops/preextract_fused.py fwd_plan sizes it. Widths it does not take (cu,
// or cd below a BatchNorm, no multiple of 8: TMA wants 16-byte rows) and
// fp32 (only the card-vs-CPU checks) run on the 64 x 128 tiles of
// tile_mma.cuh (bf16: wmma tensor-core tiles with fp32 accumulators; fp32:
// CUDA cores), staged through shared memory in depth chunks of 32 with zero
// padding. There the prologue (BatchNorm + residual + ReLU) is applied
// while an operand tile is staged, the epilogue (rounding, statistics)
// while the accumulator tile sits in shared memory; a thread stages one
// channel of a tile and keeps that channel's scalars (and the residual's)
// in registers; bound by memory latency, they are held to 80 registers
// (three blocks an SM).
//   mm_stats (tiles): a block owns 128 output channels and a chunk of rows;
//            per 64-row tile it forms the product, rounds, stores h and
//            adds to per-thread column sums; per-chunk partials, then
//            colsum_kernel sums them in a fixed order (32 strided lanes per
//            column, then the 32 lanes in order). With r_out the blocks of
//            the first column tile store `a` as they stage it (every column
//            tile stages the same values).
//   bn_pool: no product; bound by bytes. A thread owns 8 channels of one
//            group (16-byte loads and stores) over a slice of its rows, a few
//            rows in flight, and the slices merge in a fixed order with the
//            lowest row winning ties (its note at bn_pool_kernel).
// Design, backward: three launches, each tensor formed once.
//   bwd_dh:  elementwise; dh goes to a scratch (rows, ldh) in T (ldh = cu
//            rounded up to 8). A thread owns 8 channels (16-byte loads and
//            stores, neighbouring threads on neighbouring strips) over a run
//            of rows: at the pooled layer one group, whose dosel and amax it
//            reads once; a group of K = 24 rows then needs no division.
//   bwd_da:  da = dh @ w^T, M = rows, N = cd, K = cu. bf16: a producer
//            warpgroup whose one thread issues TMA loads (128-byte swizzle)
//            of the dh and w tiles into a ring of 4 stages with full / empty
//            mbarriers; two consumer warpgroups issue wgmma m64n128k16 on
//            them (both operands K-major), fp32 accumulators in registers,
//            one group in flight while the next stage arrives. A block owns
//            128 input channels and a chunk of 128-row tiles; the consumers
//            take the tiles in turn (ping-pong, their product loops ordered
//            by two more mbarriers), so one's epilogue runs while the other's
//            products do. The epilogue (a tile's accumulators through shared
//            memory, 8 channels of a row a thread, 16-byte accesses, 8 rows'
//            loads in flight) forms dzd, the sums and a_up = T(relu(pre))
//            once; the pooled skip share is added to the accumulator tile
//            by (group, channel), its loads issued before the products. The
//            producer gives its registers to the consumers (setmaxnreg: 40
//            and 232), which hold two 64-row accumulators and the loads.
//   bwd_dw:  dw^T = dh^T @ a_up, M = cu, N = cd (tiles of 128, or 192 from
//            cd = 512: fewer re-reads of dh), K = rows: the same ring and
//            roles, both operands MN-major (wgmma's transpose bits; TMA boxes
//            of 64 rows x 64 channels), split over chunks of rows into
//            per-chunk partials that colsum_kernel adds in a fixed order. The
//            tensor cores' fp32 sums are not rounded to nearest, so a chain of
//            thousands of wgmma adds drifts (a 1.5e-3 relative dw error over
//            16K rows of PointNet2's SA1): each 4 stages (256 rows) are summed
//            by the tensor cores, then added into fp32 registers.
//   Launch geometry (ops/preextract_fused.py bwd_plan): one block resident an
//            SM, chunk counts that fill whole waves.
//   Ragged widths: TMA wants 16-byte row strides. dh and a_up are written
//            with rows padded to 8 channels, and the wrapper hands a padded
//            copy of the chain's input (cd of 6, 131, 259, 643, 2C + 3) to
//            bwd_dw and of w to bwd_da where cu is no multiple of 8; the maps
//            declare the true widths, so the pad is never read (boxes past
//            the edge fill with zeros). dzd is written unpadded; rows of a
//            ragged width take the epilogue's one-channel path.
//   fp32 reaches the backward only in the card-vs-CPU checks: the same dh
//            and a_up, then CUDA-core tiles (Mma<float>; no TF32) for da and
//            dw, as the forward's.
// Switches. The residual mode RES is a template argument: it adds loads to
// the staging loop of mm_stats and to da's epilogue. r_out, pen, skip_pool
// and skip_dense are run-time pointers (NULL when absent): each adds one
// uniform branch and one access per element outside the product's inner
// loop, and as templates they would multiply the instantiations. The chain
// never puts a residual below its sparse top layer or the input layer, so
// bwd_da instantiates RES only below a BatchNorm. No fp32 atomics anywhere:
// the same inputs give the same bits on every run.
//
// Bound on the card. Forward: bytes. At the set-abstraction shapes (4.2M
// rows of 64..128 channels, 2.1M of 128..256) and PointMLP's (786K rows of
// 128 channels at its first stage) a layer's product is 2 rows cd cu
// operations, a few tenths of a millisecond at 989 TFLOP/s dense bf16, while
// reading and writing the (rows, C) tensors once takes 0.1 to 0.5 ms at 3.35
// TB/s; at stage 4's 1024-wide layers operations (0.21 ms a pass), and w,
// re-read from L2 once a 64-row panel, 2 MB each time. Backward: bytes at PointNet2's levels and PointMLP's stages 1-2
// (dh's pass reads h_u and dz and writes dh; da reads dh, h_{u-1} and the
// residual and writes dzd and a_up; dw reads a_up and dh: ~8 (rows, C)
// tensors), operations at stage 4's 1024-wide layers (4 rows cd cu, 0.42 ms
// a pass at the dense bf16 rate). The design moves each tensor the least
// number of times the three products allow and keeps the tensor cores fed
// from a TMA ring; the forward reads each input once and w once a panel.

#include <type_traits>

#include "hopper.cuh"
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

// A channel's BatchNorm scalars (sc rows mean, mul, beta), loaded once per
// thread and staged chunk.
struct Sc3 {
  float mean, mul, beta;
  __device__ __forceinline__ Sc3(const float* __restrict__ sc, int ch, int width,
                                 bool ok) {
    mean = ok ? sc[ch] : 0.f;
    mul = ok ? sc[width + ch] : 0.f;
    beta = ok ? sc[2 * width + ch] : 0.f;
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

// The pool pass (ops/preextract_fused.py bn_pool_plan sizes it). A thread
// owns V consecutive channels of one group (V = 8: one 16-byte load a row in
// bf16, two in fp32; V = 1 where the width is no multiple of 8 or a base is
// not 16-byte aligned) over a slice of the group's rows: rows y, y + slices,
// .. (neighbouring slices on neighbouring rows, so a warp's loads stay
// contiguous). kPoolFly rows' loads are in flight before their compares; a
// row's pen is read once for the thread's V channels. Within a slice the
// rows come in order and a strict > keeps the lowest; the slices of a group
// then merge through shared memory in slice order, taking the other slice's
// (value, row) on a larger value or an equal value at a lower row, so the
// result is the first-occurrence argmax whatever the split. The outputs
// leave in 16-byte stores. A block is strips x slices x per_block threads:
// `strips` neighbouring V-channel strips of `per_block` groups.
constexpr int kPoolThreads = 256;
constexpr int kPoolFly = 4;  // rows in flight a thread

template <typename T, int V>
// 16-byte words of V elements (1 for V = 1)
__host__ __device__ constexpr int pool_words() {
  return V == 8 ? V * static_cast<int>(sizeof(T)) / 16 : 1;
}

__device__ __forceinline__ uint32_t word_of(const uint4& u, int k) {
  return k == 0 ? u.x : k == 1 ? u.y : k == 2 ? u.z : u.w;
}

// V elements of T at p into w (V = 1: the element's bits in w[0].x).
template <typename T, int V>
__device__ __forceinline__ void load_chunk(uint4 (&w)[pool_words<T, V>()], const T* p) {
  if constexpr (V == 8) {
#pragma unroll
    for (int k = 0; k < pool_words<T, V>(); ++k) w[k] = reinterpret_cast<const uint4*>(p)[k];
  } else if constexpr (sizeof(T) == 2) {
    w[0].x = *reinterpret_cast<const unsigned short*>(p);
  } else {
    w[0].x = *reinterpret_cast<const uint32_t*>(p);
  }
}

// Element i of a loaded chunk, in fp32 (bf16 widens exactly).
template <typename T>
__device__ __forceinline__ float chunk_elem(const uint4* w, int i) {
  if constexpr (sizeof(T) == 2) {
    const uint32_t u = word_of(w[i >> 3], (i >> 1) & 3);
    return __uint_as_float((i & 1) ? (u & 0xffff0000u) : (u << 16));
  } else {
    return __uint_as_float(word_of(w[i >> 2], i & 3));
  }
}

template <typename T>
__device__ __forceinline__ uint32_t out_bits(float v) {
  if constexpr (sizeof(T) == 2) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  } else {
    return __float_as_uint(v);
  }
}

// V values of type T (bits from out_bits) or fp32 / int32 (raw words) to p.
template <int V, int kBytes>
__device__ __forceinline__ void store_chunk(void* p, const uint32_t (&bits)[V]) {
  if constexpr (V == 1) {
    if constexpr (kBytes == 2) {
      *static_cast<unsigned short*>(p) = static_cast<unsigned short>(bits[0]);
    } else {
      *static_cast<uint32_t*>(p) = bits[0];
    }
  } else if constexpr (kBytes == 2) {
    *static_cast<uint4*>(p) = make_uint4(bits[0] | bits[1] << 16, bits[2] | bits[3] << 16,
                                         bits[4] | bits[5] << 16, bits[6] | bits[7] << 16);
  } else {
    uint4* q = static_cast<uint4*>(p);
    q[0] = make_uint4(bits[0], bits[1], bits[2], bits[3]);
    q[1] = make_uint4(bits[4], bits[5], bits[6], bits[7]);
  }
}

template <typename T, int RES, int V>
__global__ void __launch_bounds__(kPoolThreads) bn_pool_kernel(
    const T* __restrict__ h, const float* __restrict__ sc,
    const T* __restrict__ res_src, const float* __restrict__ res_sc,
    const float* __restrict__ pen, T* __restrict__ out, float* __restrict__ maxv,
    int* __restrict__ amax, float* __restrict__ hsel, int64_t groups, int C,
    int pool, int final_relu, int strips, int slices, int per_block) {
  constexpr int kW = pool_words<T, V>();
  __shared__ float s_v[kPoolThreads * V];
  __shared__ int s_i[kPoolThreads * V];
  __shared__ float s_h[kPoolThreads * V];
  const int x = threadIdx.x % strips;
  const int y = threadIdx.x / strips % slices;
  const int z = threadIdx.x / (strips * slices);
  const int64_t g = static_cast<int64_t>(blockIdx.x) * per_block + z;
  const int c0 = (blockIdx.y * strips + x) * V;
  const bool on = z < per_block && g < groups && c0 < C;
  float best[V], best_h[V];
  int best_i[V];
  if (on) {
    float mean[V], mul[V], beta[V], rmean[V], rmul[V], rbeta[V];
#pragma unroll
    for (int c = 0; c < V; ++c) {
      mean[c] = sc[c0 + c];
      mul[c] = sc[C + c0 + c];
      beta[c] = sc[2 * C + c0 + c];
      if constexpr (RES == kResBnRelu) {
        rmean[c] = res_sc[c0 + c];
        rmul[c] = res_sc[C + c0 + c];
        rbeta[c] = res_sc[2 * C + c0 + c];
      }
    }
    const int64_t row0 = g * pool;
    for (int i = y; i < pool; i += slices * kPoolFly) {
      uint4 hw[kPoolFly][kW], rw[kPoolFly][kW];
      float pv[kPoolFly];
#pragma unroll
      for (int u = 0; u < kPoolFly; ++u) {
        const int r = i + u * slices;
        if (r < pool) {
          const int64_t e = (row0 + r) * C + c0;
          load_chunk<T, V>(hw[u], h + e);
          if constexpr (RES != kResNone) load_chunk<T, V>(rw[u], res_src + e);
          pv[u] = pen != nullptr ? pen[row0 + r] : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kPoolFly; ++u) {
        const int r = i + u * slices;
        if (r >= pool) break;
#pragma unroll
        for (int c = 0; c < V; ++c) {
          const float hv = chunk_elem<T>(hw[u], c);
          float v = bn_pre(hv, mean[c], mul[c], beta[c]);
          if constexpr (RES == kResBnRelu) {
            const float rv = bn_pre(chunk_elem<T>(rw[u], c), rmean[c], rmul[c], rbeta[c]);
            v = __fadd_rn(v, fmaxf(rv, 0.f));
          } else if constexpr (RES == kResDense) {
            v = __fadd_rn(v, chunk_elem<T>(rw[u], c));
          }
          if (pen != nullptr) v = __fsub_rn(v, pv[u]);
          if (r == y || v > best[c]) {
            best[c] = v;
            best_i[c] = r;
            best_h[c] = hv;
          }
        }
      }
    }
  }
  if (slices > 1) {  // block-uniform
    if (on) {
#pragma unroll
      for (int c = 0; c < V; ++c) {
        s_v[threadIdx.x * V + c] = best[c];
        s_i[threadIdx.x * V + c] = best_i[c];
        s_h[threadIdx.x * V + c] = best_h[c];
      }
    }
    __syncthreads();
    if (on && y == 0) {
      for (int s = 1; s < slices && s < pool; ++s) {
        const int o = (threadIdx.x + s * strips) * V;
#pragma unroll
        for (int c = 0; c < V; ++c) {
          const float ov = s_v[o + c];
          const int oi = s_i[o + c];
          if (ov > best[c] || (ov == best[c] && oi < best_i[c])) {
            best[c] = ov;
            best_i[c] = oi;
            best_h[c] = s_h[o + c];
          }
        }
      }
    }
  }
  if (!on || y != 0) return;
  uint32_t ob[V], mb[V], ib[V], hb[V];
#pragma unroll
  for (int c = 0; c < V; ++c) {
    float o = final_relu ? fmaxf(best[c], 0.f) : best[c];
    if (pen != nullptr && best[c] < -5e8f) o = -1e9f;  // no valid row in the group
    ob[c] = out_bits<T>(o);
    mb[c] = __float_as_uint(best[c]);
    ib[c] = static_cast<uint32_t>(best_i[c]);
    hb[c] = __float_as_uint(best_h[c]);
  }
  const int64_t e = g * C + c0;
  store_chunk<V, static_cast<int>(sizeof(T))>(out + e, ob);
  store_chunk<V, 4>(maxv + e, mb);
  store_chunk<V, 4>(amax + e, ib);
  store_chunk<V, 4>(hsel + e, hb);
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

constexpr int kStrip = 8;      // channels a thread owns in the elementwise parts
constexpr int kDenseRun = 16;  // rows a dh thread walks with a dense dz

// 8 consecutive values at p as fp32 (p 16-byte aligned for bf16, 32 for fp32
// and int32).
__device__ __forceinline__ uint4 ldg16(const bf16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}
__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void load8(const bf16* p, float (&f)[8]) {
  unpack8(ldg16(p), f);
}
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}
__device__ __forceinline__ void load8(const int* p, int (&f)[8]) {
  const int4 a = __ldg(reinterpret_cast<const int4*>(p));
  const int4 b = __ldg(reinterpret_cast<const int4*>(p) + 1);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}
// p[i] = T(f[i]), i < 8, rounded to nearest even
__device__ __forceinline__ void store8(bf16* p, const float (&f)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void store8(float* p, const float (&f)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// The n (1..8) channels of a strip at p, zero beyond n: one vector access when
// the strip is whole and its rows aligned (vec: the row width is a multiple of
// 8), else one access a channel.
template <typename E, typename V>
__device__ __forceinline__ void load_strip(const E* p, int n, bool vec, V (&f)[8]) {
  if (vec && n == kStrip) {
    load8(p, f);
    return;
  }
#pragma unroll
  for (int i = 0; i < kStrip; ++i) {
    if constexpr (sizeof(E) == 2) {
      f[i] = i < n ? Ty<bf16>::to_f(p[i]) : 0.f;
    } else {
      f[i] = i < n ? p[i] : V(0);
    }
  }
}
template <typename T>
__device__ __forceinline__ void store_strip(T* p, int n, bool vec,
                                            const float (&f)[8]) {
  if (vec && n == kStrip) {
    store8(p, f);
    return;
  }
#pragma unroll
  for (int i = 0; i < kStrip; ++i)
    if (i < n) p[i] = Ty<T>::from_f(f[i]);
}

// v rounded to T and back
template <typename T>
__device__ __forceinline__ float round_t(float v) {
  return Ty<T>::to_f(Ty<T>::from_f(v));
}

// dh (rows, ldh) = T(c1 dz - c4 - c3 (h_u - mu)) for the cu channels of every
// row; the ldh - cu pad channels get 0. A thread owns a strip of 8 channels
// over a run of rows: SPARSE, one group of `run` = pool rows, whose dosel and
// amax it reads once (dz is dosel at row amax, 0 elsewhere: a row's place in
// its group is its step in the walk, so a group straddling any tile needs no
// division); dense, kDenseRun rows of dz.
template <typename T, bool SPARSE>
__global__ void __launch_bounds__(kThreads) bwd_dh_kernel(
    const T* __restrict__ hu, const T* __restrict__ dz,
    const float* __restrict__ dosel, const int* __restrict__ amax,
    const float* __restrict__ uc, T* __restrict__ dh, int64_t rows, int cu,
    int ldh, int run) {
  const int strips = ldh / kStrip;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t runs = (rows + run - 1) / run;
  if (e >= runs * strips) return;
  const int64_t q = e / strips;
  const int c0 = static_cast<int>(e - q * strips) * kStrip;
  const int n = min(kStrip, cu - c0);
  const bool vec = cu % kStrip == 0;
  float c1[8], c4[8], c3[8], mu[8], sel[8];
  int am[8];
  load_strip(uc + c0, n, vec, c1);
  load_strip(uc + cu + c0, n, vec, c4);
  load_strip(uc + 2 * cu + c0, n, vec, c3);
  load_strip(uc + 3 * cu + c0, n, vec, mu);
  if constexpr (SPARSE) {
    load_strip(dosel + q * cu + c0, n, vec, sel);
    load_strip(amax + q * cu + c0, n, vec, am);
  }
  const int64_t r0 = q * run;
  const int len = static_cast<int>(rows - r0 < run ? rows - r0 : run);
#pragma unroll 4
  for (int i = 0; i < len; ++i) {
    const int64_t row = r0 + i;
    float h[8], d[8], o[8];
    load_strip(hu + row * cu + c0, n, vec, h);
    if constexpr (SPARSE) {
#pragma unroll
      for (int j = 0; j < kStrip; ++j) d[j] = am[j] == i ? sel[j] : 0.f;
    } else {
      load_strip(dz + row * cu + c0, n, vec, d);
    }
#pragma unroll
    for (int j = 0; j < kStrip; ++j) {
      o[j] = __fsub_rn(__fsub_rn(__fmul_rn(c1[j], d[j]), c4[j]),
                       __fmul_rn(c3[j], __fsub_rn(h[j], mu[j])));
    }
    store8(dh + row * ldh + c0, o);
  }
}

// The da epilogue of one row's W channels ch0.. (n <= W of them inside cd;
// W = 8, a strip, in the bf16 kernel, 1 in the fp32 one), da in `a`: below a
// BatchNorm (DOWN_BN) the skip shares join da (pool share, then dense), dzd =
// T(da 1[pre > 0]) with pre = BN(hd) [+ residual], a_up = T(relu(pre)) (dw's
// operand), and the channels' sums Sd, Se of the rounded dzd grow; at the
// input layer dzd = T(da). sc: the channels' scalars (rows mean, mul, beta,
// rsig, then the residual's mean, mul, beta; STRIDE floats apart).
template <typename T, bool DOWN_BN, int RES>
struct DaEpilogue {
  const T* hd;
  const T* res_src;
  const float* skip_dosel;
  const int* skip_amax;
  const T* skip_dz;
  T* dzd;
  T* a_up;
  int lda, cd, pool;

  template <int W, int STRIDE>
  __device__ __forceinline__ void row(int64_t row, int ch0, int n, bool vec,
                                      float (&a)[8], const float* sc,
                                      float (&sd)[8], float (&se)[8]) const {
    const int64_t at = row * cd + ch0;
    if constexpr (!DOWN_BN) {
      store_strip(dzd + at, n, vec, a);
    } else {
      float hv[8], rv[8], sk[8];
      load_strip(hd + at, n, vec, hv);
      if constexpr (RES != kResNone) load_strip(res_src + at, n, vec, rv);
      if (skip_dosel != nullptr) {
        const int64_t g = row / pool;
        const int within = static_cast<int>(row - g * pool);
        float sel[8];
        int am[8];
        load_strip(skip_dosel + g * cd + ch0, n, vec, sel);
        load_strip(skip_amax + g * cd + ch0, n, vec, am);
#pragma unroll
        for (int j = 0; j < W; ++j)
          a[j] = __fadd_rn(a[j], am[j] == within ? sel[j] : 0.f);
      }
      if (skip_dz != nullptr) {
        load_strip(skip_dz + at, n, vec, sk);
#pragma unroll
        for (int j = 0; j < W; ++j) a[j] = __fadd_rn(a[j], sk[j]);
      }
      float dv[8], av[8];
      finish<W, STRIDE>(n, a, hv, rv, sc, sc + 4 * STRIDE, dv, av, sd, se);
      store_strip(dzd + at, n, vec, dv);
      if constexpr (W == kStrip) {
        store8(a_up + row * lda + ch0, av);  // lda: a multiple of 8; the pad gets 0
      } else {
        store_strip(a_up + row * lda + ch0, n, false, av);
      }
    }
  }

  // Below a BatchNorm, from da (its skip shares added), h_{u-1} and the
  // residual's value: dv = dzd, av = a_up, and the sums of the n channels.
  // sc: the BatchNorm's rows mean, mul, beta, rsig, STRIDE floats apart (the
  // caller's registers where it can: `rs` the residual's mean, mul, beta).
  template <int W, int STRIDE>
  static __device__ __forceinline__ void finish(int n, const float (&a)[8],
                                                const float (&hv)[8],
                                                const float (&rv)[8], const float* sc,
                                                const float* rs, float (&dv)[8],
                                                float (&av)[8], float (&sd)[8],
                                                float (&se)[8]) {
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const float hc = __fsub_rn(hv[j], sc[j]);  // h - mean, as bn_pre rounds it
      float pre = __fadd_rn(__fmul_rn(hc, sc[STRIDE + j]), sc[2 * STRIDE + j]);
      if constexpr (RES == kResBnRelu) {
        const float r = bn_pre(rv[j], rs[j], rs[STRIDE + j], rs[2 * STRIDE + j]);
        pre = __fadd_rn(pre, fmaxf(r, 0.f));
      } else if constexpr (RES == kResDense) {
        pre = __fadd_rn(pre, rv[j]);
      }
      dv[j] = round_t<T>(pre > 0.f ? a[j] : 0.f);
      av[j] = pre > 0.f ? pre : 0.f;
      const float ds = j < n ? dv[j] : 0.f;  // channels past n add nothing
      sd[j] += ds;
      se[j] += ds * (hc * sc[3 * STRIDE + j]);
    }
  }
};

// ---- bf16: TMA + wgmma ----
//
// A block is one producer warpgroup (a single thread issues the TMA loads)
// and two consumer warpgroups that issue wgmma on the tiles that have
// arrived, through a ring of kStages shared-memory stages with a full and an
// empty mbarrier each. Its tiles walk a chunk of rows.

constexpr int kStages = 4;
constexpr int kWg = 128;                // threads of a warpgroup
constexpr int kTmaThreads = 3 * kWg;    // producer + 2 consumers
constexpr int kBT = 128;                // tile rows and channels
constexpr int kBK = 64;                 // depth of a stage: 128 bytes of bf16
constexpr int kZ = kBT + 8;             // epilogue tile stride (floats)
constexpr int kAtom = 64 * kBK;         // an MN-major 64 x 64 atom (elements)
constexpr int kPromote = 4;             // dw stages a tensor-core sum spans

// The bf16 epilogue below a BatchNorm of 64 rows whose da sits in z (stride
// kZ) and whose rows are whole 8-channel strips: thread (cg, ro) takes rows
// ro, ro + 8, .. in batches of BATCH, every load of a batch (h_{u-1}, the
// residual, the dense skip share with SKIP_DZ) issued before its stores. bn:
// the strip's BatchNorm scalars in registers (rows mean, mul, beta, rsig of 8).
template <int BATCH, int RES, bool SKIP_DZ>
__device__ __forceinline__ void bn_rows(const DaEpilogue<bf16, true, RES>& ep,
                                        const float* z, int kz, int64_t base,
                                        int64_t top, int64_t r_begin, int ro, int cg,
                                        int ch0, const float (&bn)[32],
                                        const float* res_sc, float (&sd)[8],
                                        float (&se)[8]) {
  const int cd = ep.cd;
  // the residual's scalars of the strip, in registers for the call (res_sc:
  // its rows mean, mul, beta, kBT-float rows in shared memory)
  float rs[24];
  if constexpr (RES == kResBnRelu) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int j = 0; j < kStrip; ++j) rs[k * 8 + j] = res_sc[k * kBT + j];
  }
#pragma unroll 1
  for (int b0 = 0; b0 < 8; b0 += BATCH) {
    uint4 hw[BATCH], rw[BATCH], kw[BATCH];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int64_t row = base + ro + 8 * (b0 + i);
      // rows past the chunk load a row that exists and store nothing
      const int64_t at = (row < top ? row : r_begin) * cd + ch0;
      hw[i] = ldg16(ep.hd + at);
      if constexpr (RES != kResNone) rw[i] = ldg16(ep.res_src + at);
      if constexpr (SKIP_DZ) kw[i] = ldg16(ep.skip_dz + at);
    }
    // branch-free over the batch, so that its rows' arithmetic interleaves:
    // a row past the chunk adds 0 to the sums and stores nothing
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int lr = ro + 8 * (b0 + i);
      const int64_t row = base + lr;
      const float4 z0 = *reinterpret_cast<const float4*>(z + lr * kz + cg * kStrip);
      const float4 z1 = *reinterpret_cast<const float4*>(z + lr * kz + cg * kStrip + 4);
      float a[8] = {z0.x, z0.y, z0.z, z0.w, z1.x, z1.y, z1.z, z1.w};
      float hv[8], rv[8], dv[8], av[8];
      unpack8(hw[i], hv);
      if constexpr (RES != kResNone) unpack8(rw[i], rv);
      if constexpr (SKIP_DZ) {
        float sk[8];
        unpack8(kw[i], sk);
#pragma unroll
        for (int j = 0; j < kStrip; ++j) a[j] = __fadd_rn(a[j], sk[j]);
      }
      DaEpilogue<bf16, true, RES>::template finish<kStrip, 8>(row < top ? kStrip : 0, a,
                                                              hv, rv, bn, rs, dv, av,
                                                              sd, se);
      if (row < top) {
        store8(ep.dzd + row * cd + ch0, dv);
        store8(ep.a_up + row * ep.lda + ch0, av);
      }
    }
  }
}


// Items e0 + i kWg + tid (i < 4) of the pooled skip share over the groups g0..
// that meet a 64-row half: item e is group g0 + e / kBT, channel c0 + e % kBT;
// am = its row within the group (-1 past `items` or cd) and sel its dosel.
template <bool DOWN_BN, int RES>
__device__ __forceinline__ void skip_items(const DaEpilogue<bf16, DOWN_BN, RES>& ep,
                                           int64_t g0, int items, int e0, int tid,
                                           int c0, int (&am)[4], float (&sel)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = e0 + i * kWg + tid, c = e % kBT;
    const bool ok = e < items && c0 + c < ep.cd;
    const int64_t at = (g0 + e / kBT) * ep.cd + c0 + c;
    am[i] = ok ? ep.skip_amax[at] : -1;
    sel[i] = ok ? ep.skip_dosel[at] : 0.f;
  }
}

// da = dh @ w^T: M = rows, N = cd, K = cu, both operands K-major.
struct DaSmem {
  bf16 a[kStages][kBT * kBK];  // dh: 128 rows x 64 channels
  bf16 b[kStages][kBT * kBK];  // w: 128 input channels x 64
  float z[2][64 * kZ];         // a consumer's 64 x 128 accumulators
  float sc[7][kBT];            // the block's channel scalars
  uint64_t full[kStages], empty[kStages];
  uint64_t turn[2];  // consumer g's product loops done (the other waits on it)
};

// dw^T = dh^T @ a_up: M = cu, N = cd, K = rows, both operands MN-major.
// BN: the tile's input channels (128, or 192 for wide layers: fewer re-reads
// of dh across the tiles of cd).
template <int BN>
struct DwSmem {
  bf16 a[kStages][2][kAtom];       // dh: 64 rows x (2 x 64 output channels)
  bf16 b[kStages][BN / 64][kAtom];  // a_up: 64 rows x (BN / 64 x 64 input channels)
  uint64_t full[kStages], empty[kStages];
};

constexpr int kDaSmemBytes = sizeof(DaSmem) + 1024;
template <int BN>
constexpr int kDwSmemBytes = sizeof(DwSmem<BN>) + 1024;

// da for a chunk of rows and 128 input channels (c0..), then the epilogue;
// per-chunk partials of Sd and Se in part (DOWN_BN). The consumers take the
// chunk's 128-row tiles in turn (ping-pong): one runs its products while the
// other, its accumulators done, runs the epilogue, so the epilogue's memory
// traffic overlaps the tensor cores' work. Their product loops alternate
// strictly (the `turn` barriers): a consumer waits on a stage's full barrier
// only for the phase in flight or the one just completed, which is all that
// a parity wait can tell apart.
template <bool DOWN_BN, int RES>
__global__ void __launch_bounds__(kTmaThreads, 1) bwd_da_wgmma_kernel(
    const __grid_constant__ CUtensorMap map_dh,
    const __grid_constant__ CUtensorMap map_w, DaEpilogue<bf16, DOWN_BN, RES> ep,
    const float* __restrict__ scd, const float* __restrict__ res_sc,
    float* __restrict__ part, int64_t rows, int cu, int chunk_rows) {
  extern __shared__ unsigned char smem_raw[];
  DaSmem& sm = *reinterpret_cast<DaSmem*>(hopper::align1024(smem_raw));
  const int cd = ep.cd;
  const int c0 = blockIdx.x * kBT;
  const int64_t r_begin = static_cast<int64_t>(blockIdx.y) * chunk_rows;
  const int64_t r_end = rows < r_begin + chunk_rows ? rows : r_begin + chunk_rows;
  const int tiles = static_cast<int>((r_end - r_begin + kBT - 1) / kBT);
  const int ksteps = (cu + kBK - 1) / kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&sm.full[s], 1);
      hopper::mbar_init(&sm.empty[s], 4);  // the four warps of one consumer
    }
    hopper::mbar_init(&sm.turn[0], 4);
    hopper::mbar_init(&sm.turn[1], 4);
    hopper::fence_barrier_init();
  }
  for (int e = threadIdx.x; e < 7 * kBT; e += kTmaThreads) {
    const int k = e / kBT, c = c0 + e % kBT;
    float v = 0.f;
    if (DOWN_BN && c < cd) {
      if (k < 4) {
        v = scd[k * cd + c];
      } else if (RES == kResBnRelu) {
        v = res_sc[(k - 4) * cd + c];
      }
    }
    sm.sc[k][e % kBT] = v;
  }
  __syncthreads();

  if (threadIdx.x < kWg) {  // producer: tile t's stages are ring positions t ksteps + k
    hopper::regs_release<40>();
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < tiles; ++t) {
        const int row0 = static_cast<int>(r_begin) + t * kBT;
        for (int k = 0; k < ksteps; ++k) {
          hopper::mbar_wait(&sm.empty[stage], phase ^ 1);
          hopper::mbar_expect_tx(&sm.full[stage], 2 * kBT * kBK * 2);
          hopper::tma_load_2d(sm.a[stage], &map_dh, &sm.full[stage], k * kBK, row0);
          hopper::tma_load_2d(sm.b[stage], &map_w, &sm.full[stage], k * kBK, c0);
          if (++stage == kStages) stage = 0, phase ^= 1;
        }
      }
    }
    return;
  }

  // consumer g: tiles g, g + 2, ..; its 128 rows as two 64-row halves
  hopper::regs_claim<232>();  // 40 x 128 + 232 x 256 = the block's 168 x 384
  const int g = threadIdx.x / kWg - 1;
  const int tid = threadIdx.x % kWg, warp = tid / 32, lane = tid % 32;
  // epilogue: thread (cg, ro) owns channels 8 cg .. 8 cg + 7 at rows ro, ro + 8, ..
  const int cg = tid % 16, ro = tid / 16;
  const int ch0 = c0 + cg * kStrip;
  const int n = min(kStrip, cd - ch0);
  const bool whole = cd % kStrip == 0;  // 16-byte rows
  const float* sc = &sm.sc[0][cg * kStrip];
  // the strip's BatchNorm scalars, in registers for the kernel (shared-memory
  // loads between the epilogue's global stores would be repeated: the
  // compiler cannot tell the two apart through generic pointers)
  float bn[32];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int j = 0; j < kStrip; ++j) bn[k * 8 + j] = sc[k * kBT + j];
  DaEpilogue<bf16, DOWN_BN, RES> ep_rows = ep;  // the ragged path's; the pool
  ep_rows.skip_dosel = nullptr;                  // share joins da in z first
  float* z = sm.z[g];
  float sd[8] = {}, se[8] = {};
  for (int t = g; t < tiles; t += 2) {
    // tile t - 1's products (the other consumer's) are done: every stage's
    // full barrier has completed its phases up to tile t's
    if (t > 0) hopper::mbar_wait(&sm.turn[1 - g], ((t - 1) / 2) & 1);
    // the pooled skip share's first items of both halves, loaded while the
    // products run (one batch of 4 (group, channel) items a thread and half)
    int pam[2][4];
    float psel[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t base = r_begin + static_cast<int64_t>(t) * kBT + h * 64;
      const int64_t top = r_end < base + 64 ? r_end : base + 64;
      const bool any = ep.skip_dosel != nullptr && base < top;
      const int64_t g0 = any ? base / ep.pool : 0;
      const int items = any ? static_cast<int>((top - 1) / ep.pool - g0 + 1) * kBT : 0;
      skip_items(ep, g0, items, 0, tid, c0, pam[h], psel[h]);
    }
    float d[2][64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[0][i] = d[1][i] = 0.f;
    // the depth (cu) is one chain; one group stays in flight while the next
    // stage's arrives, then the previous stage is released
    int prev = 0;
    for (int k = 0; k < ksteps; ++k) {
      const int pos = t * ksteps + k, stage = pos % kStages;
      hopper::mbar_wait(&sm.full[stage], (pos / kStages) & 1);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t db = hopper::desc_sw128(sm.b[stage] + kk * 16, 16, 1024);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          hopper::wgmma_m64n128k16<0, 0>(
              d[h], hopper::desc_sw128(sm.a[stage] + h * 64 * kBK + kk * 16, 16, 1024),
              db, 1);
        }
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      if (k > 0 && lane == 0) hopper::mbar_arrive(&sm.empty[prev]);
      prev = stage;
    }
    hopper::wgmma_wait<0>();
    __syncwarp();
    if (lane == 0) {
      hopper::mbar_arrive(&sm.empty[prev]);
      hopper::mbar_arrive(&sm.turn[g]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int r = warp * 16 + lane / 4, c = j * 8 + (lane % 4) * 2;
        *reinterpret_cast<float2*>(z + r * kZ + c) =
            make_float2(d[h][4 * j], d[h][4 * j + 1]);
        *reinterpret_cast<float2*>(z + (r + 8) * kZ + c) =
            make_float2(d[h][4 * j + 2], d[h][4 * j + 3]);
      }
      hopper::named_sync(1 + g, kWg);
      const int64_t base = r_begin + static_cast<int64_t>(t) * kBT + h * 64;
      const int64_t top = r_end < base + 64 ? r_end : base + 64;
      if (ep.skip_dosel != nullptr && base < top) {
        // the pooled skip share: dosel at the row amax of each group, added to
        // that row's da (one (group, channel) a thread; other rows get none)
        // (batches of 4 items a thread, the first loaded before the products)
        const int64_t g0 = base / ep.pool;
        const int items = static_cast<int>((top - 1) / ep.pool - g0 + 1) * kBT;
        for (int e0 = 0; e0 < items; e0 += 4 * kWg) {
          int am[4];
          float sel[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) am[i] = pam[h][i], sel[i] = psel[h][i];
          if (e0 > 0) skip_items(ep, g0, items, e0, tid, c0, am, sel);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int e = e0 + i * kWg + tid;
            const int64_t row = (g0 + e / kBT) * ep.pool + am[i];
            if (am[i] >= 0 && row >= base && row < top) {
              float& v = z[(row - base) * kZ + e % kBT];
              v = __fadd_rn(v, sel[i]);
            }
          }
        }
        hopper::named_sync(1 + g, kWg);
      }
      if constexpr (DOWN_BN) {
        // (smaller batches where another operand or the residual's scalars
        // take registers)
        if (whole && n > 0 && ep.skip_dz != nullptr) {
          bn_rows<4, RES, true>(ep, z, kZ, base, top, r_begin, ro, cg, ch0, bn,
                                sc + 4 * kBT, sd, se);
        } else if (whole && n > 0) {
          constexpr int kBatch = RES == kResBnRelu ? 4 : 8;
          bn_rows<kBatch, RES, false>(ep, z, kZ, base, top, r_begin, ro, cg, ch0, bn,
                                      sc + 4 * kBT, sd, se);
        }
      }
      if (!DOWN_BN && whole) {  // dzd = T(da), 16 bytes a store
        if (n > 0) {
          for (int i = 0; i < 8; ++i) {
            const int lr = ro + 8 * i;
            if (base + lr >= top) break;
            const float4 z0 =
                *reinterpret_cast<const float4*>(z + lr * kZ + cg * kStrip);
            const float4 z1 =
                *reinterpret_cast<const float4*>(z + lr * kZ + cg * kStrip + 4);
            const float a[8] = {z0.x, z0.y, z0.z, z0.w, z1.x, z1.y, z1.z, z1.w};
            store8(ep.dzd + (base + lr) * cd + ch0, a);
          }
        }
      } else if (!DOWN_BN) {  // ragged rows: neighbouring threads, neighbouring channels
        const int width = min(kBT, cd - c0);
        for (int e = tid; e < 64 * kBT; e += kWg) {
          const int lr = e / kBT, c = e % kBT;
          if (base + lr < top && c < width)
            ep.dzd[(base + lr) * cd + c0 + c] = Ty<bf16>::from_f(z[lr * kZ + c]);
        }
      } else if (DOWN_BN && !whole && n > 0) {  // ragged rows: loads a row
        for (int i = 0; i < 8; ++i) {
          const int lr = ro + 8 * i;
          if (base + lr >= top) break;
          const float4 z0 = *reinterpret_cast<const float4*>(z + lr * kZ + cg * kStrip);
          const float4 z1 =
              *reinterpret_cast<const float4*>(z + lr * kZ + cg * kStrip + 4);
          float a[8] = {z0.x, z0.y, z0.z, z0.w, z1.x, z1.y, z1.z, z1.w};
          ep_rows.template row<kStrip, kBT>(base + lr, ch0, n, false, a, sc, sd, se);
        }
      }
      hopper::named_sync(1 + g, kWg);  // z is rewritten by the next half
    }
  }
  if constexpr (DOWN_BN) {
    // the sums of both consumers' rows, in a fixed order, through z
    hopper::named_sync(3, 2 * kWg);
    float* red = sm.z[0];  // [consumer][ro][sd, se][128 channels]
#pragma unroll
    for (int j = 0; j < kStrip; ++j) {
      red[((g * 8 + ro) * 2 + 0) * kBT + cg * kStrip + j] = sd[j];
      red[((g * 8 + ro) * 2 + 1) * kBT + cg * kStrip + j] = se[j];
    }
    hopper::named_sync(3, 2 * kWg);
    const int t2 = threadIdx.x - kWg, col = t2 % kBT, which = t2 / kBT;
    if (c0 + col < cd) {
      float s = 0.f;
      for (int r = 0; r < 16; ++r) s += red[(r * 2 + which) * kBT + col];
      part[(static_cast<int64_t>(blockIdx.y) * 2 + which) * cd + c0 + col] = s;
    }
  }
}

// dw partial of a chunk of rows for output channels m0.. (128 of cu) and
// input channels n0.. (BN of cd): dw_part[chunk, n, m] = sum over the rows
// of a_up[row, n] dh[row, m]. Atoms wholly past cu or cd are not loaded; a
// consumer with no channel of cu stops; an unloaded atom of a_up feeds only
// columns past cd, which are not stored. The consumers take the producer's
// registers (fp32 sums of a 64 x BN tile twice: the tensor cores' and the
// promoted).
template <int BN>
__global__ void __launch_bounds__(kTmaThreads, 1) bwd_dw_wgmma_kernel(
    const __grid_constant__ CUtensorMap map_dh,
    const __grid_constant__ CUtensorMap map_a, float* __restrict__ dw_part,
    int64_t rows, int cd, int cu, int chunk_rows) {
  extern __shared__ unsigned char smem_raw[];
  DwSmem<BN>& sm = *reinterpret_cast<DwSmem<BN>*>(hopper::align1024(smem_raw));
  const int m0 = blockIdx.x * kBT, n0 = blockIdx.y * BN;
  const int64_t r_begin = static_cast<int64_t>(blockIdx.z) * chunk_rows;
  const int64_t r_end = rows < r_begin + chunk_rows ? rows : r_begin + chunk_rows;
  const int steps = static_cast<int>((r_end - r_begin + kBK - 1) / kBK);
  const int m_atoms = min(2, (cu - m0 + 63) / 64);
  const int n_atoms = min(BN / 64, (cd - n0 + 63) / 64);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&sm.full[s], 1);
      hopper::mbar_init(&sm.empty[s], 4 * m_atoms);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < kWg) {  // producer
    hopper::regs_release<40>();
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int s = 0; s < steps; ++s) {
        const int row = static_cast<int>(r_begin) + s * kBK;
        hopper::mbar_wait(&sm.empty[stage], phase ^ 1);
        hopper::mbar_expect_tx(&sm.full[stage], (m_atoms + n_atoms) * kAtom * 2);
        for (int a = 0; a < m_atoms; ++a)
          hopper::tma_load_2d(sm.a[stage][a], &map_dh, &sm.full[stage], m0 + 64 * a, row);
        for (int b = 0; b < n_atoms; ++b)
          hopper::tma_load_2d(sm.b[stage][b], &map_a, &sm.full[stage], n0 + 64 * b, row);
        if (++stage == kStages) stage = 0, phase ^= 1;
      }
    }
    return;
  }

  hopper::regs_claim<232>();  // 40 x 128 + 232 x 256 = the block's 168 x 384
  const int g = threadIdx.x / kWg - 1;  // output channels m0 + 64 g ..
  if (g >= m_atoms) return;
  const int tid = threadIdx.x % kWg, warp = tid / 32, lane = tid % 32;
  // kPromote stages' rows (256) summed by the tensor cores (d), those sums
  // added in fp32 (acc); one group in flight while the next stage arrives
  float d[BN / 2], acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = acc[i] = 0.f;
  int stage = 0, prev = 0;
  uint32_t phase = 0;
  for (int s = 0; s < steps; ++s) {
    hopper::mbar_wait(&sm.full[stage], phase);
    hopper::wgmma_fence();
    const int fresh = s % kPromote == 0;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      hopper::wgmma_m64nNk16<BN, 1, 1>(
          d, hopper::desc_sw128(sm.a[stage][g] + kk * 16 * 64, kAtom * 2, 1024),
          hopper::desc_sw128(sm.b[stage][0] + kk * 16 * 64, kAtom * 2, 1024),
          kk > 0 || !fresh);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    if (s > 0 && lane == 0) hopper::mbar_arrive(&sm.empty[prev]);
    prev = stage;
    if (++stage == kStages) stage = 0, phase ^= 1;
    if ((s + 1) % kPromote == 0 || s + 1 == steps) {
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] += d[i];
    }
  }
  if (steps > 0 && lane == 0) hopper::mbar_arrive(&sm.empty[prev]);
  float* out = dw_part + static_cast<int64_t>(blockIdx.z) * cd * cu;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int m = m0 + g * 64 + warp * 16 + lane / 4 + 8 * (q >> 1);
      const int nn = n0 + j * 8 + (lane % 4) * 2 + (q & 1);
      if (m < cu && nn < cd) out[static_cast<int64_t>(nn) * cu + m] = acc[4 * j + q];
    }
  }
}

// ---- bf16 forward products: a resident activated panel, TMA + wgmma ----
//
// h = T(act(a_in) @ w) and the per-chunk column sums of the rounded h and
// h^2 (see the note at the top). A block owns a chunk of rows and walks it
// in panels of 128 rows (two 64-row halves) or, where a deep layer's panel
// would not fit, 64 rows; each panel stays resident over all of cd while
// the block walks every N tile of cu over it, so each input element is
// read and activated once. Warps 1-3 of the producer warpgroup stage the
// panels, up to `slots` ahead, in the 128-byte-swizzled K-major layout
// (16-byte chunk c of row r at c ^ (r % 8)): where rows are whole 16-byte
// chunks, lane 1 of warp 0 loads a panel by TMA as soon as the consumers
// free its slot and, below a BatchNorm, the three warps apply the BatchNorm + residual + ReLU prologue in place (the
// residual read with 16-byte loads, kInFlight rows in flight), round to
// bf16 and store r_out where asked; the layer input of a ragged width (6,
// 131, 259, 643) is read as the panel's contiguous range of elements with
// 16-byte loads and scattered two bytes at a time. Lane 0 of warp 0 walks
// every N tile of every panel and streams w's (64 depth x nt channel) tiles
// through a ring by TMA (MN-major boxes of 64 x 64, zero past cd and cu).
// Two consumer warpgroups read every ring stage: with 128-row panels each
// takes its 64-row half and all nt channels, with 64-row panels each takes
// nt / 2 channels of the one half; so every stage and every panel has both
// consumers as readers and a parity wait never meets a barrier two phases
// away. Each N tile's accumulators (m64nWNk16, fp32 registers) are rounded
// to bf16 into a swizzled tile in shared memory that one thread stores by
// TMA (rows written whole; the pairs stored from registers, 4 bytes a lane
// and 8 rows a warp, held back every shape on the card), and summed over
// the tile's rows: per thread, then across the warp by shuffles in a fixed
// order, then over the four warps in order into per-consumer column sums in
// shared memory; at the end the two consumers' sums are added in order into
// the chunk's partials. No atomics.

constexpr int kFwdMaxStages = 4, kFwdMaxSlots = 4;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may have
constexpr int kStagers = 3 * 32;    // warps 1-3 of the producer warpgroup

// The launch geometry (ops/preextract_fused.py fwd_plan) and the shared
// memory it implies: the panel slots, the w ring, each consumer's bf16 h
// tile for its TMA store (wn / 64 swizzled atoms of 64 rows x 128 bytes),
// the column sums ([consumer][sum, sq][ntiles nt] over 128-row panels, whose
// two halves sum the same channels; [sum, sq][ntiles nt] over 64-row
// panels, whose consumers own disjoint channels), the warps' tile sums
// [consumer][warp][sum, sq][wn], then the barriers.
struct FwdGeom {
  int pr;      // panel rows: 128 or 64
  int wn;      // channels of a consumer's product: 64 or 128
  int ka;      // depth atoms of 64 channels: ceil(cd / 64)
  int slots;   // panels staged ahead (1..4)
  int stages;  // w ring stages (1..4)
  int nt;      // channels of a ring stage: wn (pr 128) or 2 wn (pr 64)
  int ntiles;  // ceil(cu / nt)
  __host__ __device__ int panel_bytes() const { return ka * pr * 128; }
  __host__ __device__ int stage_bytes() const { return nt / 64 * 8192; }
  __host__ __device__ int epi_bytes() const { return 2 * wn * 128; }
  __host__ __device__ int colsum_floats() const {
    return (pr == 128 ? 4 : 2) * ntiles * nt;
  }
  __host__ __device__ int wsum_floats() const { return 16 * wn; }
  __host__ __device__ int bytes() const {
    return 1024 + slots * panel_bytes() + stages * stage_bytes() + epi_bytes() +
           4 * (colsum_floats() + wsum_floats()) + 20 * 8;
  }
};

// Byte offset of (row r, channel c) in a panel of pr rows: 64-channel atoms
// of pr x 128 bytes, the 128-byte swizzle within each.
__device__ __forceinline__ int panel_off(int r, int c, int pr) {
  return (c >> 6) * pr * 128 + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) + (c & 7) * 2;
}

// 16-byte loads a staging thread keeps in flight: staging is bound by the
// loads' latency (three warps stage an SM's panel).
constexpr int kInFlight = 16;

// The layer input's nr rows from row0 into a panel as they are, cd ragged
// (rows are no whole 16-byte chunks, so TMA cannot read them): the rows are
// one contiguous range of nr cd elements, read 16 bytes at a time
// (kInFlight loads in flight a thread) and scattered to their (row,
// channel) places two bytes at a time. (Forming whole 16-byte chunks of a
// row from the two aligned words that hold them, and storing those, was
// slower at SA2's 131 channels on the card.)
__device__ __forceinline__ void stage_input(unsigned char* pan, const bf16* __restrict__ a_in,
                                            int64_t row0, int nr, int cd, int pr, int st) {
  const bf16* src = a_in + row0 * cd;
  const int n = nr * cd, n8 = n / 8;
  for (int i0 = st; i0 < n8; i0 += kInFlight * kStagers) {
    uint4 u[kInFlight];
#pragma unroll
    for (int b = 0; b < kInFlight; ++b) {
      const int i = i0 + b * kStagers;
      if (i < n8) u[b] = ldg16(src + 8 * i);
    }
#pragma unroll
    for (int b = 0; b < kInFlight; ++b) {
      const int i = i0 + b * kStagers;
      if (i >= n8) break;
      int r = (8 * i) / cd, c = 8 * i - r * cd;
      const uint32_t v[4] = {u[b].x, u[b].y, u[b].z, u[b].w};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        *reinterpret_cast<uint16_t*>(pan + panel_off(r, c, pr)) =
            static_cast<uint16_t>(v[k / 2] >> (16 * (k % 2)));
        if (++c == cd) c = 0, ++r;
      }
    }
  }
  for (int e = 8 * n8 + st; e < n; e += kStagers) {
    const int r = e / cd;
    *reinterpret_cast<bf16*>(pan + panel_off(r, e - r * cd, pr)) = src[e];
  }
}

// A lower layer's h, which TMA loaded into a panel (nr rows from row0, cd a
// multiple of 8), activated in place: a = bf16(relu(BN(h) [+ residual]))
// with bn_pre's and Residual::add's rounded operations, 8 channels (one
// 16-byte chunk) at a time; r_out (or NULL) takes the same 16 bytes. Thread
// st owns the chunks q = st % L, + L, .. (L = min(cd / 8, 32)) over the rows
// st / L, + S, .. (S = 96 / L streams), so a chunk's scalars are loaded once
// a panel; the residual's loads of kInFlight rows are in flight at once.
template <int RES>
__device__ __forceinline__ void activate_panel(unsigned char* pan,
                                               const float* __restrict__ sc,
                                               const bf16* __restrict__ res_src,
                                               const float* __restrict__ res_sc,
                                               bf16* __restrict__ r_out, int64_t row0,
                                               int nr, int cd, int pr, int st) {
  // (RES_BNRELU's second set of scalars leaves registers for 8 rows)
  constexpr int ROWS = RES == kResDense ? kInFlight : RES == kResBnRelu ? kInFlight / 2 : 4;
  const int nq = cd / 8, L = nq < 32 ? nq : 32, S = kStagers / L;
  if (st >= S * L) return;
  for (int q = st % L; q < nq; q += L) {
    float m[8], mu[8], be[8], rm[8], rmu[8], rbe[8];
    load8(sc + 8 * q, m);
    load8(sc + cd + 8 * q, mu);
    load8(sc + 2 * cd + 8 * q, be);
    if constexpr (RES == kResBnRelu) {
      load8(res_sc + 8 * q, rm);
      load8(res_sc + cd + 8 * q, rmu);
      load8(res_sc + 2 * cd + 8 * q, rbe);
    }
    for (int r0 = st / L; r0 < nr; r0 += ROWS * S) {
      uint4 y[ROWS];
      if constexpr (RES != kResNone) {
#pragma unroll
        for (int b = 0; b < ROWS; ++b) {
          const int r = r0 + b * S;
          if (r < nr) y[b] = ldg16(res_src + (row0 + r) * cd + 8 * q);
        }
      }
#pragma unroll
      for (int b = 0; b < ROWS; ++b) {
        const int r = r0 + b * S;
        if (r >= nr) break;
        uint4* at = reinterpret_cast<uint4*>(pan + panel_off(r, 8 * q, pr));
        float f[8], g[8], o[8];
        unpack8(*at, f);
        if constexpr (RES != kResNone) unpack8(y[b], g);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          float pre = bn_pre(f[k], m[k], mu[k], be[k]);
          if constexpr (RES == kResBnRelu) {
            pre = __fadd_rn(pre, fmaxf(bn_pre(g[k], rm[k], rmu[k], rbe[k]), 0.f));
          } else if constexpr (RES == kResDense) {
            pre = __fadd_rn(pre, g[k]);
          }
          o[k] = fmaxf(pre, 0.f);
        }
        uint4 u;
        __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
        for (int k = 0; k < 4; ++k) p2[k] = __floats2bfloat162_rn(o[2 * k], o[2 * k + 1]);
        *at = u;
        if (r_out != nullptr) *reinterpret_cast<uint4*>(r_out + (row0 + r) * cd + 8 * q) = u;
      }
    }
  }
}

// One chunk of rows (blockIdx.x): h (stored through map_h), r_out (or NULL)
// and part[chunk, 0 / 1, :] = the chunk's column sums of h and h^2. BN
// false: the layer input as it is (no scalars, no residual).
template <int WN, bool BN, int RES>
__global__ void __launch_bounds__(kTmaThreads, 1) fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap map_w, const __grid_constant__ CUtensorMap map_a,
    const __grid_constant__ CUtensorMap map_h, const bf16* __restrict__ a_in,
    const float* __restrict__ sc, const bf16* __restrict__ res_src,
    const float* __restrict__ res_sc, bf16* __restrict__ r_out, float* __restrict__ part,
    FwdGeom geo, int64_t rows, int cd, int cu, int chunk_rows) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const panels = hopper::align1024(smem_raw);
  unsigned char* const ring = panels + geo.slots * geo.panel_bytes();
  unsigned char* const epi = ring + geo.stages * geo.stage_bytes();
  float* const colsum = reinterpret_cast<float*>(epi + geo.epi_bytes());
  float* const wsum = colsum + geo.colsum_floats();
  uint64_t* const bars = reinterpret_cast<uint64_t*>(wsum + geo.wsum_floats());
  uint64_t* const full = bars;                       // w stage landed
  uint64_t* const empty = bars + kFwdMaxStages;      // w stage read
  uint64_t* const pfull = bars + 2 * kFwdMaxStages;  // panel staged
  uint64_t* const pempty = pfull + kFwdMaxSlots;     // panel read
  uint64_t* const ptma = pempty + kFwdMaxSlots;      // panel's input landed
  const int64_t r_begin = static_cast<int64_t>(blockIdx.x) * chunk_rows;
  const int64_t r_end = rows < r_begin + chunk_rows ? rows : r_begin + chunk_rows;
  const int n_panels = static_cast<int>((r_end - r_begin + geo.pr - 1) / geo.pr);
  const int ksteps = geo.ka;
  if (threadIdx.x == 0) {
    for (int s = 0; s < geo.stages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // the eight consumer warps
    }
    for (int s = 0; s < geo.slots; ++s) {
      hopper::mbar_init(&pfull[s], 3);  // the three staging warps
      hopper::mbar_init(&pempty[s], 8);
      hopper::mbar_init(&ptma[s], 1);
    }
    hopper::fence_barrier_init();
  }
  // zero the panels (their depth past cd stays zero: staging writes channels
  // below cd only) and the column sums
  for (int i = threadIdx.x; i < geo.slots * geo.panel_bytes() / 16; i += kTmaThreads)
    reinterpret_cast<uint4*>(panels)[i] = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < geo.colsum_floats(); i += kTmaThreads) colsum[i] = 0.f;
  hopper::fence_proxy_async();
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // Widths of whole 16-byte rows: lane 1 of warp 0 loads each panel by TMA
  // (boxes of 64 channels x pr rows, zero past cd and the last row), up to
  // `slots` panels ahead, and the stagers activate it in place below a
  // BatchNorm. A ragged input width is staged by the stagers themselves.
  const bool tma = cd % 8 == 0;
  if (threadIdx.x < kWg) {
    if (warp == 0) {
      if (lane == 0) {  // w tiles: panel p, N tile j, depth atom k in order
        int stage = 0;
        uint32_t phase = 0;
        for (int p = 0; p < n_panels; ++p) {
          for (int j = 0; j < geo.ntiles; ++j) {
            const int n0 = j * geo.nt;
            const int atoms = min(geo.nt / 64, (cu - n0 + 63) / 64);
            for (int k = 0; k < ksteps; ++k) {
              hopper::mbar_wait(&empty[stage], phase ^ 1);
              hopper::mbar_expect_tx(&full[stage], atoms * kAtom * 2);
              for (int a = 0; a < atoms; ++a)
                hopper::tma_load_2d(ring + stage * geo.stage_bytes() + a * kAtom * 2,
                                    &map_w, &full[stage], n0 + 64 * a, 64 * k);
              if (++stage == geo.stages) stage = 0, phase ^= 1;
            }
          }
        }
      } else if (lane == 1 && tma) {  // panels, once the consumers freed the slot
        for (int p = 0; p < n_panels; ++p) {
          const int slot = p % geo.slots, use = p / geo.slots;
          hopper::mbar_wait(&pempty[slot], (use & 1) ^ 1);
          hopper::mbar_expect_tx(&ptma[slot], geo.panel_bytes());
          for (int a = 0; a < geo.ka; ++a)
            hopper::tma_load_2d(panels + slot * geo.panel_bytes() + a * geo.pr * 128,
                                &map_a, &ptma[slot], 64 * a,
                                static_cast<int>(r_begin) + p * geo.pr);
        }
      }
      return;
    }
    const int st = threadIdx.x - 32;  // a staging thread, 0..95
    for (int p = 0; p < n_panels; ++p) {
      const int slot = p % geo.slots, use = p / geo.slots;
      unsigned char* pan = panels + slot * geo.panel_bytes();
      const int64_t row0 = r_begin + static_cast<int64_t>(p) * geo.pr;
      const int nr = static_cast<int>(r_end - row0 < geo.pr ? r_end - row0 : geo.pr);
      if (tma) {
        hopper::mbar_wait(&ptma[slot], use & 1);
        if constexpr (BN)
          activate_panel<RES>(pan, sc, res_src, res_sc, r_out, row0, nr, cd, geo.pr, st);
      } else if constexpr (!BN) {  // a ragged input width (below a BatchNorm
        // cd is a multiple of 8): rows are no whole 16-byte chunks
        hopper::mbar_wait(&pempty[slot], (use & 1) ^ 1);
        stage_input(pan, a_in, row0, nr, cd, geo.pr, st);
      }
      hopper::fence_proxy_async();
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&pfull[slot]);
    }
    return;
  }

  // consumer g: a 64-row half of a 128-row panel (all nt channels of a
  // stage), or channels g wn .. of a stage over a 64-row panel
  const int g = threadIdx.x / kWg - 1;
  const int tid = threadIdx.x % kWg, cw = tid / 32;
  const bool halves = geo.pr == 128;
  const int a_half = halves ? g : 0;
  const int b_off = halves ? 0 : g * WN;
  const int tot = geo.ntiles * geo.nt;
  float* const cs = colsum + (halves ? g * 2 * tot : 0);
  float* const ws = wsum + g * 8 * WN;
  unsigned char* const eb = epi + g * WN * 128;  // this consumer's h tile
  const bool issuer = tid == 0;  // issues the tile's TMA stores
  const int r_loc = cw * 16 + lane / 4;  // rows r_loc and r_loc + 8 of the half
  int stage = 0;
  uint32_t phase = 0;
  for (int p = 0; p < n_panels; ++p) {
    const int slot = p % geo.slots;
    hopper::mbar_wait(&pfull[slot], (p / geo.slots) & 1);
    const unsigned char* pan = panels + slot * geo.panel_bytes() + a_half * 64 * 128;
    const int64_t row_t = r_begin + static_cast<int64_t>(p) * geo.pr + a_half * 64;
    const int64_t ra = row_t + r_loc, rb = ra + 8;
    const bool va = ra < r_end, vb = rb < r_end;
    for (int j = 0; j < geo.ntiles; ++j) {
      float d[WN / 2];
#pragma unroll
      for (int i = 0; i < WN / 2; ++i) d[i] = 0.f;
      int prev = 0;
      for (int k = 0; k < ksteps; ++k) {
        hopper::mbar_wait(&full[stage], phase);
        hopper::wgmma_fence();
        const unsigned char* a_at = pan + k * geo.pr * 128;
        const unsigned char* b_at = ring + stage * geo.stage_bytes() + b_off / 64 * kAtom * 2;
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          hopper::wgmma_m64nNk16<WN, 0, 1>(d, hopper::desc_sw128(a_at + kk * 32, 16, 1024),
                                           hopper::desc_sw128(b_at + kk * 2048, kAtom * 2, 1024),
                                           1);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();
        if (k > 0 && lane == 0) hopper::mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == geo.stages) stage = 0, phase ^= 1;
      }
      hopper::wgmma_wait<0>();
      if (lane == 0) {
        hopper::mbar_arrive(&empty[prev]);
        if (j == geo.ntiles - 1) hopper::mbar_arrive(&pempty[slot]);
      }
      // the tile's epilogue: the bf16 pairs into the swizzled h tile (one
      // TMA store of 64 rows x 64 channels an atom; rows and channels past
      // the tensor are not written), the rounded values and their squares
      // summed over the two rows, then over the warp (lanes of one lane % 4
      // hold the same columns), then over the four warps in order
      if (issuer) hopper::bulk_wait_read<0>();  // the last tile's stores read eb
      hopper::named_sync(1 + g, kWg);
      const int n_base = j * geo.nt + b_off;
#pragma unroll
      for (int jj = 0; jj < WN / 8; ++jj) {
        const __nv_bfloat162 pa = __floats2bfloat162_rn(d[4 * jj], d[4 * jj + 1]);
        const __nv_bfloat162 pb = __floats2bfloat162_rn(d[4 * jj + 2], d[4 * jj + 3]);
        // rows r_loc and r_loc + 8 share their swizzle phase (r % 8)
        const int at = (jj / 8) * 8192 + r_loc * 128 +
                       (((jj % 8) ^ (r_loc & 7)) << 4) + 4 * (lane % 4);
        *reinterpret_cast<__nv_bfloat162*>(eb + at) = pa;
        *reinterpret_cast<__nv_bfloat162*>(eb + at + 8 * 128) = pb;
        const float2 fa = __bfloat1622float2(pa), fb = __bfloat1622float2(pb);
        const float xa = va ? fa.x : 0.f, ya = va ? fa.y : 0.f;
        const float xb = vb ? fb.x : 0.f, yb = vb ? fb.y : 0.f;
        float v[4] = {xa + xb, ya + yb, xa * xa + xb * xb, ya * ya + yb * yb};
#pragma unroll
        for (int off = 4; off < 32; off *= 2)
#pragma unroll
          for (int i = 0; i < 4; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
        if (lane < 4) {
          const int col = jj * 8 + 2 * lane;
          ws[(cw * 2) * WN + col] = v[0];
          ws[(cw * 2) * WN + col + 1] = v[1];
          ws[(cw * 2 + 1) * WN + col] = v[2];
          ws[(cw * 2 + 1) * WN + col + 1] = v[3];
        }
      }
      hopper::fence_proxy_async();
      hopper::named_sync(1 + g, kWg);
      if (issuer) {
        for (int a = 0; a < WN / 64 && n_base + 64 * a < cu; ++a)
          hopper::tma_store_2d(&map_h, eb + a * 8192, n_base + 64 * a,
                               static_cast<int>(row_t));
        hopper::bulk_commit();
      }
      if (tid < WN) {
        float s = 0.f, q = 0.f;
#pragma unroll
        for (int w4 = 0; w4 < 4; ++w4) {
          s += ws[(w4 * 2) * WN + tid];
          q += ws[(w4 * 2 + 1) * WN + tid];
        }
        cs[n_base + tid] += s;
        cs[tot + n_base + tid] += q;
      }
      hopper::named_sync(1 + g, kWg);  // ws is rewritten by the next tile
    }
  }
  if (issuer) hopper::bulk_wait<0>();  // h written before the block ends
  // the chunk's partials: consumer 0's sums, then consumer 1's (over 64-row
  // panels each channel has one consumer)
  hopper::named_sync(3, 2 * kWg);
  float* const out = part + static_cast<int64_t>(blockIdx.x) * 2 * cu;
  for (int e = threadIdx.x - kWg; e < 2 * cu; e += 2 * kWg) {
    const int which = e / cu, c = e - which * cu;
    out[e] = halves ? colsum[which * tot + c] + colsum[2 * tot + which * tot + c]
                    : colsum[which * tot + c];
  }
}

// ---- fp32: CUDA-core tiles (tile_mma.cuh's Mma<float>), no TF32 ----

// da = dh @ w^T for a chunk of rows and 128 input channels i0.., then the
// epilogue of DaEpilogue one channel a thread (as bwd_da_wgmma_kernel).
template <bool DOWN_BN, int RES>
__global__ void __launch_bounds__(kThreads, 3) bwd_da_f32_kernel(
    const float* __restrict__ dh, int ldh, const float* __restrict__ w,
    DaEpilogue<float, DOWN_BN, RES> ep, const float* __restrict__ scd,
    const float* __restrict__ res_sc, float* __restrict__ part, int64_t rows,
    int cu, int chunk_rows) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  using L = Lds<float, TM>;
  const Smem<float, TM> sm(smem_raw);
  const int cd = ep.cd;
  const int i0 = blockIdx.x * TN;
  const int64_t r_begin = static_cast<int64_t>(blockIdx.y) * chunk_rows;
  const int64_t r_end = rows < r_begin + chunk_rows ? rows : r_begin + chunk_rows;
  const int col = threadIdx.x % TN;
  const int half = threadIdx.x / TN;
  const int ch = i0 + col;
  const bool col_ok = ch < cd;
  // this thread's channel scalars, laid out as DaEpilogue reads them
  float sc[7] = {};
  if (DOWN_BN && col_ok) {
    for (int k = 0; k < 4; ++k) sc[k] = scd[k * cd + ch];
    if (RES == kResBnRelu)
      for (int k = 0; k < 3; ++k) sc[4 + k] = res_sc[k * cd + ch];
  }
  float sd[8] = {}, se[8] = {};
  for (int64_t r0 = r_begin; r0 < r_end; r0 += TM) {
    Mma<float> mma;
    mma.zero();
    for (int k0 = 0; k0 < cu; k0 += KC) {
      {  // dh chunk: a thread stages one channel k of it, 8 rows
        const int k = threadIdx.x % KC, kk = k0 + k;
        for (int r = threadIdx.x / KC; r < TM; r += kThreads / KC) {
          const int64_t row = r0 + r;
          sm.a[r * L::A + k] = (row < r_end && kk < cu) ? dh[row * ldh + kk] : 0.f;
        }
      }
      for (int e = threadIdx.x; e < KC * TN; e += kThreads) {  // w^T chunk
        const int i = e / KC, k = e % KC;
        sm.b[k * L::B + i] = (i0 + i < cd && k0 + k < cu)
                                 ? w[static_cast<int64_t>(i0 + i) * cu + k0 + k]
                                 : 0.f;
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
        float a[8] = {sm.z[rr * L::Z + col]};
        ep.template row<1, 1>(row, ch, 1, false, a, sc, sd, se);
      }
    }
    __syncthreads();
  }
  if constexpr (DOWN_BN) {
    write_partials(sm.z, part, blockIdx.y, cd, ch, col_ok, sd[0], se[0]);
  }
}

// dw partial of a chunk of rows: ain^T @ dh for input channels i0 .. i0+127
// and output channels c0 .. c0+127 (ain = a_up or the chain's input).
__global__ void __launch_bounds__(kThreads, 2) bwd_dw_f32_kernel(
    const float* __restrict__ dh, int ldh, const float* __restrict__ ain, int lda,
    float* __restrict__ dw_part, int64_t rows, int cd, int cu, int chunk_rows) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  using L = Lds<float, kARows>;
  const Smem<float, kARows> sm(smem_raw);
  const int c0 = blockIdx.x * TN;
  const int i0 = blockIdx.y * kARows;
  const int64_t r_begin = static_cast<int64_t>(blockIdx.z) * chunk_rows;
  const int64_t r_end = rows < r_begin + chunk_rows ? rows : r_begin + chunk_rows;
  Mma<float> acc_lo, acc_hi;  // input channels i0 .. i0+63 and i0+64 .. i0+127
  acc_lo.zero();
  acc_hi.zero();
  // kARows == TN == kThreads / 2: a thread stages one input channel and one
  // output channel for the whole kernel, every second row of a chunk
  const int lane = threadIdx.x % TN, r_first = threadIdx.x / TN;
  const int ci = i0 + lane, cj = c0 + lane;
  const bool i_ok = ci < cd, j_ok = cj < cu;
  for (int64_t r0 = r_begin; r0 < r_end; r0 += KC) {
    for (int r = r_first; r < KC; r += kThreads / TN) {
      const int64_t row = r0 + r;
      const bool row_ok = row < r_end;
      sm.a[lane * L::A + r] = (row_ok && i_ok) ? ain[row * lda + ci] : 0.f;
      sm.b[r * L::B + lane] = (row_ok && j_ok) ? dh[row * ldh + cj] : 0.f;
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

// The bf16 forward on TMA + wgmma (fwd_wgmma_kernel), geometry from the
// caller's plan; its checks mirror fwd_plan's.
template <int WN, bool BN, int RES>
int fwd_bf16(const bf16* a_in, const float* sc, const bf16* res_src,
             const float* res_sc, const bf16* w, bf16* h_out, bf16* r_out,
             float* stats, float* part, int64_t rows, int cd, int cu, int chunk_rows,
             FwdGeom geo, cudaStream_t s) {
  const auto misaligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) != 0;
  };
  if (cu % 8 != 0 || (BN && cd % 8 != 0) || chunk_rows % geo.pr != 0 ||
      geo.stages < 1 || geo.stages > kFwdMaxStages || geo.slots < 1 ||
      geo.slots > kFwdMaxSlots || geo.bytes() > kSmemLimit || misaligned(a_in) ||
      misaligned(w) || misaligned(h_out) || misaligned(sc) || misaligned(res_src) ||
      misaligned(res_sc) || misaligned(r_out))
    return kBadArgs;
  CUtensorMap map_w, map_h, map_a{};  // map_a: rows of whole 16-byte chunks only
  if (!hopper::bf16_map(&map_w, w, cu, cd, cu, 64, 64) ||
      !hopper::bf16_map(&map_h, h_out, cu, rows, cu, 64, 64) ||
      (cd % 8 == 0 && !hopper::bf16_map(&map_a, a_in, cd, rows, cd, 64, geo.pr)))
    return kBadArgs;
  const void* kernel = reinterpret_cast<const void*>(&fwd_wgmma_kernel<WN, BN, RES>);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, geo.bytes());
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = chunks_of(rows, chunk_rows);
  fwd_wgmma_kernel<WN, BN, RES><<<chunks, kTmaThreads, geo.bytes(), s>>>(
      map_w, map_a, map_h, a_in, sc, res_src, res_sc, r_out, part, geo, rows, cd, cu,
      chunk_rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  return colsum(part, stats, chunks, 2 * static_cast<int64_t>(cu), s);
}

template <typename T>
int mm_stats_any(const void* a_in, const float* sc, int res_mode,
                 const void* res_src, const float* res_sc, const void* w,
                 void* h_out, void* r_out, float* stats, float* part,
                 int64_t rows, int cd, int cu, int chunk_rows, const FwdGeom* geo,
                 cudaStream_t s) {
  const T* a = static_cast<const T*>(a_in);
  const T* rs = static_cast<const T*>(res_src);
  const T* wt = static_cast<const T*>(w);
  T* h = static_cast<T*>(h_out);
  T* r = static_cast<T*>(r_out);
  if (sc == nullptr && (res_mode != kResNone || r_out != nullptr)) return kBadArgs;
  if (geo != nullptr) {  // bf16 on the tensor cores
    if constexpr (std::is_same<T, bf16>::value) {
#define MLP_CHAIN_FWD(BN, RES)                                                        \
  return geo->wn == 64                                                                \
             ? fwd_bf16<64, BN, RES>(a, sc, rs, res_sc, wt, h, r, stats, part, rows,  \
                                     cd, cu, chunk_rows, *geo, s)                     \
             : fwd_bf16<128, BN, RES>(a, sc, rs, res_sc, wt, h, r, stats, part, rows, \
                                      cd, cu, chunk_rows, *geo, s)
      if (geo->wn != 64 && geo->wn != 128) return kBadArgs;
      if (geo->pr != 64 && geo->pr != 128) return kBadArgs;
      if (sc == nullptr) MLP_CHAIN_FWD(false, kResNone);
      if (res_mode == kResNone) MLP_CHAIN_FWD(true, kResNone);
      if (res_mode == kResBnRelu) MLP_CHAIN_FWD(true, kResBnRelu);
      if (res_mode == kResDense) MLP_CHAIN_FWD(true, kResDense);
#undef MLP_CHAIN_FWD
    }
    return kBadArgs;
  }
#define MLP_CHAIN_MM(BN, RES) \
  return mm_stats<T, BN, RES>(a, sc, rs, res_sc, wt, h, r, stats, part, rows, \
                              cd, cu, chunk_rows, s)
  if (sc == nullptr) MLP_CHAIN_MM(false, kResNone);  // layer 0: the input as it is
  if (res_mode == kResNone) MLP_CHAIN_MM(true, kResNone);
  if (res_mode == kResBnRelu) MLP_CHAIN_MM(true, kResBnRelu);
  if (res_mode == kResDense) MLP_CHAIN_MM(true, kResDense);
#undef MLP_CHAIN_MM
  return kBadArgs;
}

template <typename T, int RES, int V>
int bn_pool(const T* h, const float* sc, const T* res_src, const float* res_sc,
            const float* pen, T* out, float* maxv, int* amax, float* hsel,
            int64_t groups, int C, int pool, int final_relu, int strips, int slices,
            int per_block, cudaStream_t s) {
  if (strips < 1 || slices < 1 || per_block < 1 || strips * slices * per_block > kPoolThreads)
    return kBadArgs;
  const dim3 grid(static_cast<unsigned>((groups + per_block - 1) / per_block),
                  static_cast<unsigned>((C / V + strips - 1) / strips));
  bn_pool_kernel<T, RES, V><<<grid, strips * slices * per_block, 0, s>>>(
      h, sc, res_src, res_sc, pen, out, maxv, amax, hsel, groups, C, pool, final_relu,
      strips, slices, per_block);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bn_pool_any(const void* h, const float* sc, int res_mode, const void* res_src,
                const float* res_sc, const float* pen, void* out, float* maxv,
                int* amax, float* hsel, int64_t groups, int C, int pool,
                int final_relu, int vec, int strips, int slices, int per_block,
                cudaStream_t s) {
  const T* ht = static_cast<const T*>(h);
  const T* rs = static_cast<const T*>(res_src);
  T* o = static_cast<T*>(out);
  if (vec != 1 && (vec != 8 || C % 8 != 0)) return kBadArgs;
#define MLP_CHAIN_POOL(RES)                                                              \
  return vec == 8 ? bn_pool<T, RES, 8>(ht, sc, rs, res_sc, pen, o, maxv, amax, hsel,      \
                                       groups, C, pool, final_relu, strips, slices,      \
                                       per_block, s)                                     \
                  : bn_pool<T, RES, 1>(ht, sc, rs, res_sc, pen, o, maxv, amax, hsel,      \
                                       groups, C, pool, final_relu, strips, slices,      \
                                       per_block, s)
  if (res_mode == kResNone) MLP_CHAIN_POOL(kResNone);
  if (res_mode == kResBnRelu) MLP_CHAIN_POOL(kResBnRelu);
  if (res_mode == kResDense) MLP_CHAIN_POOL(kResDense);
#undef MLP_CHAIN_POOL
  return kBadArgs;
}

// The arguments of a da launch, untyped (the C entry's).
struct DaArgs {
  const void* dh;
  int ldh;
  const void* w;
  int ldw;
  const void* hd;
  const float* scd;
  const void* res_src;
  const float* res_sc;
  const float* skip_dosel;
  const int* skip_amax;
  const void* skip_dz;
  void* dzd;
  void* a_up;
  int lda;
  float* sdse;
  float* part;
  int64_t rows;
  int cd, cu, pool, chunk_rows;
};

template <typename T, bool DOWN_BN, int RES>
DaEpilogue<T, DOWN_BN, RES> epilogue_of(const DaArgs& a) {
  return {static_cast<const T*>(a.hd),    static_cast<const T*>(a.res_src),
          a.skip_dosel,                   a.skip_amax,
          static_cast<const T*>(a.skip_dz), static_cast<T*>(a.dzd),
          static_cast<T*>(a.a_up),        a.lda,
          a.cd,                           a.pool};
}

template <typename T>
int bwd_dh(const void* hu, const void* dz, const float* dosel, const int* amax,
           const float* uc, void* dh, int64_t rows, int cu, int ldh, int pool,
           cudaStream_t s) {
  const bool sparse = dz == nullptr;
  const int run = sparse ? pool : kDenseRun;
  if (ldh % kStrip != 0 || ldh < cu || run < 1 || (sparse && rows % pool != 0))
    return kBadArgs;
  const int64_t n = (rows + run - 1) / run * (ldh / kStrip);
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  const T* h = static_cast<const T*>(hu);
  T* out = static_cast<T*>(dh);
  if (sparse) {
    bwd_dh_kernel<T, true><<<blocks, kThreads, 0, s>>>(h, nullptr, dosel, amax, uc,
                                                       out, rows, cu, ldh, run);
  } else {
    bwd_dh_kernel<T, false><<<blocks, kThreads, 0, s>>>(
        h, static_cast<const T*>(dz), nullptr, nullptr, uc, out, rows, cu, ldh, run);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool DOWN_BN, int RES>
int da_bf16(const DaArgs& a, cudaStream_t s) {
  if (a.chunk_rows % kBT != 0 || a.ldh % 8 != 0 || a.ldw % 8 != 0 || a.lda % 8 != 0)
    return kBadArgs;
  CUtensorMap map_dh, map_w;
  if (!hopper::bf16_map(&map_dh, a.dh, a.cu, a.rows, a.ldh, kBK, kBT) ||
      !hopper::bf16_map(&map_w, a.w, a.cu, a.cd, a.ldw, kBK, kBT))
    return kBadArgs;
  const void* kernel = reinterpret_cast<const void*>(&bwd_da_wgmma_kernel<DOWN_BN, RES>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDaSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = chunks_of(a.rows, a.chunk_rows);
  bwd_da_wgmma_kernel<DOWN_BN, RES>
      <<<dim3((a.cd + kBT - 1) / kBT, chunks), kTmaThreads, kDaSmemBytes, s>>>(
          map_dh, map_w, epilogue_of<bf16, DOWN_BN, RES>(a), a.scd, a.res_sc, a.part,
          a.rows, a.cu, a.chunk_rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  return DOWN_BN ? colsum(a.part, a.sdse, chunks, 2 * static_cast<int64_t>(a.cd), s)
                 : 0;
}

template <bool DOWN_BN, int RES>
int da_f32(const DaArgs& a, cudaStream_t s) {
  if (a.chunk_rows % TM != 0 || a.ldw != a.cu) return kBadArgs;
  using L = Lds<float, TM>;
  cudaError_t err =
      set_smem<L>(reinterpret_cast<const void*>(&bwd_da_f32_kernel<DOWN_BN, RES>));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = chunks_of(a.rows, a.chunk_rows);
  bwd_da_f32_kernel<DOWN_BN, RES>
      <<<dim3((a.cd + TN - 1) / TN, chunks), kThreads, L::total, s>>>(
          static_cast<const float*>(a.dh), a.ldh, static_cast<const float*>(a.w),
          epilogue_of<float, DOWN_BN, RES>(a), a.scd, a.res_sc, a.part, a.rows, a.cu,
          a.chunk_rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  return DOWN_BN ? colsum(a.part, a.sdse, chunks, 2 * static_cast<int64_t>(a.cd), s)
                 : 0;
}

template <bool BF16>
int bwd_da(const DaArgs& a, int res_mode, cudaStream_t s) {
  const bool down_bn = a.scd != nullptr;
  const bool skips = a.skip_dosel != nullptr || a.skip_dz != nullptr;
  if ((res_mode != kResNone || skips) && !down_bn) return kBadArgs;
#define MLP_CHAIN_DA(D, R) return BF16 ? da_bf16<D, R>(a, s) : da_f32<D, R>(a, s)
  if (!down_bn) MLP_CHAIN_DA(false, kResNone);
  if (res_mode == kResNone) MLP_CHAIN_DA(true, kResNone);
  if (res_mode == kResBnRelu) MLP_CHAIN_DA(true, kResBnRelu);
  if (res_mode == kResDense) MLP_CHAIN_DA(true, kResDense);
#undef MLP_CHAIN_DA
  return kBadArgs;
}

template <int BN>
int dw_bf16(const void* dh, int ldh, const void* ain, int lda, float* dw,
            float* dw_part, int64_t rows, int cd, int cu, int chunk_rows,
            cudaStream_t s) {
  if (chunk_rows % kBK != 0 || ldh % 8 != 0 || lda % 8 != 0) return kBadArgs;
  CUtensorMap map_dh, map_a;
  if (!hopper::bf16_map(&map_dh, dh, cu, rows, ldh, kBK, kBK) ||
      !hopper::bf16_map(&map_a, ain, cd, rows, lda, kBK, kBK))
    return kBadArgs;
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(&bwd_dw_wgmma_kernel<BN>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, kDwSmemBytes<BN>);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = chunks_of(rows, chunk_rows);
  bwd_dw_wgmma_kernel<BN>
      <<<dim3((cu + kBT - 1) / kBT, (cd + BN - 1) / BN, chunks), kTmaThreads,
         kDwSmemBytes<BN>, s>>>(map_dh, map_a, dw_part, rows, cd, cu, chunk_rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  return colsum(dw_part, dw, chunks, static_cast<int64_t>(cd) * cu, s);
}

int dw_f32(const float* dh, int ldh, const float* ain, int lda, float* dw,
           float* dw_part, int64_t rows, int cd, int cu, int chunk_rows,
           cudaStream_t s) {
  if (chunk_rows % KC != 0) return kBadArgs;
  using L = Lds<float, kARows>;
  cudaError_t err = set_smem<L>(reinterpret_cast<const void*>(&bwd_dw_f32_kernel));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = chunks_of(rows, chunk_rows);
  bwd_dw_f32_kernel<<<dim3((cu + TN - 1) / TN, (cd + kARows - 1) / kARows, chunks),
                      kThreads, L::total, s>>>(dh, ldh, ain, lda, dw_part, rows, cd,
                                               cu, chunk_rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  return colsum(dw_part, dw, chunks, static_cast<int64_t>(cd) * cu, s);
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
// Scratch: part (ceil(rows / chunk_rows), 2, cu) fp32. panel_rows 0: the
// 64 x 128 tiles of tile_mma.cuh (fp32; bf16 widths fwd_plan sends there),
// chunk_rows a multiple of 64. panel_rows 64 or 128 (bf16 only): the TMA +
// wgmma kernel with panels of that many rows, wn (64 or 128) channels a
// consumer, `stages` ring stages and `slots` panel slots; chunk_rows a
// multiple of panel_rows, cu a multiple of 8 (and cd below a BatchNorm),
// every pointer 16-byte aligned.
extern "C" int mlp_mm_stats_launch(const void* a_in, const float* sc,
                                   int res_mode, const void* res_src,
                                   const float* res_sc, const void* w,
                                   void* h_out, void* r_out, float* stats,
                                   float* part, long long rows, int cd, int cu,
                                   int chunk_rows, int panel_rows, int wn, int stages,
                                   int slots, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FwdGeom geo{};
  if (panel_rows != 0) {
    if (!is_bf16 || wn <= 0) return kBadArgs;
    const int nt = panel_rows == 128 ? wn : 2 * wn;
    geo = FwdGeom{panel_rows, wn, (cd + 63) / 64, slots, stages, nt, (cu + nt - 1) / nt};
  }
  const FwdGeom* g = panel_rows != 0 ? &geo : nullptr;
  if (is_bf16) {
    return mm_stats_any<bf16>(a_in, sc, res_mode, res_src, res_sc, w, h_out,
                              r_out, stats, part, rows, cd, cu, chunk_rows, g, s);
  }
  return mm_stats_any<float>(a_in, sc, res_mode, res_src, res_sc, w, h_out,
                             r_out, stats, part, rows, cd, cu, chunk_rows, g, s);
}

// The pool pass over h (groups * pool, C): out (groups, C) in T, maxv and
// hsel fp32, amax int32; sc (>= 3, C) fp32; pen (groups * pool,) fp32, or
// NULL (no mask, no sentinel). The launch is bn_pool_plan's: `vec` channels
// a thread (8: C a multiple of 8 and every base 16-byte aligned; else 1),
// blocks of `strips` x `slices` x `per_block` threads.
extern "C" int mlp_bn_pool_launch(const void* h, const float* sc, int res_mode,
                                  const void* res_src, const float* res_sc,
                                  const float* pen, void* out, float* maxv,
                                  int* amax, float* hsel, long long groups,
                                  int c, int pool, int final_relu, int is_bf16, int vec,
                                  int strips, int slices, int per_block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return bn_pool_any<bf16>(h, sc, res_mode, res_src, res_sc, pen, out, maxv, amax,
                             hsel, groups, c, pool, final_relu, vec, strips, slices,
                             per_block, s);
  }
  return bn_pool_any<float>(h, sc, res_mode, res_src, res_sc, pen, out, maxv, amax,
                            hsel, groups, c, pool, final_relu, vec, strips, slices,
                            per_block, s);
}

// One backward pass is three launches (and colsum_kernel's).
//
// dh (rows, ldh) in T, ldh a multiple of 8 >= cu: the layer's dh, from hu
// (rows, cu) and uc (4, cu) fp32, with dz (rows, cu), or dz NULL for the
// pooled layer with dosel (rows / pool, cu) fp32 at row amax (int32) of each
// group.
extern "C" int mlp_bwd_dh_launch(const void* hu, const void* dz, const float* dosel,
                                 const int* amax, const float* uc, void* dh,
                                 long long rows, int cu, int ldh, int pool,
                                 int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return bwd_dh<bf16>(hu, dz, dosel, amax, uc, dh, rows, cu, ldh, pool, s);
  return bwd_dh<float>(hu, dz, dosel, amax, uc, dh, rows, cu, ldh, pool, s);
}

// da = dh @ w^T with dh (rows, ldh) and w (cd, ldw) (cu channels of each row
// read), then: below a BatchNorm (scd (4, cd) fp32 of hd = h_{u-1} (rows,
// cd)), with the residual of pre_{u-1} (res_mode, res_src, res_sc as for
// mlp_mm_stats_launch, at width cd) and the skip shares (skip_dosel (rows /
// pool, cd) fp32 at row skip_amax (int32) of each group, skip_dz (rows, cd);
// NULL when absent): dzd (rows, cd), a_up (rows, lda) = T(relu(pre)) and
// sdse (2, cd) fp32, through part (ceil(rows / chunk_rows), 2, cd) fp32; at
// the input layer (scd NULL) dzd = T(da) alone. bf16: TMA + wgmma, chunk_rows
// a multiple of 128, ldh, ldw and lda multiples of 8 and dh, w 16-byte
// aligned; fp32: CUDA cores, chunk_rows a multiple of 64, ldw = cu.
extern "C" int mlp_bwd_da_launch(const void* dh, int ldh, const void* w, int ldw,
                                 const void* hd, const float* scd, int res_mode,
                                 const void* res_src, const float* res_sc,
                                 const float* skip_dosel, const int* skip_amax,
                                 const void* skip_dz, void* dzd, void* a_up, int lda,
                                 float* sdse, float* part, long long rows, int cd,
                                 int cu, int pool, int chunk_rows, int is_bf16,
                                 void* stream) {
  const DaArgs a{dh,      ldh,       w,         ldw,   hd,  scd,  res_src,
                 res_sc,  skip_dosel, skip_amax, skip_dz, dzd, a_up, lda,
                 sdse,    part,      rows,      cd,    cu,  pool, chunk_rows};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? bwd_da<true>(a, res_mode, s) : bwd_da<false>(a, res_mode, s);
}

// dw (cd, cu) fp32 = ain^T @ dh over all rows, ain (rows, lda) the layer
// input (a_up, or the chain's input) with cd channels of each row read, dh
// (rows, ldh); through dw_part (ceil(rows / chunk_rows), cd, cu) fp32 summed
// in a fixed order. bf16: TMA + wgmma, chunk_rows a multiple of 64, lda and
// ldh multiples of 8, both 16-byte aligned, tiles of 128 output x tile_cols
// (128 or 192) input channels; fp32: chunk_rows a multiple of 32.
extern "C" int mlp_bwd_dw_launch(const void* dh, int ldh, const void* ain, int lda,
                                 float* dw, float* dw_part, long long rows, int cd,
                                 int cu, int chunk_rows, int tile_cols, int is_bf16,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 && tile_cols == 128)
    return dw_bf16<128>(dh, ldh, ain, lda, dw, dw_part, rows, cd, cu, chunk_rows, s);
  if (is_bf16 && tile_cols == 192)
    return dw_bf16<192>(dh, ldh, ain, lda, dw, dw_part, rows, cd, cu, chunk_rows, s);
  if (is_bf16) return kBadArgs;
  return dw_f32(static_cast<const float*>(dh), ldh, static_cast<const float*>(ain), lda,
                dw, dw_part, rows, cd, cu, chunk_rows, s);
}
