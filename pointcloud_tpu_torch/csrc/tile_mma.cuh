// Product tiles shared by the port's matrix-product kernels (sm_90a):
// dense_bn_pool.cu and mlp_chain.cu include this header.
//
// A block of 256 threads owns one 64 x 128 fp32 accumulator tile and adds
// A (64 x kc) @ B (kc x 128) to it from shared memory, in depth chunks of 32.
// bf16 operands go through the tensor cores (nvcuda::wmma 16x16x16, fp32
// accumulators); fp32 operands run on the CUDA cores, 4 x 8 outputs a thread,
// so fp32 stays fp32 (no TF32).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace tile {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int TM = 64;   // rows of a product tile
constexpr int TN = 128;  // columns of a product tile
constexpr int KC = 32;   // depth staged per step

// Element type: conversions, and the padding (elements) that keeps the
// shared-memory tiles' leading dimensions multiples of 8 (bf16) or 4 (fp32),
// as wmma requires.
template <typename T>
struct Ty;
template <>
struct Ty<float> {
  static constexpr int kPad = 4;
  static __device__ __forceinline__ float to_f(float v) { return v; }
  static __device__ __forceinline__ float from_f(float v) { return v; }
};
template <>
struct Ty<bf16> {
  static constexpr int kPad = 8;
  static __device__ __forceinline__ float to_f(bf16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ bf16 from_f(float v) {
    return __float2bfloat16_rn(v);
  }
};

// A 64 x 128 fp32 accumulator tile held by the block's 256 threads:
// acc += A (64 x kc, row-major, lda) @ B (kc x 128, row-major, ldb), both in
// shared memory.
template <typename T>
struct Mma;

template <>
struct Mma<float> {  // CUDA cores: thread (ty, tx) owns rows 4ty.., cols tx + 16j
  float acc[4][8];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  __device__ __forceinline__ void run(const float* A, int lda, const float* B,
                                      int ldb, int kc) {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 4
    for (int k = 0; k < kc; ++k) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = A[(ty * 4 + i) * lda + k];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = B[k * ldb + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  __device__ __forceinline__ void store(float* Cs, int ldc) const {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) Cs[(ty * 4 + i) * ldc + tx + 16 * j] = acc[i][j];
  }
};

template <>
struct Mma<bf16> {  // tensor cores: warp (wr, wc) owns a 32 x 32 block
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> c[2][2];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(c[i][j], 0.f);
  }
  __device__ __forceinline__ void run(const bf16* A, int lda, const bf16* B,
                                      int ldb, int kc) {
    using namespace nvcuda;
    const int warp = threadIdx.x >> 5;
    const int wr = warp >> 2, wc = warp & 3;
    for (int kk = 0; kk < kc; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], A + (wr * 32 + 16 * i) * lda + kk, lda);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], B + kk * ldb + wc * 32 + 16 * j, ldb);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(c[i][j], a[i], b[j], c[i][j]);
    }
  }
  __device__ __forceinline__ void store(float* Cs, int ldc) const {
    using namespace nvcuda;
    const int warp = threadIdx.x >> 5;
    const int wr = warp >> 2, wc = warp & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + (wr * 32 + 16 * i) * ldc + wc * 32 + 16 * j,
                                c[i][j], ldc, wmma::mem_row_major);
  }
};

}  // namespace tile
