// Helpers shared by the attention forward and backward kernels: type
// conversion, warp reductions and the staging of a [rows, HD] tile of one
// head into shared memory as float32 (the SIMT instances); cp.async,
// ldmatrix and the bf16 mma.sync of the tensor-core instances.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mimrl {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// a float32 value rounded to the input dtype, as the reference casts P
// and dS before their products
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// rows [r0, r0 + rows) of one head's [T, HD] slice -> a float tile with
// row stride `stride`; rows at or past T are zero.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, int stride, const T* src,
                                          int r0, int rows, int t_len) {
  const int base = r0 * HD;
  const int limit = t_len * HD;
  for (int i = threadIdx.x; i < rows * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    dst[r * stride + d] = base + i < limit ? to_float(src[base + i]) : 0.f;
  }
}

// ---- the tensor-core instances (bf16 in, float32 sums) ----
//
// mma.sync.m16n8k16 fragments, g = lane / 4, t = lane % 4:
//   A (16 x 16, row-major): a0 (row g, cols 2t, 2t+1), a1 (row g + 8, the
//     same cols), a2 (row g, cols 2t + 8, 2t + 9), a3 (row g + 8, those);
//   B (16 x 8, given as its transpose, row-major [n][k]): b0 (k 2t, 2t+1 of
//     column g), b1 (k 2t + 8, 2t + 9 of column g);
//   C (16 x 8, float32): c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g + 8).
// So the C fragments of two neighbouring n8 tiles are, rounded to bf16 and
// packed in pairs, the A fragment of one k16 step: a product's result feeds
// the next product from registers.

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, bypassing L1; src_bytes < 16 zero-fills the rest
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// 4 bytes global -> shared (through L1); src_bytes 0 writes a zero
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four (two) 8 x 8 bf16 matrices from shared memory: lane l gives the
// address of row l % 8 of matrix l / 8. Plain: register j of lane l holds
// row l / 4, cols 2 (l % 4), +1 of matrix j. Transposed (.trans): register
// j holds rows 2 (l % 4), +1 of column l / 4.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// c += a . b, bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two float32 values rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A fragment of one k16 step from the C fragments of two n8 tiles
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Shared-memory rows of the tensor-core instances: the contraction over the
// head dim is padded to the mma depth of 16 (hd 8: columns 8-15 are zero),
// and every row carries 16 bytes more, so that the eight 16-byte rows an
// ldmatrix phase reads start in eight different bank groups.
template <int HD>
struct TcRow {
  static constexpr int kHDP = HD < 16 ? 16 : HD;  // padded contraction
  static constexpr int kStride = kHDP + 8;        // bf16 elements per row
  static constexpr int kKSteps = kHDP / 16;       // k16 steps over hd
  static constexpr int kDTiles = HD / 8;          // n8 tiles over hd
};

// rows [r0, r0 + rows) of one head's [T, HD] bf16 slice -> shared rows of
// TcRow<HD>::kStride elements by 16-byte cp.async; rows at or past T are
// zero-filled. Columns [HD, 16) of an hd-8 row are not written.
template <int HD>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int r0,
                                           int rows, int t_len) {
  constexpr int kChunks = HD / 8;
  for (int i = threadIdx.x; i < rows * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool in = r0 + r < t_len;
    cp_async_16(dst + r * TcRow<HD>::kStride + c,
                src + (size_t)(in ? r0 + r : 0) * HD + c, in ? 16 : 0);
  }
}

// zero columns [HD, 16) of `rows` shared rows (hd 8 only), before staging
template <int HD>
__device__ __forceinline__ void zero_pad_cols(bf16* dst, int rows) {
  if (HD >= 16) return;
  for (int r = threadIdx.x; r < rows; r += blockDim.x)
    *reinterpret_cast<uint4*>(dst + r * TcRow<HD>::kStride + HD) =
        make_uint4(0u, 0u, 0u, 0u);
}

// ldmatrix addresses, relative to the first row of a 16-row tile of a
// shared [rows][STRIDE] buffer, at column c0:
//   a_addr:  with ldsm_x4, the A fragment (rows of the tile are the rows of
//            A, the contraction runs along the row); with ldsm_x4_t, the B
//            fragments of two n8 tiles of columns c0..c0+7 and c0+8..c0+15
//            when the rows of the tile are the contraction (b0, b1, then
//            b0, b1)
//   bn_addr: with ldsm_x4, the B fragments of two n8 tiles when the rows
//            of the tile are the n index (rows 0-7, then 8-15) and the
//            contraction runs along the row
template <int STRIDE>
__device__ __forceinline__ int a_addr(int lane, int c0) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * STRIDE + c0 + (lane >> 4) * 8;
}
template <int STRIDE>
__device__ __forceinline__ int bn_addr(int lane, int c0) {
  return ((lane & 7) + (lane >> 4) * 8) * STRIDE + c0 + ((lane >> 3) & 1) * 8;
}

// exp of a softmax exponent x <= 0 in the tensor-core instances:
// ex2.approx(x * log2 e), a few ulp from expf and far below the bf16
// rounding of P that follows (2^-8), in two instructions where expf takes
// about ten; results below 2^-126 flush to 0.
__device__ __forceinline__ float softmax_exp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// the max and the sum over the four lanes of a quad (one row of a C fragment)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace mimrl
