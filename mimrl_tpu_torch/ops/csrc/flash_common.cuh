// Helpers shared by the attention forward and backward kernels: type
// conversion, warp reductions and the staging of a [rows, HD] tile of one
// head into shared memory as float32 (the SIMT instances); cp.async,
// ldmatrix and the bf16 mma.sync of the bf16 tensor-core instances; the
// float32 rows and 3xTF32 fragments of the float32 tensor-core instances.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

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

// ---- the float32 tensor-core instances (3xTF32, tf32x3.cuh) ----
//
// Rows of hd float32 values in shared memory, padded by 4 floats: a stride
// of 4 mod 32 words (hd 32, 64, 128), so the eight rows g and four columns
// t that the lanes of one m16n8k8 fragment read fall into 32 distinct banks
// (hd 8 and 16, strides 12 and 20, are distinct as well). Every operand is
// read as scalars and split into hi and lo at its use.
template <int HD>
struct F32Row {
  static constexpr int kStride = HD + 4;  // floats per row
  static constexpr int kDTiles = HD / 8;  // n8 tiles (and k8 steps) over hd
};

// rows [r0, r0 + rows) of one head's [T, HD] float32 slice -> shared rows of
// F32Row<HD>::kStride floats by 16-byte cp.async; rows at or past T are
// zero-filled.
template <int HD>
__device__ __forceinline__ void stage_rows_f32(float* dst, const float* src,
                                               int r0, int rows, int t_len) {
  constexpr int kChunks = HD / 4;
  for (int i = threadIdx.x; i < rows * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = (i % kChunks) * 4;
    const bool in = r0 + r < t_len;
    cp_async_16(dst + r * F32Row<HD>::kStride + c,
                src + (size_t)(in ? r0 + r : 0) * HD + c, in ? 16 : 0);
  }
}

// the A operand of one k8 step, split into hi and lo
struct Tf32A {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ void split_a(Tf32A& a, float a0, float a1, float a2,
                                        float a3) {
  split_tf32(a0, a.hi[0], a.lo[0]);
  split_tf32(a1, a.hi[1], a.lo[1]);
  split_tf32(a2, a.hi[2], a.lo[2]);
  split_tf32(a3, a.hi[3], a.lo[3]);
}

// A from a 16 x 8 tile of shared rows (stride S) at `p` = the tile's row g,
// column t: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
template <int S>
__device__ __forceinline__ void load_a(Tf32A& a, const float* p) {
  split_a(a, p[0], p[8 * S], p[4], p[8 * S + 4]);
}

// A from the C fragment of a product whose columns are the contraction of
// the next one: c holds columns 2t and 2t + 1 of rows g and g + 8, which the
// A fragment takes as its columns t and t + 4, so the contraction runs in the
// key order 0, 2, 4, 6, 1, 3, 5, 7 of the 8-column step, and the B operand
// is read in the same order (mma_b_perm). No shuffle.
__device__ __forceinline__ void c_to_a_perm(Tf32A& a, const float (&c)[4]) {
  split_a(a, c[0], c[2], c[1], c[3]);
}

// part += a . b in 3xTF32, the small terms first; b0, b1 as float32
__device__ __forceinline__ void mma_tf32x3(float (&part)[4], const Tf32A& a,
                                           float b0, float b1) {
  uint32_t b0h, b0l, b1h, b1l;
  split_tf32(b0, b0h, b0l);
  split_tf32(b1, b1h, b1l);
  mma_tf32(part, a.lo, b0h, b1h);
  mma_tf32(part, a.hi, b0l, b1l);
  mma_tf32(part, a.hi, b0h, b1h);
}

// part += a . B for one k8 step, B from shared memory whose rows are the n
// index and whose contraction runs along the row: `p` = row g (of the n8
// tile), column t
__device__ __forceinline__ void mma_b_rows(float (&part)[4], const Tf32A& a,
                                           const float* p) {
  mma_tf32x3(part, a, p[0], p[4]);
}

// the same with B's rows the contraction, in c_to_a_perm's order: `p` =
// row 2t (of the step), column g
template <int S>
__device__ __forceinline__ void mma_b_perm(float (&part)[4], const Tf32A& a,
                                           const float* p) {
  mma_tf32x3(part, a, p[0], p[S]);
}

__device__ __forceinline__ void zero4(float (&x)[4]) {
  x[0] = x[1] = x[2] = x[3] = 0.f;
}

__device__ __forceinline__ void add4(float (&acc)[4], const float (&part)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += part[e];
}

}  // namespace mimrl
