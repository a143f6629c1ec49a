// int8 GEMM with a dequantisation epilogue for Hopper (sm_90a).
//
// Replaces the TPU kernel mimrl_tpu/ops/pallas/int8_matmul.py::int8_matmul
// (kernel _matmul_kernel):
//
//     out[m, n] = float(sum_k a[m, k] * b[k, n]) * sa[m] * sb[n]
//
// a: [M, K] int8, row-major (K contiguous). bt: [N, K] int8, row-major: b
// transposed, so that both operands are contiguous along the contraction.
// That is the layout a quantised activation [rows, features] and a
// quantised ``nn.Linear`` weight [out, in] already have. sa: [M] float32,
// sb: [N] float32. out: [M, N] row-major, float32 or bfloat16.
//
// The products are accumulated in int32 on the tensor cores
// (mma.sync.m16n8k32.s8), which is exact, and the epilogue computes
// (float(acc) * sa[m]) * sb[n] in float32, in the reference's order, and
// rounds once to the output type. So the float32 output equals the plain
// version bit for bit, and the bfloat16 output after one rounding.
//
// Bound on the H100 (3.35 TB/s, 1979 TOP/s int8) at the largest forward
// shape of the canonical path, [12800, 768] x [768, 3072] -> bf16:
// 2 * M * N * K = 60.4 GOP -> 30.5 us; a, bt, the scales and out are
// 9.8 + 2.4 + 78.6 MB -> 27.1 us. The forward shapes sit near the ridge;
// the weight-gradient shapes (K = 12800, a [768..3072, 12800] by
// [12800, 768..3072] product into float32) are bound by operations.
//
// Design (a first version: mma.sync, no wgmma or TMA yet). One block of 8
// warps per 128 x 128 output tile; the block walks K in slices of 64
// bytes, staged in shared memory by cp.async in a four-stage ring, three
// slices in flight while one is multiplied (rows padded from 64 to 80
// bytes, so that the eight 16-byte rows of an ldmatrix phase fall into
// distinct banks). Each warp owns 64 x 32 of the tile: 4 x 4 mma tiles of
// 16 x 8, 64 int32 accumulators a thread. Fragments come from shared
// memory by ldmatrix.x4: an 8 x 8 matrix of 16-bit elements is 8 rows of
// 16 int8, and its register layout is the one the s8 mma defines. A
// weight-gradient product with a small M x N (768 x 768 is 36 blocks for
// 132 SMs) does not fill the card: splitting K is later work.
//
// Edges. Rows of a past M and rows of bt past N are read from the last
// valid row; they feed only outputs that are never stored. The tail of K
// is zero-filled in shared memory (cp.async with a short source size, or
// byte loads where a row start is not 16-byte aligned, that is where K is
// not a multiple of 16 or a base pointer is not aligned).
//
// Launch rules: the kernel runs on the caller's stream, allocates nothing
// and does not synchronise. The C entry point returns cudaGetLastError()
// after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;      // output rows per block
constexpr int kBN = 128;      // output columns per block
constexpr int kBK = 64;       // contraction bytes per stage
constexpr int kPitch = 80;    // shared-memory row stride in bytes
constexpr int kThreads = 256;
constexpr int kStages = 4;
constexpr int kWarpM = 64;    // warp tile: 4 mma tiles of 16 rows
constexpr int kWarpN = 32;    //            4 mma tiles of 8 columns
constexpr int kTileBytes = kBM * kPitch;  // one operand, one stage
constexpr int kSmemBytes = kStages * 2 * kTileBytes;

__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 8 matrices of 16-bit elements (8 rows of 16 int8 each); lane l
// gives the address of row l % 8 of matrix l / 8, and register j of lane t
// holds bytes 4 * (t % 4) .. + 3 of row t / 4 of matrix j
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// rows [row0, row0 + 128) x bytes [k0, k0 + 64) of a row-major int8 matrix
// [rows, k_len] -> a shared tile with row stride kPitch. Rows past the
// matrix repeat its last row; bytes past k_len are zero.
__device__ __forceinline__ void load_tile(int8_t* dst, const int8_t* src,
                                          int row0, int rows, int k0,
                                          int k_len, bool vec) {
  for (int c = threadIdx.x; c < kBM * (kBK / 16); c += kThreads) {
    const int r = c / (kBK / 16);
    const int kc = (c % (kBK / 16)) * 16;
    const int gr = min(row0 + r, rows - 1);
    const int k = k0 + kc;
    const int valid = max(0, min(16, k_len - k));
    int8_t* d = dst + r * kPitch + kc;
    const int8_t* row = src + (size_t)gr * k_len;
    if (vec) {
      cp_async_16(d, valid > 0 ? row + k : row, valid);
    } else {
      for (int i = 0; i < 16; ++i) d[i] = i < valid ? row[k + i] : (int8_t)0;
    }
  }
}

// one value, or two neighbours of one row (p aligned to the pair)
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

template <typename Out>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ bt,
                   const float* __restrict__ sa, const float* __restrict__ sb,
                   Out* __restrict__ out, int m_len, int n_len, int k_len,
                   int vec) {
  extern __shared__ __align__(16) int8_t smem[];
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int group = lane >> 2;  // the row (of a) or column (of b) in a tile
  const int tig = lane & 3;     // the 4-byte word along the contraction
  const int wm = (warp >> 2) * kWarpM;  // 2 warps along M
  const int wn = (warp & 3) * kWarpN;   // 4 warps along N
  // this lane's row address in an ldmatrix.x4: matrix lane / 8, row lane % 8.
  // a: matrices (rows 0-7, k 0-15), (rows 8-15, k 0-15), (rows 0-7, k 16-31),
  // (rows 8-15, k 16-31) of a 16-row tile = the registers a0..a3.
  // b: (tile j, k 0-15), (tile j, k 16-31), (tile j + 1, k 0-15),
  // (tile j + 1, k 16-31) = b0, b1 of two 8-column tiles.
  const int lm = lane >> 3, lr = lane & 7;
  const int a_off = (wm + (lm & 1) * 8 + lr) * kPitch + (lm >> 1) * 16;
  const int b_off = (wn + (lm >> 1) * 8 + lr) * kPitch + (lm & 1) * 16;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int k_tiles = (k_len + kBK - 1) / kBK;
  auto load_stage = [&](int kt) {
    int8_t* st = smem + (kt % kStages) * 2 * kTileBytes;
    load_tile(st, a, m0, m_len, kt * kBK, k_len, vec);
    load_tile(st + kTileBytes, bt, n0, n_len, kt * kBK, k_len, vec);
  };

  // one commit per slot, filled or not, so that the group of slice kt is
  // always the kt-th
#pragma unroll
  for (int kt = 0; kt < kStages - 1; ++kt) {
    if (kt < k_tiles) load_stage(kt);
    cp_async_commit();
  }

  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();  // slice kt has landed
    __syncthreads();  // for every thread; and slice kt - 1 is read no more
    if (kt + kStages - 1 < k_tiles) load_stage(kt + kStages - 1);
    cp_async_commit();

    const int8_t* as = smem + (kt % kStages) * 2 * kTileBytes;
    const int8_t* bs = as + kTileBytes;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t fa[4][4], fb[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(fa[i], as + a_off + i * 16 * kPitch + ks);
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, bs + b_off + j * 8 * kPitch + ks);
        fb[j][0] = r[0];
        fb[j][1] = r[1];
        fb[j + 1][0] = r[2];
        fb[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], fa[i], fb[j]);
    }
  }

  // epilogue: (float(acc) * sa[m]) * sb[n], one rounding, one store; a
  // thread holds two neighbouring columns of a row and stores them as one
  // pair where rows start pair-aligned (N even)
  const bool pairs = (n_len & 1) == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm + i * 16 + group + half * 8;
      if (row >= m_len) continue;
      const float s_row = sa[row];
      Out* out_row = out + (size_t)row * n_len;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn + j * 8 + tig * 2;
        if (col >= n_len) continue;
        const float v0 = __fmul_rn(
            __fmul_rn((float)acc[i][j][half * 2], s_row), sb[col]);
        if (col + 1 < n_len) {
          const float v1 = __fmul_rn(
              __fmul_rn((float)acc[i][j][half * 2 + 1], s_row), sb[col + 1]);
          if (pairs) {
            store2(out_row + col, v0, v1);
          } else {
            store1(out_row + col, v0);
            store1(out_row + col + 1, v1);
          }
        } else {
          store1(out_row + col, v0);
        }
      }
    }
  }
}

template <typename Out>
int launch(const void* a, const void* bt, const void* sa, const void* sb,
           void* out, int m_len, int n_len, int k_len, cudaStream_t stream) {
  const dim3 grid((n_len + kBN - 1) / kBN, (m_len + kBM - 1) / kBM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const int vec = (k_len % 16 == 0) && ((uintptr_t)a % 16 == 0) &&
                  ((uintptr_t)bt % 16 == 0);
  auto kern = int8_matmul_kernel<Out>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(bt),
      static_cast<const float*>(sa), static_cast<const float*>(sb),
      static_cast<Out*>(out), m_len, n_len, k_len, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// out_dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t value
// (0 = ok).
extern "C" int mimrl_int8_matmul(const void* a, const void* bt, const void* sa,
                                 const void* sb, void* out, int m_len,
                                 int n_len, int k_len, int out_dtype,
                                 void* stream) {
  if (m_len <= 0 || n_len <= 0 || k_len <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0)
    return launch<float>(a, bt, sa, sb, out, m_len, n_len, k_len, s);
  if (out_dtype == 1)
    return launch<__nv_bfloat16>(a, bt, sa, sb, out, m_len, n_len, k_len, s);
  return (int)cudaErrorInvalidValue;
}
