// Fused CubeMLP axis-MLP for Hopper (sm_90a).
//
// Replaces the TPU kernel mimrl_tpu/ops/pallas/cubemlp_kernel.py::_run_fused
// (kernel _kernel), for all three axes:
//
//     y = act(x *_axis w1 + b1) *_axis w2 + b2
//
// over one axis of x [bs, L, K, D] float32: two chained contractions of that
// axis with a bias and an activation between them. The hidden tensor stays
// in shared memory (or registers) and never reaches device memory; x is read
// once and y written once. The activation is the registry's own (exact erf
// gelu, not the tanh form the TPU kernel had to use).
//
// One view serves the three axes: x is [outer, C, inner] with C the
// contracted axis (axis 1: [bs, L, K*D]; axis 2: [bs*L, K, D]; axis 3:
// [bs*L*K, D, 1]). A *position* is one (outer, inner) pair, a vector of C
// values with stride `inner`; its result is n_out values with that stride.
//
// Two kernels; the wrapper's plan (ops/cubemlp_kernel.py::plan) picks one
// from the shape alone and the entry point launches it or fails:
//
// * tf32x3 (every shape whose weights fit in shared memory): the two
//   contractions as GEMMs on the tensor cores, Y[j, p] = sum_c W[c, j] X[c, p]
//   over the block's positions p, with mma.sync.m16n8k8 tf32. Float32 means
//   float32 in this port (plain TF32 is switched off, device.py), and one
//   TF32 pass keeps 10 mantissa bits (about 1e-3 off), so each operand is
//   split as hi = tf32(v), lo = tf32(v - hi), both rounded to nearest, and
//   the product is taken as lo*hi + hi*lo + hi*hi (3xTF32, tf32x3.cuh,
//   shared with the float32 attention instances): about 2^-22 of
//   each product is lost (the lo*lo term and lo's rounding). The tensor
//   cores sum 16 contraction terms at a time; the chunks are added in
//   float32 on the FP32 pipes.
//   Both weights are staged once per block by cp.async, zero-padded to the
//   MMA tile, each in its own orientation (16-byte copies along its
//   contiguous axis), and stay resident while a persistent grid walks tiles
//   of 64 positions. The first tile's x and w1 form one cp.async group and
//   w2 a second, so the first GEMM starts before w2 has landed. A tile of x
//   is copied by cp.async (16 bytes where sizes and alignment allow, lanes
//   along the contiguous axis, no division per element); the next tile's
//   copy starts as soon as every warp is past the first GEMM and runs under
//   the second. The hidden tile goes through shared memory (bias in the
//   first GEMM's epilogue, the activation in one pass per warp over its
//   own block, so that its code is inlined once);
//   the output goes from the accumulators to device memory, every 32-byte
//   sector whole. Two layouts of the x tile: *rows* (inner == 1, the D mix:
//   64 consecutive rows of x, stored [position][c]) and *cols* (inner > 1,
//   the L mix: 64 consecutive inner indices of one outer index, stored
//   [c][position]). Shared-memory pitches are 4 or 8 mod 32 words, so the
//   MMA fragment reads are free of bank conflicts. Warps own 16 (cols) or
//   32 (rows) output units by 32 positions of the tile.
// * kmix (an MLP of at most 8 units on each side over an axis with a
//   trailing extent that is a multiple of 4: the K mix, 3 -> 3 -> 3): one
//   thread owns a float4 of four neighbouring inner indices of one outer
//   index, reads its C float4 once, evaluates the MLP from weights in shared
//   memory (a broadcast), and writes its n_out float4. A 2-D grid (inner,
//   outer) so that no index is divided. Bound by bytes.
//
// Bounds on the H100 (3.35 TB/s; 495 TFLOP/s TF32 on the tensor cores, so
// 165 TFLOP/s of 3xTF32 products; 67 TFLOP/s float32 on the FP32 pipes) at
// the canonical encoder's shapes, bs 128:
//   D mix [128, 50, 3, 128] 128 -> 128 -> 128: 1.26 GFLOP -> 7.6 us as
//     3xTF32 (18.8 on the FP32 pipes) against 19.8 MB -> 5.9 us: operations;
//     [128, 10, 3, 128]: 1.5 us, operations.
//   L mix [128, 100, 3, 128] 100 -> 50 -> 50: 29.5 MB -> 8.8 us, bytes
//     (0.74 GFLOP -> 4.5 us as 3xTF32); [128, 50, 3, 128] 50 -> 10 -> 10:
//     3.5 us, bytes.
//   K mix [128, 50, 3, 128] and [128, 10, 3, 128], 3 -> 3 -> 3: 5.9 and
//     1.2 us, bytes.
// What holds tf32x3 back, read off phase clocks (clock64) of an
// instrumented build that is not kept: the second GEMM of a D-mix tile runs
// near the MMA rate mma.sync reaches with TF32; the weights' arrival at the
// start of every block (each block reads them from L2) costs about as much
// as a tile's second GEMM; a D-mix tile of 64 rows leaves the 300 tiles of
// block 0 at 2.3 per SM, so some SMs take 3.
//
// Tried and dropped: the first version of this file, one FP32-pipe
// kernel for all shapes with the weights restaged in 32-row pieces per
// pass, a `/ inner` and `% inner` per element in its strided loaders and a
// narrow layout for the K mix; it read 0.288 ms for the six canonical
// launches against a 0.044 ms bound. In this design (timed with build-time
// options since removed, so only the verdicts stay): a split by truncation
// with one tensor-core accumulator over the whole contraction (faster, but
// a float32 --use_pallas train step's gradients then missed those through
// the plain version by more than that route check's 1e-3; the rounded split
// alone missed too, the chunks of 16 terms with it pass); cvt.rna.tf32.f32
// for the rounding (the same bits as the two integer operations, slower);
// the small terms in an accumulator of their own (slower); plain loads
// through registers (each thread's loads waited one after another); 4-byte
// copies of the weights in one orientation (slow to arrive); unrolling the
// K loop by 1 or 4 (no change); the D mix on wgmma (m64n32k8 tf32, the
// weight as A split in registers, x and the hidden tile as hi and lo in
// the 128-byte swizzle, chunks of 16 to 64 terms in flight two at a time):
// as accurate, but slower, its tiles cut to 32 rows to fit beside the two
// resident weights, and most of a tile's time outside the products.
// Weights split into hi and lo once in shared
// memory (instead of per fragment) do not fit beside the D mix's tiles: two
// 128 x 128 weights would need 256 KB.
//
// Launch rules: the kernels run on the caller's stream, allocate nothing and
// do not synchronise. The entry point sets each kernel's shared-memory limit
// once per device, and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;        // positions per tile
constexpr int kWarpN = 4;        // 8-position MMA tiles per warp
constexpr int kTilePitch = kTile + 8;  // [unit][position] rows: 8 mod 32
constexpr int kMaxSmem = 232448;       // what one block can use on an H100
constexpr int kKmixMax = 8;      // kmix: most units on each side

// the wrapper's INSTANCES tuple
enum Instance { kKmix = 0, kRows = 1, kCols = 2 };

enum Activation {
  kElu = 0, kGelu, kHardshrink, kHardtanh, kLeakyRelu, kPRelu, kRelu, kRRelu,
  kTanh, kActivations
};

// a uniform branch: every thread of the launch takes the same case
__device__ __forceinline__ float activate(int act, float x) {
  switch (act) {
    case kElu: return x > 0.f ? x : expm1f(x);
    case kGelu: return 0.5f * x * (1.f + erff(x * 0.70710678118654752440f));
    case kHardshrink: return fabsf(x) > 0.5f ? x : 0.f;
    case kHardtanh: return fminf(fmaxf(x, -1.f), 1.f);
    case kLeakyRelu: return x > 0.f ? x : 0.01f * x;
    case kPRelu: return x > 0.f ? x : 0.25f * x;
    case kRelu: return fmaxf(x, 0.f);
    case kRRelu: return x > 0.f ? x : ((1.f / 8.f + 1.f / 3.f) / 2.f) * x;
    default: return tanhf(x);
  }
}

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// The shared-memory layout of the tf32x3 kernel, in floats (the wrapper's
// tf32x3_smem_bytes mirrors it): w1, w2, the x tile, the hidden tile
// [hp][kTilePitch], b1 [hp], b2 [op]. Units are padded to the warps' 16 * WM
// rows, contractions to the MMA's depth of 8, with zeros. A weight is held
// in its own orientation (stage_weight), so its region is the larger of the
// two.
struct TcLayout {
  int kp1, hp, op;  // padded contraction, hidden and output counts
  int px;           // row pitch of the x tile
  int w2s, xs, hs, b1s, b2s, floats;  // offsets, and the size
  __host__ __device__ static int weight_floats(int kp, int mp) {
    const int k_rows = kp * (round_up(mp, 32) + 8);
    const int m_rows = mp * (round_up(kp, 32) + 4);
    return k_rows > m_rows ? k_rows : m_rows;
  }
  __host__ __device__ TcLayout(bool rows, int n_in, int n_hidden, int n_out) {
    const int wm = rows ? 2 : 1;
    kp1 = round_up(n_in, 8);
    hp = round_up(n_hidden, 16 * wm);
    op = round_up(n_out, 16 * wm);
    // rows: [position][c], pitch 4 mod 32; cols: [c][position], 8 mod 32
    px = rows ? round_up(kp1, 32) + 4 : kTilePitch;
    w2s = weight_floats(kp1, hp);
    xs = w2s + weight_floats(hp, op);
    hs = xs + (rows ? kTile * px : kp1 * kTilePitch);
    b1s = hs + hp * kTilePitch;
    b2s = b1s + hp;
    floats = b2s + op;
  }
};

using mimrl::mma_tf32;
using mimrl::split_tf32;  // tf32x3.cuh

// A weight in shared memory as the MMA's A operand: A[m][k] = ws[m * sm +
// k * sk] (m a unit, k the contraction)
struct AOperand {
  const float* ws;
  int sm, sk;
};

// acc[mi][ni] += A B over k < k_len for the warp's units m0 .. m0 + 16 WM and
// positions n0 .. n0 + 8 kWarpN, in 3xTF32 (lo*hi + hi*lo + hi*hi). The
// tensor cores sum chunks of 16 contraction terms (two k-steps) from zero;
// each chunk is added to acc in float32 on the FP32 pipes (one tensor-core
// accumulator over the whole contraction drifted further from the plain
// version: the note at the top). B[k][n] = bs[n * pb + k] with B_ROWS, else bs[k * pb + n].
// Fragments of m16n8k8: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8,
// t + 4); b0 (t, g), b1 (t + 4, g); g = lane / 4, t = lane % 4.
template <int WM, bool B_ROWS>
__device__ __forceinline__ void mma_tile(float (&acc)[WM][kWarpN][4],
                                         const AOperand& a, const float* bs,
                                         int pb, int k_len, int m0, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int m8 = 8 * a.sm, m16 = 16 * a.sm, k4 = 4 * a.sk, k8 = 8 * a.sk;
  float part[WM][kWarpN][4];
  auto k_step = [&](int k0, const float* wk) {
    uint32_t ahi[WM][4], alo[WM][4];
#pragma unroll
    for (int mi = 0; mi < WM; ++mi) {
      split_tf32(wk[mi * m16], ahi[mi][0], alo[mi][0]);
      split_tf32(wk[mi * m16 + m8], ahi[mi][1], alo[mi][1]);
      split_tf32(wk[mi * m16 + k4], ahi[mi][2], alo[mi][2]);
      split_tf32(wk[mi * m16 + m8 + k4], ahi[mi][3], alo[mi][3]);
    }
#pragma unroll
    for (int ni = 0; ni < kWarpN; ++ni) {
      const int n = n0 + ni * 8 + g;
      const float v0 = B_ROWS ? bs[n * pb + k0 + t] : bs[(k0 + t) * pb + n];
      const float v1 =
          B_ROWS ? bs[n * pb + k0 + t + 4] : bs[(k0 + t + 4) * pb + n];
      uint32_t b0h, b0l, b1h, b1l;
      split_tf32(v0, b0h, b0l);
      split_tf32(v1, b1h, b1l);
#pragma unroll
      for (int mi = 0; mi < WM; ++mi) {  // small terms first
        mma_tf32(part[mi][ni], alo[mi], b0h, b1h);
        mma_tf32(part[mi][ni], ahi[mi], b0l, b1l);
        mma_tf32(part[mi][ni], ahi[mi], b0h, b1h);
      }
    }
  };
  const float* wk = a.ws + (m0 + g) * a.sm + t * a.sk;
  for (int k0 = 0; k0 < k_len; k0 += 16, wk += 2 * k8) {
#pragma unroll
    for (int mi = 0; mi < WM; ++mi)
#pragma unroll
      for (int ni = 0; ni < kWarpN; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mi][ni][e] = 0.f;
    k_step(k0, wk);
    if (k0 + 8 < k_len) k_step(k0 + 8, wk + k8);
#pragma unroll
    for (int mi = 0; mi < WM; ++mi)
#pragma unroll
      for (int ni = 0; ni < kWarpN; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] += part[mi][ni][e];
  }
}

// asynchronous copies to shared memory (cp.async): every load of a tile is
// in flight at once, and none holds a register
template <int VEC>
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (VEC == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
                 "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d),
                 "l"(src) : "memory");
}

__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// all but the newest group complete
__device__ __forceinline__ void wait_async_but_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

template <int VEC>
__device__ __forceinline__ void zero_vec(float* dst) {
  if (VEC == 4)
    *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  else
    *dst = 0.f;
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Stages the weight w[c, j] = w[c * sc + j * sj] (c < n_c contracted, j <
// n_j units) by cp.async as an A operand zero-padded to kp x mp, in the
// weight's own orientation, so that the copies run along its contiguous
// axis, 16 bytes at a time where rows and base are aligned: [j][c] (pitch
// 4 mod 32) for an nn.Linear weight's transposed view (sc == 1), else
// [c][j] (pitch 8 mod 32). Both orientations read conflict-free fragments.
__device__ AOperand stage_weight(float* ws, const float* w, int sc, int sj,
                                 int n_c, int n_j, int kp, int mp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool k_inner = sc == 1 && sj != 1;
  // rows a (stride sa), contiguous b (stride sb), padded to pa x pb
  const int n_a = k_inner ? n_j : n_c, n_b = k_inner ? n_c : n_j;
  const int pa = k_inner ? mp : kp, pb = k_inner ? kp : mp;
  const int sa = k_inner ? sj : sc, sb = k_inner ? sc : sj;
  const int pitch = k_inner ? round_up(kp, 32) + 4 : round_up(mp, 32) + 8;
  const bool vec = sb == 1 && sa % 4 == 0 && aligned16(w);
  for (int a = warp; a < pa; a += kWarps)
    for (int b = 4 * lane; b < pb; b += 128) {
      float* dst = ws + a * pitch + b;
      const float* src = w + (size_t)a * sa + (size_t)b * sb;
      if (vec && a < n_a && b + 3 < n_b) {
        copy_async<4>(dst, src);
        continue;
      }
      for (int e = 0; e < 4; ++e) {
        if (a < n_a && b + e < n_b)
          copy_async<1>(dst + e, src + (size_t)e * sb);
        else
          dst[e] = 0.f;
      }
    }
  return k_inner ? AOperand{ws, pitch, 1} : AOperand{ws, 1, pitch};
}

// Walks the items (r, v) of an [n_r][n_v] grid dealt round-robin to the
// block's threads, without a division per item: the thread's first item
// and the stride are split into (row, column) once.
struct Walk {
  int r0, v0, dr, dv;
  __device__ Walk(int n_v) {
    r0 = threadIdx.x / n_v;
    v0 = threadIdx.x % n_v;
    dr = kThreads / n_v;
    dv = kThreads % n_v;
  }
  template <typename F>
  __device__ __forceinline__ void run(int n_r, int n_v, F f) const {
    for (int r = r0, v = v0; r < n_r;) {
      f(r, v);
      r += dr;
      v += dv;
      if (v >= n_v) {
        v -= n_v;
        ++r;
      }
    }
  }
};

// ROWS: the D mix (inner == 1). VEC: floats per load of x (4 where the rows,
// or the trailing axis, hold whole float4 and x is 16-byte aligned).
//
// A block stages both weights, then for each of its tiles: waits for the
// tile of x (cp.async), computes the hidden tile into shared memory, starts
// the next tile's copy into the x tile's place (free once every warp is past
// the first GEMM), and computes the output tile, stored from the
// accumulators (every 32-byte sector whole).
template <bool ROWS, int VEC>
__global__ void __launch_bounds__(kThreads, 2)
axis_mlp_tf32x3_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                       const float* __restrict__ w2,
                       const float* __restrict__ b1,
                       const float* __restrict__ b2, float* __restrict__ y,
                       long long outer, int n_in, int n_hidden, int n_out,
                       int inner, int w1_sc, int w1_sj, int w2_sc, int w2_sj,
                       int act) {
  constexpr int WM = ROWS ? 2 : 1;
  constexpr int kShift = VEC == 4 ? 4 : 6;  // log2(kTile / VEC)
  extern __shared__ __align__(16) float smem[];
  const TcLayout L(ROWS, n_in, n_hidden, n_out);
  float* xs = smem + L.xs;
  float* hs = smem + L.hs;
  float* b1s = smem + L.b1s;
  float* b2s = smem + L.b2s;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  for (int j = threadIdx.x; j < L.hp; j += kThreads)
    b1s[j] = b1 != nullptr && j < n_hidden ? b1[j] : 0.f;
  for (int j = threadIdx.x; j < L.op; j += kThreads)
    b2s[j] = b2 != nullptr && j < n_out ? b2[j] : 0.f;

  const long long tiles_i = ROWS ? 1 : (inner + kTile - 1) / kTile;
  const long long n_tiles = ROWS ? (outer + kTile - 1) / kTile : outer * tiles_i;
  const Walk x_walk(ROWS ? L.kp1 / VEC : 1);  // rows: [position][c / VEC]
  const int units1 = L.hp / (16 * WM) * (kTile / (8 * kWarpN));
  const int units2 = L.op / (16 * WM) * (kTile / (8 * kWarpN));

  // a tile's first position: rows, its row of x; cols, its inner index
  // i0 of outer index o; and its positions, at most kTile
  auto locate = [&](long long tile, long long& o, int& i0, int& n_valid) {
    if (ROWS) {
      o = tile * kTile;
      i0 = 0;
      n_valid = (int)min((long long)kTile, outer - o);
    } else {
      o = tile / tiles_i;
      i0 = (int)(tile - o * tiles_i) * kTile;
      n_valid = min(kTile, inner - i0);
    }
  };
  // the tile's x, zero past its last position and past n_in, by cp.async
  auto load_x = [&](long long tile) {
    long long o;
    int i0, n_valid;
    locate(tile, o, i0, n_valid);
    if (ROWS) {
      const float* xt = x + o * n_in;
      x_walk.run(kTile, L.kp1 / VEC, [&](int r, int v) {
        const int c = v * VEC;
        if (r < n_valid && c < n_in)
          copy_async<VEC>(xs + r * L.px + c, xt + (size_t)r * n_in + c);
        else
          zero_vec<VEC>(xs + r * L.px + c);
      });
    } else {
      const float* xt = x + o * n_in * inner + i0;
      for (int i = threadIdx.x; i < (L.kp1 << kShift); i += kThreads) {
        const int c = i >> kShift, r = (i & ((1 << kShift) - 1)) * VEC;
        if (c < n_in && r < n_valid)
          copy_async<VEC>(xs + c * kTilePitch + r, xt + (size_t)c * inner + r);
        else
          zero_vec<VEC>(xs + c * kTilePitch + r);
      }
    }
  };

  // w1 and the first x tile, then w2, which the first tile needs only for
  // its second GEMM
  const AOperand a1 =
      stage_weight(smem, w1, w1_sc, w1_sj, n_in, n_hidden, L.kp1, L.hp);
  if (blockIdx.x < n_tiles) load_x(blockIdx.x);
  commit_async();
  const AOperand a2 = stage_weight(smem + L.w2s, w2, w2_sc, w2_sj, n_hidden,
                                   n_out, L.hp, L.op);
  commit_async();
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    long long o;
    int i0, n_valid;
    locate(tile, o, i0, n_valid);
    // this tile's x (on the first, and w1; w2 may still be in flight)
    if (tile == blockIdx.x) wait_async_but_one(); else wait_async();
    __syncthreads();  // ... for every thread; the last tile's hs is read

    // ---- hidden = act(w1^T x + b1) -> hs [unit][position] ----
    for (int u = warp; u < units1; u += kWarps) {
      const int m0 = (u >> 1) * 16 * WM, n0 = (u & 1) * 8 * kWarpN;
      float acc[WM][kWarpN][4] = {};
      mma_tile<WM, ROWS>(acc, a1, xs, L.px, L.kp1, m0, n0);
#pragma unroll
      for (int mi = 0; mi < WM; ++mi)
#pragma unroll
        for (int ni = 0; ni < kWarpN; ++ni) {
          const int j = m0 + mi * 16 + g, n = n0 + ni * 8 + 2 * t;
          const float* c = acc[mi][ni];
          *reinterpret_cast<float2*>(hs + j * kTilePitch + n) =
              make_float2(c[0] + b1s[j], c[1] + b1s[j]);
          *reinterpret_cast<float2*>(hs + (j + 8) * kTilePitch + n) =
              make_float2(c[2] + b1s[j + 8], c[3] + b1s[j + 8]);
        }
      // the activation over the warp's own block of hs, from one call site
      // (in the unrolled stores above it would be inlined 8 WM times)
      __syncwarp();
      float* hw = hs + m0 * kTilePitch + n0 + lane;
#pragma unroll 1
      for (int r = 0; r < 16 * WM; ++r)
        hw[r * kTilePitch] = activate(act, hw[r * kTilePitch]);
    }
    if (tile == blockIdx.x) wait_async();  // w2
    __syncthreads();  // hs is written; every read of the x tile is done
    if (tile + gridDim.x < n_tiles) load_x(tile + gridDim.x);

    // ---- y = w2^T hidden + b2, from the accumulators to device memory ----
    float* yt = y + (ROWS ? o * n_out : (o * n_out * inner + i0));
    for (int u = warp; u < units2; u += kWarps) {
      const int m0 = (u >> 1) * 16 * WM, n0 = (u & 1) * 8 * kWarpN;
      float acc[WM][kWarpN][4] = {};
      mma_tile<WM, false>(acc, a2, hs, kTilePitch, L.hp, m0, n0);
#pragma unroll
      for (int mi = 0; mi < WM; ++mi)
#pragma unroll
        for (int ni = 0; ni < kWarpN; ++ni) {
          const int n = n0 + ni * 8 + 2 * t;
          const float* c = acc[mi][ni];
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // units j and j + 8
            const int j = m0 + mi * 16 + g + 8 * h;
            if (j >= n_out) continue;
            const float v0 = c[2 * h] + b2s[j], v1 = c[2 * h + 1] + b2s[j];
            if (ROWS) {  // y[position][unit]: 8 lanes, 32 bytes a position
              if (n < n_valid) yt[(size_t)n * n_out + j] = v0;
              if (n + 1 < n_valid) yt[(size_t)(n + 1) * n_out + j] = v1;
            } else if (VEC == 4) {  // n_valid is a multiple of 4
              if (n < n_valid)
                *reinterpret_cast<float2*>(yt + (size_t)j * inner + n) =
                    make_float2(v0, v1);
            } else {
              if (n < n_valid) yt[(size_t)j * inner + n] = v0;
              if (n + 1 < n_valid) yt[(size_t)j * inner + n + 1] = v1;
            }
          }
        }
    }
  }
}

// The K mix: thread (i4, o) computes the MLP for the four inner indices
// 4 i4 .. 4 i4 + 3 of outer index o (and o + the grid's height, ...). Its
// first loads of x are issued before the weights are staged, so the two
// latencies overlap. The activation is a template argument: inlined for
// each of the hidden units' float4, a run-time switch would put every
// activation's code in the loop.
template <int ACT>
__global__ void __launch_bounds__(kThreads)
axis_mlp_kmix_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                     const float* __restrict__ w2, const float* __restrict__ b1,
                     const float* __restrict__ b2, float* __restrict__ y,
                     long long outer, int n_in, int n_hidden, int n_out,
                     int inner, int w1_sc, int w1_sj, int w2_sc, int w2_sj) {
  __shared__ float w1s[kKmixMax][kKmixMax], w2s[kKmixMax][kKmixMax];
  __shared__ float b1s[kKmixMax], b2s[kKmixMax];
  const int inner4 = inner >> 2;
  const int i4 = blockIdx.x * blockDim.x + threadIdx.x;
  const long long step = (long long)gridDim.y * blockDim.y;
  long long o = (long long)blockIdx.y * blockDim.y + threadIdx.y;
  const bool active = i4 < inner4;
  float4 xv[kKmixMax], hv[kKmixMax];
  auto load = [&](long long oo) {
    const float4* xo =
        reinterpret_cast<const float4*>(x) + oo * n_in * inner4 + i4;
#pragma unroll
    for (int c = 0; c < kKmixMax; ++c)
      if (c < n_in) xv[c] = __ldg(xo + (size_t)c * inner4);
  };
  if (active && o < outer) load(o);

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  if (tid < kKmixMax * kKmixMax) {
    const int c = tid / kKmixMax, j = tid % kKmixMax;
    w1s[c][j] = c < n_in && j < n_hidden ? w1[c * w1_sc + j * w1_sj] : 0.f;
    w2s[c][j] = c < n_hidden && j < n_out ? w2[c * w2_sc + j * w2_sj] : 0.f;
  }
  if (tid < kKmixMax) {
    b1s[tid] = b1 != nullptr && tid < n_hidden ? b1[tid] : 0.f;
    b2s[tid] = b2 != nullptr && tid < n_out ? b2[tid] : 0.f;
  }
  __syncthreads();
  if (!active) return;
  for (bool first = true; o < outer; o += step, first = false) {
    if (!first) load(o);
    float4* yo = reinterpret_cast<float4*>(y) + o * n_out * inner4 + i4;
#pragma unroll
    for (int j = 0; j < kKmixMax; ++j) {
      if (j >= n_hidden) break;
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int c = 0; c < kKmixMax; ++c) {
        if (c >= n_in) break;
        const float w = w1s[c][j];
        s.x = fmaf(xv[c].x, w, s.x);
        s.y = fmaf(xv[c].y, w, s.y);
        s.z = fmaf(xv[c].z, w, s.z);
        s.w = fmaf(xv[c].w, w, s.w);
      }
      const float b = b1s[j];
      hv[j] = make_float4(activate(ACT, s.x + b), activate(ACT, s.y + b),
                          activate(ACT, s.z + b), activate(ACT, s.w + b));
    }
#pragma unroll
    for (int k = 0; k < kKmixMax; ++k) {
      if (k >= n_out) break;
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < kKmixMax; ++j) {
        if (j >= n_hidden) break;
        const float w = w2s[j][k];
        s.x = fmaf(hv[j].x, w, s.x);
        s.y = fmaf(hv[j].y, w, s.y);
        s.z = fmaf(hv[j].z, w, s.z);
        s.w = fmaf(hv[j].w, w, s.w);
      }
      const float b = b2s[k];
      yo[(size_t)k * inner4] = make_float4(s.x + b, s.y + b, s.z + b, s.w + b);
    }
  }
}

// the kernel's shared-memory limit raised to the card's once per device
template <typename Kernel>
cudaError_t allow_smem(Kernel kern, unsigned& devices_done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 32 && (devices_done >> dev) & 1u) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
  if (err == cudaSuccess && dev < 32) devices_done |= 1u << dev;
  return err;
}

template <bool ROWS, int VEC>
int launch_tf32x3(const float* x, const float* w1, const float* w2,
                  const float* b1, const float* b2, float* y, long long outer,
                  int n_in, int n_hidden, int n_out, int inner, int w1_sc,
                  int w1_sj, int w2_sc, int w2_sj, int act, int grid, int smem,
                  cudaStream_t stream) {
  static unsigned devices_done = 0;
  auto kern = axis_mlp_tf32x3_kernel<ROWS, VEC>;
  const cudaError_t err = allow_smem(kern, devices_done);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, kThreads, smem, stream>>>(x, w1, w2, b1, b2, y, outer, n_in,
                                         n_hidden, n_out, inner, w1_sc, w1_sj,
                                         w2_sc, w2_sj, act);
  return (int)cudaGetLastError();
}

}  // namespace

// x: [outer, n_in, inner] float32 contiguous; y: [outer, n_out, inner].
// w1[c, j] = w1[c * w1_sc + j * w1_sj] for c < n_in, j < n_hidden; w2
// likewise for [n_hidden, n_out]. b1, b2: float32 vectors or both null.
// activation: the index of the name in the wrapper's ACTIVATIONS tuple;
// instance: its index in INSTANCES (0 kmix, 1 tf32x3 rows, 2 tf32x3 cols);
// vec, grid_x, grid_y, block_x and smem: the wrapper's plan. An instance
// that does not take these sizes is refused, never replaced by another.
// Returns a cudaError_t value (0 = ok).
extern "C" int mimrl_cubemlp_axis_mlp(const void* x, const void* w1,
                                      const void* w2, const void* b1,
                                      const void* b2, void* y, long long outer,
                                      int n_in, int n_hidden, int n_out,
                                      int inner, int w1_sc, int w1_sj,
                                      int w2_sc, int w2_sj, int activation,
                                      int instance, int vec, int grid_x,
                                      int grid_y, int block_x, int smem,
                                      void* stream) {
  const int bad = (int)cudaErrorInvalidValue;
  if (outer <= 0 || n_in <= 0 || n_hidden <= 0 || n_out <= 0 || inner <= 0 ||
      activation < 0 || activation >= kActivations || grid_x <= 0 ||
      grid_y <= 0)
    return bad;
  if ((b1 == nullptr) != (b2 == nullptr)) return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *xf = static_cast<const float*>(x),
              *w1f = static_cast<const float*>(w1),
              *w2f = static_cast<const float*>(w2),
              *b1f = static_cast<const float*>(b1),
              *b2f = static_cast<const float*>(b2);
  float* yf = static_cast<float*>(y);

  if (instance == kKmix) {
    if (n_in > kKmixMax || n_hidden > kKmixMax || n_out > kKmixMax ||
        inner % 4 != 0 || !aligned16(x) || !aligned16(y) || block_x <= 0 ||
        kThreads % block_x != 0 || (long long)grid_x * block_x < inner / 4)
      return bad;
    const dim3 grid(grid_x, grid_y), block(block_x, kThreads / block_x);
#define MIMRL_KMIX_CASE(ACT)                                                  \
  case ACT:                                                                   \
    axis_mlp_kmix_kernel<ACT><<<grid, block, 0, s>>>(                         \
        xf, w1f, w2f, b1f, b2f, yf, outer, n_in, n_hidden, n_out, inner,      \
        w1_sc, w1_sj, w2_sc, w2_sj);                                          \
    break
    switch (activation) {
      MIMRL_KMIX_CASE(kElu);
      MIMRL_KMIX_CASE(kGelu);
      MIMRL_KMIX_CASE(kHardshrink);
      MIMRL_KMIX_CASE(kHardtanh);
      MIMRL_KMIX_CASE(kLeakyRelu);
      MIMRL_KMIX_CASE(kPRelu);
      MIMRL_KMIX_CASE(kRelu);
      MIMRL_KMIX_CASE(kRRelu);
      MIMRL_KMIX_CASE(kTanh);
    }
#undef MIMRL_KMIX_CASE
    return (int)cudaGetLastError();
  }
  if (instance != kRows && instance != kCols) return bad;
  const bool rows = instance == kRows;
  if (rows != (inner == 1) || grid_y != 1 || (vec != 1 && vec != 4) ||
      smem != 4 * TcLayout(rows, n_in, n_hidden, n_out).floats ||
      smem > kMaxSmem)
    return bad;
  if (vec == 4 && (!aligned16(x) || !aligned16(y) ||
                   (rows ? n_in % 4 != 0 : inner % 4 != 0)))
    return bad;
#define MIMRL_TC_LAUNCH(ROWS, VEC)                                            \
  return launch_tf32x3<ROWS, VEC>(xf, w1f, w2f, b1f, b2f, yf, outer, n_in,    \
                                  n_hidden, n_out, inner, w1_sc, w1_sj,       \
                                  w2_sc, w2_sj, activation, grid_x, smem, s)
  if (rows) {
    if (vec == 4) MIMRL_TC_LAUNCH(true, 4);
    MIMRL_TC_LAUNCH(true, 1);
  }
  if (vec == 4) MIMRL_TC_LAUNCH(false, 4);
  MIMRL_TC_LAUNCH(false, 1);
#undef MIMRL_TC_LAUNCH
}
