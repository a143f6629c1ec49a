// Fused CubeMLP axis-MLP for Hopper (sm_90a).
//
// Replaces the TPU kernel mimrl_tpu/ops/pallas/cubemlp_kernel.py::_run_fused
// (kernel _kernel), for all three axes:
//
//     y = act(x *_axis w1 + b1) *_axis w2 + b2
//
// over one axis of x [bs, L, K, D] float32: two chained contractions of that
// axis with a bias and an activation between them. The hidden tensor stays
// in shared memory and never reaches device memory; x is read once and y
// written once. Accumulation is float32 on the FP32 pipes; the activation
// is the registry's own (exact erf gelu, not the tanh form the TPU kernel
// had to use).
//
// One view serves the three axes. x is [outer, C, inner] with C the
// contracted axis: axis 1 is [bs, L, K*D], axis 2 is [bs*L, K, D], axis 3
// is [bs*L*K, D, 1]. A *position* is one (outer, inner) pair, a vector of C
// values with stride `inner`; its result is a vector of `n_out` values with
// the same stride. Positions are numbered outer * inner + inner index, and
// a block owns a run of consecutive positions: where inner > 1 its reads
// and writes are coalesced along the trailing axis, where inner == 1 (rows)
// along C, transposed through shared memory.
//
// Bound on the H100 (3.35 TB/s, 67 TFLOP/s float32 outside the tensor
// cores) at the canonical shapes: the D mix of block 0 ([128, 50, 3, 128],
// 128 -> 128 -> 128) is 1.26 GFLOP -> 18.8 us against 19.8 MB -> 5.9 us,
// bound by operations; the L mix of block 0 ([128, 100, 3, 128],
// 100 -> 50 -> 50) is 0.74 GFLOP -> 11.0 us against 29.5 MB -> 8.8 us; the
// K mixes (3 -> 3 -> 3) are bound by bytes.
//
// Design (a first version, no tensor cores). 256 threads: thread (q, g)
// owns four neighbouring positions 4q .. 4q + 3 of the block's and, in
// every pass over the hidden (or output) units, the 8 units of group g: 32
// accumulators. Two layouts of the 256 threads: *wide*, 16 quads x 16
// groups (64 positions, 128 units a pass), and *narrow*, 256 quads x 1
// group (1024 positions, 8 units a pass) for an MLP of at most 8 hidden and
// 8 output units (the K mix), which would leave 15 of 16 groups idle and
// is bound by bytes. The x tile is staged as xs[c][r] (row stride: the
// positions + 4 floats, so that a thread's four positions are one aligned
// float4); the weight is staged in pieces wp[32][units of a pass] of 32
// contraction rows, so a 128 x 128 weight (64 KB) is never resident as a
// whole. The inner loop reads one float4 of x and two float4 of weights
// (the same for all threads of a group: a broadcast) for 32 FMAs. The
// hidden tile hs[j][r] feeds the second contraction the same way; its
// result goes through the x tile's storage, then to device memory. Each
// output is one thread's sum over c in ascending order, then the bias.
//
// Ragged sizes: positions past the last one are loaded as zeros and not
// stored; hidden or output units past their count are zero columns of wp
// and are not stored.
//
// Launch rules: the kernel runs on the caller's stream, allocates nothing
// and does not synchronise. The C entry point returns cudaGetLastError()
// after the launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kUnits = 8;     // units per thread and pass
constexpr int kChunk = 32;    // contraction rows per staged weight piece
constexpr int kThreads = 256;
constexpr int kNarrowUnits = 8;  // the narrow layout's most hidden / output units
// the narrow layout is taken only while two blocks fit an SM
constexpr size_t kNarrowSmem = 100 * 1024;

// QUADS position quads x GROUPS unit groups = 256 threads
template <int QUADS, int GROUPS>
struct Layout {
  static_assert(QUADS * GROUPS == kThreads, "256 threads");
  static constexpr int kPos = 4 * QUADS;         // positions per block
  static constexpr int kPitch = kPos + 4;        // row stride of xs / hs
  static constexpr int kPass = GROUPS * kUnits;  // units per pass
  static constexpr int kWPitch = kPass + 4;      // row stride of wp
  static size_t smem_bytes(int n_in, int n_hidden, int n_out) {
    const int n_io = n_in > n_out ? n_in : n_out;
    return sizeof(float) * ((size_t)(n_io + n_hidden) * kPitch +
                            (size_t)kChunk * kWPitch);
  }
};
using Wide = Layout<16, 16>;
using Narrow = Layout<256, 1>;

enum Activation {
  kElu = 0, kGelu, kHardshrink, kHardtanh, kLeakyRelu, kPRelu, kRelu, kRRelu,
  kTanh
};

template <int ACT>
__device__ __forceinline__ float activate(float x) {
  if (ACT == kElu) return x > 0.f ? x : expm1f(x);
  if (ACT == kGelu) return 0.5f * x * (1.f + erff(x * 0.70710678118654752440f));
  if (ACT == kHardshrink) return fabsf(x) > 0.5f ? x : 0.f;
  if (ACT == kHardtanh) return fminf(fmaxf(x, -1.f), 1.f);
  if (ACT == kLeakyRelu) return x > 0.f ? x : 0.01f * x;
  if (ACT == kPRelu) return x > 0.f ? x : 0.25f * x;
  if (ACT == kRelu) return fmaxf(x, 0.f);
  if (ACT == kRRelu) return x > 0.f ? x : ((1.f / 8.f + 1.f / 3.f) / 2.f) * x;
  return tanhf(x);
}

// dst[j][r] = sum_c src[c][r] * w[c, j] for the block's positions r and
// all j < n_units; w is addressed as w[c * w_sc + j * w_sj]. With kAct the
// bias is added and the activation applied before the store.
template <typename L, int QUADS, int ACT, bool kAct>
__device__ __forceinline__ void contract(float* dst, const float* src,
                                         float* wp, const float* w, int w_sc,
                                         int w_sj, const float* bias,
                                         int n_in, int n_units) {
  const int q = threadIdx.x % QUADS;
  const int g = threadIdx.x / QUADS;
  for (int j0 = 0; j0 < n_units; j0 += L::kPass) {
    const int j_first = j0 + g * kUnits;
    const bool active = j_first < n_units;  // the barriers are outside
    float acc[4][kUnits];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int u = 0; u < kUnits; ++u) acc[p][u] = 0.f;
    for (int c0 = 0; c0 < n_in; c0 += kChunk) {
      const int rows = min(kChunk, n_in - c0);
      __syncthreads();  // wp is free, and src is written
      // consecutive threads along the weight's contiguous axis
      for (int i = threadIdx.x; i < rows * L::kPass; i += kThreads) {
        const int cc = w_sj <= w_sc ? i / L::kPass : i % rows;
        const int jj = w_sj <= w_sc ? i % L::kPass : i / rows;
        wp[cc * L::kWPitch + jj] =
            j0 + jj < n_units
                ? w[(size_t)(c0 + cc) * w_sc + (size_t)(j0 + jj) * w_sj]
                : 0.f;
      }
      __syncthreads();
      if (!active) continue;
      const float* xq = src + c0 * L::kPitch + 4 * q;
      const float* wg = wp + g * kUnits;
#pragma unroll 4
      for (int cc = 0; cc < rows; ++cc) {
        const float4 xv = *reinterpret_cast<const float4*>(xq + cc * L::kPitch);
        const float4 w0 = *reinterpret_cast<const float4*>(wg + cc * L::kWPitch);
        const float4 w1 =
            *reinterpret_cast<const float4*>(wg + cc * L::kWPitch + 4);
        const float xs4[4] = {xv.x, xv.y, xv.z, xv.w};
        const float ws8[kUnits] = {w0.x, w0.y, w0.z, w0.w,
                                   w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int u = 0; u < kUnits; ++u)
            acc[p][u] = fmaf(xs4[p], ws8[u], acc[p][u]);
      }
    }
    if (!active) continue;
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      const int j = j_first + u;
      if (j >= n_units) break;
      const float b = bias != nullptr ? bias[j] : 0.f;
      float4 v;
      v.x = acc[0][u] + b;
      v.y = acc[1][u] + b;
      v.z = acc[2][u] + b;
      v.w = acc[3][u] + b;
      if (kAct) {
        v.x = activate<ACT>(v.x);
        v.y = activate<ACT>(v.y);
        v.z = activate<ACT>(v.z);
        v.w = activate<ACT>(v.w);
      }
      *reinterpret_cast<float4*>(dst + j * L::kPitch + 4 * q) = v;
    }
  }
}

template <int QUADS, int GROUPS, int ACT>
__global__ void __launch_bounds__(kThreads)
axis_mlp_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                const float* __restrict__ w2, const float* __restrict__ b1,
                const float* __restrict__ b2, float* __restrict__ y,
                long long positions, int n_in, int n_hidden, int n_out,
                int inner, int w1_sc, int w1_sj, int w2_sc, int w2_sj) {
  using L = Layout<QUADS, GROUPS>;
  extern __shared__ __align__(16) float smem[];
  const int n_io = n_in > n_out ? n_in : n_out;
  float* xs = smem;                        // [max(n_in, n_out)][kPitch]
  float* hs = xs + n_io * L::kPitch;       // [n_hidden][kPitch]
  float* wp = hs + n_hidden * L::kPitch;   // [kChunk][kWPitch]

  // the block's positions [p0, p0 + n_valid); position p is inner index
  // p % inner of outer index p / inner, and element c of its vector lies at
  // ((p / inner) * n + c) * inner + p % inner, n the length of the axis
  const long long p0 = (long long)blockIdx.x * L::kPos;
  const int n_valid = (int)min((long long)L::kPos, positions - p0);
  const bool rows = inner == 1;

  if (rows) {
    // x[(p0 + r) * n_in + c]: consecutive threads along c, transposed store
    const float* base = x + p0 * n_in;
    for (int i = threadIdx.x; i < L::kPos * n_in; i += kThreads) {
      const int r = i / n_in, c = i % n_in;
      xs[c * L::kPitch + r] = r < n_valid ? base[i] : 0.f;
    }
  } else {
    for (int i = threadIdx.x; i < L::kPos * n_in; i += kThreads) {
      const int c = i / L::kPos, r = i % L::kPos;
      const int p = (int)p0 + r;  // the launch holds positions below 2^31
      xs[c * L::kPitch + r] =
          r < n_valid
              ? x[((long long)(p / inner) * n_in + c) * inner + p % inner]
              : 0.f;
    }
  }

  contract<L, QUADS, ACT, true>(hs, xs, wp, w1, w1_sc, w1_sj, b1, n_in,
                                n_hidden);
  // the first barrier inside orders the hidden tile's writes before its
  // reads, and every read of xs lies before it: xs is free for the result
  contract<L, QUADS, ACT, false>(xs, hs, wp, w2, w2_sc, w2_sj, b2, n_hidden,
                                 n_out);
  __syncthreads();

  if (rows) {
    float* base = y + p0 * n_out;
    for (int i = threadIdx.x; i < n_valid * n_out; i += kThreads) {
      const int r = i / n_out, c = i % n_out;
      base[i] = xs[c * L::kPitch + r];
    }
  } else {
    for (int i = threadIdx.x; i < L::kPos * n_out; i += kThreads) {
      const int c = i / L::kPos, r = i % L::kPos;
      const int p = (int)p0 + r;
      if (r < n_valid)
        y[((long long)(p / inner) * n_out + c) * inner + p % inner] =
            xs[c * L::kPitch + r];
    }
  }
}

// the narrow layout for an MLP of few units whose tile leaves room for two
// blocks an SM, else the wide one
bool narrow(int n_in, int n_hidden, int n_out) {
  return n_hidden <= kNarrowUnits && n_out <= kNarrowUnits &&
         Narrow::smem_bytes(n_in, n_hidden, n_out) <= kNarrowSmem;
}

template <int QUADS, int GROUPS, int ACT>
int launch(const void* x, const void* w1, const void* w2, const void* b1,
           const void* b2, void* y, long long positions, int n_in,
           int n_hidden, int n_out, int inner, int w1_sc, int w1_sj, int w2_sc,
           int w2_sj, cudaStream_t stream) {
  using L = Layout<QUADS, GROUPS>;
  auto kern = axis_mlp_kernel<QUADS, GROUPS, ACT>;
  const size_t smem = L::smem_bytes(n_in, n_hidden, n_out);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (positions > 2147483647LL - L::kPos) return (int)cudaErrorInvalidValue;
  const long long blocks = (positions + L::kPos - 1) / L::kPos;
  kern<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(w2), static_cast<const float*>(b1),
      static_cast<const float*>(b2), static_cast<float*>(y), positions, n_in,
      n_hidden, n_out, inner, w1_sc, w1_sj, w2_sc, w2_sj);
  return (int)cudaGetLastError();
}

template <int ACT>
int launch_layout(const void* x, const void* w1, const void* w2,
                  const void* b1, const void* b2, void* y, long long positions,
                  int n_in, int n_hidden, int n_out, int inner, int w1_sc,
                  int w1_sj, int w2_sc, int w2_sj, cudaStream_t stream) {
  if (narrow(n_in, n_hidden, n_out))
    return launch<256, 1, ACT>(x, w1, w2, b1, b2, y, positions, n_in, n_hidden,
                               n_out, inner, w1_sc, w1_sj, w2_sc, w2_sj, stream);
  return launch<16, 16, ACT>(x, w1, w2, b1, b2, y, positions, n_in, n_hidden,
                             n_out, inner, w1_sc, w1_sj, w2_sc, w2_sj, stream);
}

}  // namespace

// The dynamic shared memory one block needs for these sizes, in bytes (the
// wrapper refuses sizes past the card's 227 KB).
extern "C" long long mimrl_cubemlp_axis_mlp_smem(int n_in, int n_hidden,
                                                 int n_out) {
  return (long long)(narrow(n_in, n_hidden, n_out)
                         ? Narrow::smem_bytes(n_in, n_hidden, n_out)
                         : Wide::smem_bytes(n_in, n_hidden, n_out));
}

// x: [outer, n_in, inner] float32 contiguous; y: [outer, n_out, inner].
// w1[c, j] = w1[c * w1_sc + j * w1_sj] for c < n_in, j < n_hidden; w2
// likewise for [n_hidden, n_out]. b1, b2: float32 vectors or both null.
// activation: the index of the name in the wrapper's ACTIVATIONS tuple.
// Returns a cudaError_t value (0 = ok).
extern "C" int mimrl_cubemlp_axis_mlp(const void* x, const void* w1,
                                      const void* w2, const void* b1,
                                      const void* b2, void* y, long long outer,
                                      int n_in, int n_hidden, int n_out,
                                      int inner, int w1_sc, int w1_sj,
                                      int w2_sc, int w2_sj, int activation,
                                      void* stream) {
  if (outer <= 0 || n_in <= 0 || n_hidden <= 0 || n_out <= 0 || inner <= 0)
    return (int)cudaErrorInvalidValue;
  if ((b1 == nullptr) != (b2 == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long positions = outer * inner;
#define MIMRL_ACT_CASE(ACT)                                                   \
  case ACT:                                                                   \
    return launch_layout<ACT>(x, w1, w2, b1, b2, y, positions, n_in,          \
                              n_hidden, n_out, inner, w1_sc, w1_sj, w2_sc,    \
                              w2_sj, s)
  switch (activation) {
    MIMRL_ACT_CASE(kElu);
    MIMRL_ACT_CASE(kGelu);
    MIMRL_ACT_CASE(kHardshrink);
    MIMRL_ACT_CASE(kHardtanh);
    MIMRL_ACT_CASE(kLeakyRelu);
    MIMRL_ACT_CASE(kPRelu);
    MIMRL_ACT_CASE(kRelu);
    MIMRL_ACT_CASE(kRRelu);
    MIMRL_ACT_CASE(kTanh);
    default: return (int)cudaErrorInvalidValue;
  }
#undef MIMRL_ACT_CASE
}
