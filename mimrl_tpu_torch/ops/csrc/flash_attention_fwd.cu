// Fused multi-head attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel mimrl_tpu/ops/pallas/flash_attention.py::_fwd_call
// (its _fwd_kernel / _fwd_kernel_batched / _fwd_kernel_bh tilings of one
// function) with dropout_p = 0:
//
//     out = softmax(q . k^T * scale + bias) . v      per (batch row, head)
//
// q, k, v, out: [bs, nh, T, hd] contiguous, float32 or bfloat16.
// bias: [bs, 1, 1, T] float32, the additive key bias (0 valid, -1e9 padded).
// Scores, the running max, exp and the running sum are float32. P is
// rounded to the input dtype before P . V, which accumulates in float32
// (as flash_attention.py:193-195 does). Scores and probabilities stay in
// registers and shared memory; they never reach device memory.
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16) at the serving shape
// [128, 12, 100, 64] bf16: the kernel must read q, k, v and write out,
// 4 x 19.7 MB = 78.6 MB -> 23.5 us; the two products are
// 4 * bs * nh * T^2 * hd = 3.9 GFLOP -> 4 us on the tensor cores. So the
// function is bound by bytes.
//
// Design (the simple first version; no tensor cores, TMA or warp
// specialisation yet). One block of 4 warps per (64-query tile, head,
// batch row). The block stages its Q tile once, then walks the keys in
// tiles of 64 staged in shared memory (K, V and the bias converted to
// float32), with an online softmax: each warp owns 16 query rows, each
// lane two keys of the tile for Q . K^T and hd/32 output columns for
// P . V. Every element of q, k, v is read from device memory once per
// query tile (k and v once per 64 queries, from L2 after the first), and
// out is written once. The arithmetic runs on the FP32 pipes, so this
// version is bound by operations on the CUDA cores, not by bytes: the gap
// to the bound above is recorded in PERF.md.
//
// Masking. Keys past T (the ragged edge of the last tile) get -inf and
// weight 0. Padded keys inside T keep their additive -1e9 bias exactly as
// the reference does, so a row whose keys are all padded comes out as the
// uniform average of v over its T keys, as in JAX. The first key tile
// always holds key 0, so the running max is finite after it.
//
// Launch rules: the kernel runs on the caller's stream, allocates
// nothing and does not synchronise. The C entry point returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 16;
constexpr int kBQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBK = 64;                     // keys per tile: two per lane
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

// P is cast to the input dtype before P . V
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

// Shared-memory layout in floats. Q and K rows are padded by 4 floats so
// that the float4 reads of 8 lanes at different rows hit distinct banks.
template <int HD>
struct Smem {
  static constexpr int kQK = HD + 4;   // Q and K row stride
  static constexpr int kP = kBK + 4;   // P row stride
  static constexpr int q_off = 0;
  static constexpr int k_off = q_off + kBQ * kQK;
  static constexpr int v_off = k_off + kBK * kQK;
  static constexpr int p_off = v_off + kBK * HD;
  static constexpr int b_off = p_off + kWarps * kRowsPerWarp * kP;
  static constexpr int floats = b_off + kBK;
  static constexpr size_t bytes = floats * sizeof(float);
};

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

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     T* __restrict__ out, int nh, int t_len, float scale) {
  using S = Smem<HD>;
  constexpr int kDims = (HD + 31) / 32;  // output columns per lane
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sQ = smem + S::q_off;
  float* sK = smem + S::k_off;
  float* sV = smem + S::v_off;
  float* sB = smem + S::b_off;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const size_t head = ((size_t)b * nh + h) * (size_t)t_len * HD;
  const float* bias_row = bias + (size_t)b * t_len;
  const float* sQw = sQ + warp * kRowsPerWarp * S::kQK;
  float* sPw = smem + S::p_off + warp * kRowsPerWarp * S::kP;

  load_tile<T, HD>(sQ, S::kQK, q + head, q0, kBQ, t_len);

  float acc[kRowsPerWarp][kDims];
  float m_run[kRowsPerWarp], l_run[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kDims; ++i) acc[r][i] = 0.f;
  }

  for (int k0 = 0; k0 < t_len; k0 += kBK) {
    __syncthreads();  // the previous tile's K/V/bias reads are finished
    load_tile<T, HD>(sK, S::kQK, k + head, k0, kBK, t_len);
    load_tile<T, HD>(sV, HD, v + head, k0, kBK, t_len);
    for (int j = threadIdx.x; j < kBK; j += kThreads)
      sB[j] = k0 + j < t_len ? bias_row[k0 + j] : 0.f;
    __syncthreads();

    // raw scores q . k for this lane's keys (lane, lane + 32)
    float s[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r][0] = s[r][1] = 0.f;
    const float* ka_row = sK + lane * S::kQK;
    const float* kb_row = sK + (lane + 32) * S::kQK;
#pragma unroll
    for (int d = 0; d < HD; d += 4) {
      const float4 ka = *reinterpret_cast<const float4*>(ka_row + d);
      const float4 kb = *reinterpret_cast<const float4*>(kb_row + d);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(sQw + r * S::kQK + d);
        s[r][0] = fmaf(qv.x, ka.x, s[r][0]);
        s[r][0] = fmaf(qv.y, ka.y, s[r][0]);
        s[r][0] = fmaf(qv.z, ka.z, s[r][0]);
        s[r][0] = fmaf(qv.w, ka.w, s[r][0]);
        s[r][1] = fmaf(qv.x, kb.x, s[r][1]);
        s[r][1] = fmaf(qv.y, kb.y, s[r][1]);
        s[r][1] = fmaf(qv.z, kb.z, s[r][1]);
        s[r][1] = fmaf(qv.w, kb.w, s[r][1]);
      }
    }

    // online softmax over this tile; P (unnormalised, rounded) -> smem
    const bool in_a = k0 + lane < t_len, in_b = k0 + lane + 32 < t_len;
    const float bias_a = sB[lane], bias_b = sB[lane + 32];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      // s * scale + bias rounded twice, as the reference computes it
      const float sa = in_a ? __fadd_rn(__fmul_rn(s[r][0], scale), bias_a) : -INFINITY;
      const float sb = in_b ? __fadd_rn(__fmul_rn(s[r][1], scale), bias_b) : -INFINITY;
      const float m_new = fmaxf(m_run[r], warp_max(fmaxf(sa, sb)));
      const float alpha = expf(m_run[r] - m_new);  // 0 on the first tile
      const float pa = expf(sa - m_new), pb = expf(sb - m_new);
      l_run[r] = l_run[r] * alpha + warp_sum(pa + pb);
      m_run[r] = m_new;
#pragma unroll
      for (int i = 0; i < kDims; ++i) acc[r][i] *= alpha;
      sPw[r * S::kP + lane] = round_to<T>(pa);
      sPw[r * S::kP + lane + 32] = round_to<T>(pb);
    }
    __syncwarp();

    // acc += P . V over the tile's keys (rounded up to 4; the extra
    // rows of V are zero and their P is zero)
    const int n_keys = min(kBK, (t_len - k0 + 3) & ~3);
    for (int j = 0; j < n_keys; j += 4) {
      float vv[4][kDims];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int i = 0; i < kDims; ++i) {
          const int d = lane + 32 * i;
          vv[jj][i] = d < HD ? sV[(j + jj) * HD + d] : 0.f;
        }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 p4 = *reinterpret_cast<const float4*>(sPw + r * S::kP + j);
#pragma unroll
        for (int i = 0; i < kDims; ++i) {
          acc[r][i] = fmaf(p4.x, vv[0][i], acc[r][i]);
          acc[r][i] = fmaf(p4.y, vv[1][i], acc[r][i]);
          acc[r][i] = fmaf(p4.z, vv[2][i], acc[r][i]);
          acc[r][i] = fmaf(p4.w, vv[3][i], acc[r][i]);
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + warp * kRowsPerWarp + r;
    if (row >= t_len) continue;
    const float inv = 1.f / l_run[r];
#pragma unroll
    for (int i = 0; i < kDims; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) out[head + (size_t)row * HD + d] = from_float<T>(acc[r][i] * inv);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* bias,
           void* out, int bs, int nh, int t_len, float scale,
           cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, HD>;
  const size_t smem = Smem<HD>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t_len + kBQ - 1) / kBQ, nh, bs);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<T*>(out), nh, t_len, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, const void* bias,
                void* out, int bs, int nh, int t_len, int hd, float scale,
                cudaStream_t stream) {
  switch (hd) {
    case 8: return launch<T, 8>(q, k, v, bias, out, bs, nh, t_len, scale, stream);
    case 16: return launch<T, 16>(q, k, v, bias, out, bs, nh, t_len, scale, stream);
    case 32: return launch<T, 32>(q, k, v, bias, out, bs, nh, t_len, scale, stream);
    case 64: return launch<T, 64>(q, k, v, bias, out, bs, nh, t_len, scale, stream);
    case 128: return launch<T, 128>(q, k, v, bias, out, bs, nh, t_len, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t value (0 = ok).
extern "C" int mimrl_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, const void* bias,
                                         void* out, int bs, int nh, int t_len,
                                         int hd, int dtype, float scale,
                                         void* stream) {
  if (bs <= 0 || nh <= 0 || t_len <= 0 || nh > 65535 || bs > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(q, k, v, bias, out, bs, nh, t_len, hd, scale, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(q, k, v, bias, out, bs, nh, t_len, hd, scale, s);
  return (int)cudaErrorInvalidValue;
}
