// Fused multi-head attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel mimrl_tpu/ops/pallas/flash_attention.py::_fwd_call
// (its _fwd_kernel / _fwd_kernel_batched / _fwd_kernel_bh tilings of one
// function):
//
//     out = dropout(softmax(q . k^T * scale + bias)) . v   per (batch row, head)
//
// q, k, v, out: [bs, nh, T, hd] contiguous, float32 or bfloat16.
// bias: [bs, 1, 1, T] float32, the additive key bias (0 valid, -1e9 padded).
// Scores, the running max, exp and the running sum are float32. P is
// rounded to the input dtype before P . V, which accumulates in float32
// (as flash_attention.py:193-195 does). Scores and probabilities stay in
// registers and shared memory; they never reach device memory.
//
// Dropout (flash_attention.py:156-159) is inverted dropout on P: a
// probability is kept where the Philox word of its (batch row, head, query,
// key) exceeds uint32(p * 2^32) (philox.cuh, shared with the backward, which
// regenerates the same mask), and the kept ones are scaled by 1 / (1 - p).
// The softmax sum runs over all keys, dropped or not; the kept,
// unnormalised P feeds P . V and 1 / (1 - p) is folded into the final
// 1 / sum. The kernel without dropout is its own template instance, so
// dropout_p = 0 compiles to the code it was before dropout existed.
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

#include "flash_common.cuh"
#include "philox.cuh"

namespace {

using namespace mimrl;

constexpr int kRowsPerWarp = 16;
constexpr int kBQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBK = 64;                     // keys per tile: two per lane

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

template <typename T, int HD, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     T* __restrict__ out, const long long* __restrict__ seed,
                     int nh, int t_len, float scale, uint32_t threshold,
                     float inv_keep) {
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
  uint2 key = make_uint2(0u, 0u);
  if (kDrop) key = philox_key(seed);

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
      float pa = expf(sa - m_new), pb = expf(sb - m_new);
      l_run[r] = l_run[r] * alpha + warp_sum(pa + pb);
      if (kDrop) {  // the sum above is over all keys, dropped or not
        const int row = q0 + warp * kRowsPerWarp + r;
        if (!dropout_keep(key, threshold, b, h, row, k0 + lane)) pa = 0.f;
        if (!dropout_keep(key, threshold, b, h, row, k0 + lane + 32)) pb = 0.f;
      }
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
    const float inv = kDrop ? inv_keep / l_run[r] : 1.f / l_run[r];
#pragma unroll
    for (int i = 0; i < kDims; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) out[head + (size_t)row * HD + d] = from_float<T>(acc[r][i] * inv);
    }
  }
}

template <typename T, int HD, bool kDrop>
int launch(const void* q, const void* k, const void* v, const void* bias,
           void* out, const void* seed, int bs, int nh, int t_len, float scale,
           uint32_t threshold, float inv_keep, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, HD, kDrop>;
  const size_t smem = Smem<HD>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t_len + kBQ - 1) / kBQ, nh, bs);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<T*>(out), static_cast<const long long*>(seed), nh, t_len,
      scale, threshold, inv_keep);
  return (int)cudaGetLastError();
}

template <typename T, bool kDrop>
int dispatch_hd(const void* q, const void* k, const void* v, const void* bias,
                void* out, const void* seed, int bs, int nh, int t_len, int hd,
                float scale, uint32_t threshold, float inv_keep,
                cudaStream_t stream) {
#define MIMRL_FWD_CASE(HD)                                                   \
  case HD:                                                                   \
    return launch<T, HD, kDrop>(q, k, v, bias, out, seed, bs, nh, t_len,     \
                                scale, threshold, inv_keep, stream)
  switch (hd) {
    MIMRL_FWD_CASE(8);
    MIMRL_FWD_CASE(16);
    MIMRL_FWD_CASE(32);
    MIMRL_FWD_CASE(64);
    MIMRL_FWD_CASE(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef MIMRL_FWD_CASE
}

template <typename T>
int dispatch_drop(const void* q, const void* k, const void* v,
                  const void* bias, void* out, const void* seed, int bs, int nh,
                  int t_len, int hd, float scale, int dropout,
                  uint32_t threshold, float inv_keep, cudaStream_t stream) {
  if (dropout)
    return dispatch_hd<T, true>(q, k, v, bias, out, seed, bs, nh, t_len, hd,
                                scale, threshold, inv_keep, stream);
  return dispatch_hd<T, false>(q, k, v, bias, out, seed, bs, nh, t_len, hd,
                               scale, threshold, inv_keep, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; compiled with -DMIMRL_DTYPE=0 or 1 the
// library holds that type's kernels only and refuses the other.
// dropout: 0 = off (seed may be null), 1 = on: seed points to one int64 on
// the device, threshold is uint32(p * 2^32) and inv_keep is 1 / (1 - p).
// Returns a cudaError_t value (0 = ok).
extern "C" int mimrl_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, const void* bias,
                                         void* out, const void* seed, int bs,
                                         int nh, int t_len, int hd, int dtype,
                                         float scale, int dropout,
                                         unsigned int threshold,
                                         float inv_keep, void* stream) {
  if (bs <= 0 || nh <= 0 || t_len <= 0 || nh > 65535 || bs > 65535)
    return (int)cudaErrorInvalidValue;
  if (dropout && seed == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#if !defined(MIMRL_DTYPE) || MIMRL_DTYPE == 0
  if (dtype == 0)
    return dispatch_drop<float>(q, k, v, bias, out, seed, bs, nh, t_len, hd,
                                scale, dropout, threshold, inv_keep, s);
#endif
#if !defined(MIMRL_DTYPE) || MIMRL_DTYPE == 1
  if (dtype == 1)
    return dispatch_drop<__nv_bfloat16>(q, k, v, bias, out, seed, bs, nh,
                                        t_len, hd, scale, dropout, threshold,
                                        inv_keep, s);
#endif
  return (int)cudaErrorInvalidValue;
}
