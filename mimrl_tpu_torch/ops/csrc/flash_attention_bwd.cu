// Fused multi-head attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel mimrl_tpu/ops/pallas/flash_attention.py::_bwd_call
// (its _bwd_kernel / _bwd_kernel_batched / _bwd_kernel_bh tilings of one
// function), the backward of
//
//     out = dropout(softmax(q . k^T * scale + bias)) . v   per (batch row, head)
//
// From q, k, v, bias, the dropout seed and dO it recomputes S and P,
// regenerates the forward's keep mask (philox.cuh) and emits
//
//     Pd  = keep ? P / (1 - p) : 0          dV = Pd^T . dO
//     dPd = dO . V^T                        dP = keep ? dPd / (1 - p) : 0
//     dS  = P * (dP - rowsum(dP * P)) * scale
//     dQ  = dS . K                          dK = dS^T . Q
//
// q, k, v, dO, dq, dk, dv: [bs, nh, T, hd] contiguous, float32 or bfloat16;
// bias: [bs, 1, 1, T] float32; seed: one int64 on the device. The roundings
// are the reference's (flash_attention.py:334, :346): Pd and dS (after the
// multiplication by scale) are rounded to the input dtype before their
// products, every product accumulates in float32. Nothing but q, k, v, bias
// and the seed is kept from the forward: no mask, no P, no output.
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16) at the training shape
// [128, 12, 100, 64] bf16: q, k, v, dO read and dq, dk, dv written once is
// 7 x 19.7 MB = 137.6 MB -> 41 us; the five products are
// 10 * bs * nh * T^2 * hd = 9.8 GFLOP -> 10 us on the tensor cores. The
// function is bound by bytes.
//
// Design (the simple first version: FP32 pipes, no tensor cores, TMA or
// warp specialisation, and no float atomics, so two runs give the same bits).
// One block of 4 warps per (head, batch row) owns all of that head's dq, dk
// and dv, in two phases over 64-query and 32-key tiles staged in shared
// memory as float32:
//
//   A. softmax statistics. The forward keeps none, so for each query tile
//      the block walks the keys once with an online softmax and gets the row
//      max m, the row sum l and, rescaled along with them,
//      delta = rowsum(dP * P) = sum_k exp(s - m) * dP / l. Computing delta
//      here from dP and P (two products: Q . K^T and dO . V^T) needs no saved
//      output and is exact where rowsum(dO * O) would carry O's rounding.
//      m, 1 / l and delta stay in shared memory, 12 bytes per query row. A
//      log-sum-exp written by the forward would save the Q . K^T of this pass
//      (one product of seven) at the price of a second forward output; the
//      residuals stay those of the TPU kernel instead.
//   B. gradients. Keys outside, queries inside: for a key tile the block
//      holds dK and dV in registers (a warp owns 8 keys, a lane hd/32
//      columns) while it walks the query tiles. Per tile pair it recomputes
//      S and dPd (a warp owns 16 query rows, a lane one key), forms Pd and dS,
//      stores them in shared memory (transposed for the two products that
//      contract over queries, as they are for dS . K), and adds the tile's
//      dS . K into dq. dq is summed over key tiles in float32 in device
//      memory (dq itself for float32, a scratch tensor the wrapper allocates
//      for bfloat16); the thread that wrote an element is the one that reads
//      it back, so there is no race and no atomic. The last key tile writes
//      dq in the output dtype.
//
// Seven tile products in all (two in A, five in B) on the CUDA cores, so this
// version is bound by operations there, not by bytes; PERF.md has the times.
//
// Masking, as in the forward: keys past T weigh 0 and query rows past T
// contribute nothing; padded keys inside T keep their additive -1e9 bias, so
// a row whose keys are all padded has uniform P and a well-defined gradient.
//
// Launch rules: the kernel runs on the caller's stream, allocates nothing
// and does not synchronise. The C entry point returns cudaGetLastError().

#include "flash_common.cuh"
#include "philox.cuh"

namespace {

using namespace mimrl;

constexpr int kRowsPerWarp = 16;
constexpr int kBQ = kWarps * kRowsPerWarp;  // query rows per tile
constexpr int kBK = 32;                     // keys per tile: one per lane
constexpr int kKeysPerWarp = kBK / kWarps;  // rows of dK, dV per warp
constexpr int kMaxT = 4096;                 // statistics live in shared memory

// Shared-memory layout in floats. Row strides are padded by 4 floats so
// that float4 reads of lanes at different rows hit distinct banks.
template <int HD>
struct Smem {
  static constexpr int kRow = HD + 4;    // Q, dO, K, V row stride
  static constexpr int kPT = kBQ + 4;    // Pd^T and dS^T row stride
  static constexpr int kDS = kBK + 4;    // dS row stride
  static constexpr int q_off = 0;
  static constexpr int do_off = q_off + kBQ * kRow;
  static constexpr int k_off = do_off + kBQ * kRow;
  static constexpr int v_off = k_off + kBK * kRow;
  static constexpr int pt_off = v_off + kBK * kRow;
  static constexpr int dst_off = pt_off + kBK * kPT;
  static constexpr int ds_off = dst_off + kBK * kPT;
  static constexpr int b_off = ds_off + kBQ * kDS;
  static constexpr int stat_off = b_off + kBK;  // then 3 x padded T floats
  static size_t bytes(int t_pad) {
    return (size_t)(stat_off + 3 * t_pad) * sizeof(float);
  }
};

// s[r] = Q[row r] . K[key], dpd[r] = dO[row r] . V[key] for the warp's 16
// query rows and the lane's key
template <int HD, int STRIDE>
__device__ __forceinline__ void score_tiles(const float* sQw, const float* sDOw,
                                            const float* k_row,
                                            const float* v_row,
                                            float (&s)[kRowsPerWarp],
                                            float (&dpd)[kRowsPerWarp]) {
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) s[r] = dpd[r] = 0.f;
#pragma unroll
  for (int d = 0; d < HD; d += 4) {
    const float4 kk = *reinterpret_cast<const float4*>(k_row + d);
    const float4 vv = *reinterpret_cast<const float4*>(v_row + d);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float4 qv = *reinterpret_cast<const float4*>(sQw + r * STRIDE + d);
      const float4 dv = *reinterpret_cast<const float4*>(sDOw + r * STRIDE + d);
      s[r] = fmaf(qv.x, kk.x, s[r]);
      s[r] = fmaf(qv.y, kk.y, s[r]);
      s[r] = fmaf(qv.z, kk.z, s[r]);
      s[r] = fmaf(qv.w, kk.w, s[r]);
      dpd[r] = fmaf(dv.x, vv.x, dpd[r]);
      dpd[r] = fmaf(dv.y, vv.y, dpd[r]);
      dpd[r] = fmaf(dv.z, vv.z, dpd[r]);
      dpd[r] = fmaf(dv.w, vv.w, dpd[r]);
    }
  }
}

template <typename T, int HD, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     const T* __restrict__ d_out,
                     const long long* __restrict__ seed, T* dq, float* dq_acc,
                     T* __restrict__ dk, T* __restrict__ dv, int nh, int t_len,
                     int t_pad, float scale, uint32_t threshold,
                     float inv_keep) {
  using S = Smem<HD>;
  constexpr int kDims = (HD + 31) / 32;  // columns per lane
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sQ = smem + S::q_off;
  float* sDO = smem + S::do_off;
  float* sK = smem + S::k_off;
  float* sV = smem + S::v_off;
  float* sPT = smem + S::pt_off;
  float* sDST = smem + S::dst_off;
  float* sDS = smem + S::ds_off;
  float* sB = smem + S::b_off;
  float* sM = smem + S::stat_off;
  float* sInvL = sM + t_pad;
  float* sDelta = sInvL + t_pad;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.y, h = blockIdx.x;
  const size_t head = ((size_t)b * nh + h) * (size_t)t_len * HD;
  const float* bias_row = bias + (size_t)b * t_len;
  const float* sQw = sQ + warp * kRowsPerWarp * S::kRow;
  const float* sDOw = sDO + warp * kRowsPerWarp * S::kRow;
  uint2 key = make_uint2(0u, 0u);
  if (kDrop) key = philox_key(seed);

  float s[kRowsPerWarp], dpd[kRowsPerWarp];

  // ---- phase A: m, 1 / l and delta for every query row ----
  for (int q0 = 0; q0 < t_len; q0 += kBQ) {
    __syncthreads();  // the previous tile's reads are finished
    load_tile<T, HD>(sQ, S::kRow, q + head, q0, kBQ, t_len);
    load_tile<T, HD>(sDO, S::kRow, d_out + head, q0, kBQ, t_len);
    float m_run[kRowsPerWarp], l_run[kRowsPerWarp], d_run[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      m_run[r] = -INFINITY;
      l_run[r] = d_run[r] = 0.f;
    }
    for (int k0 = 0; k0 < t_len; k0 += kBK) {
      __syncthreads();
      load_tile<T, HD>(sK, S::kRow, k + head, k0, kBK, t_len);
      load_tile<T, HD>(sV, S::kRow, v + head, k0, kBK, t_len);
      if (threadIdx.x < kBK)
        sB[threadIdx.x] = k0 + threadIdx.x < t_len ? bias_row[k0 + threadIdx.x] : 0.f;
      __syncthreads();
      score_tiles<HD, S::kRow>(sQw, sDOw, sK + lane * S::kRow,
                               sV + lane * S::kRow, s, dpd);
      const int key_idx = k0 + lane;
      const bool in_k = key_idx < t_len;
      const float bias_k = sB[lane];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int row = q0 + warp * kRowsPerWarp + r;
        // s * scale + bias rounded twice, as the reference computes it
        const float sv = in_k ? __fadd_rn(__fmul_rn(s[r], scale), bias_k) : -INFINITY;
        const float m_new = fmaxf(m_run[r], warp_max(sv));
        const float alpha = expf(m_run[r] - m_new);  // 0 on the first tile
        const float e = expf(sv - m_new);
        float dp = dpd[r];
        if (kDrop)
          dp = dropout_keep(key, threshold, b, h, row, key_idx) ? dp * inv_keep : 0.f;
        l_run[r] = l_run[r] * alpha + warp_sum(e);
        d_run[r] = d_run[r] * alpha + warp_sum(in_k ? e * dp : 0.f);
        m_run[r] = m_new;
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      if (lane == r) {
        const int row = q0 + warp * kRowsPerWarp + r;
        const float inv_l = 1.f / l_run[r];
        sM[row] = m_run[r];
        sInvL[row] = inv_l;
        sDelta[row] = d_run[r] * inv_l;
      }
    }
  }

  // ---- phase B: dk, dv per key tile; dq summed over key tiles ----
  for (int k0 = 0; k0 < t_len; k0 += kBK) {
    const bool last_key_tile = k0 + kBK >= t_len;
    __syncthreads();  // phase A's, or the previous key tile's, reads are finished
    load_tile<T, HD>(sK, S::kRow, k + head, k0, kBK, t_len);
    load_tile<T, HD>(sV, S::kRow, v + head, k0, kBK, t_len);
    if (threadIdx.x < kBK)
      sB[threadIdx.x] = k0 + threadIdx.x < t_len ? bias_row[k0 + threadIdx.x] : 0.f;

    float dk_acc[kKeysPerWarp][kDims], dv_acc[kKeysPerWarp][kDims];
#pragma unroll
    for (int r = 0; r < kKeysPerWarp; ++r)
#pragma unroll
      for (int i = 0; i < kDims; ++i) dk_acc[r][i] = dv_acc[r][i] = 0.f;
    // contraction lengths rounded up to 4; the extra rows are zero
    const int n_keys = min(kBK, (t_len - k0 + 3) & ~3);

    for (int q0 = 0; q0 < t_len; q0 += kBQ) {
      __syncthreads();  // the previous pair's reads of Q, dO, Pd, dS are finished
      load_tile<T, HD>(sQ, S::kRow, q + head, q0, kBQ, t_len);
      load_tile<T, HD>(sDO, S::kRow, d_out + head, q0, kBQ, t_len);
      __syncthreads();

      score_tiles<HD, S::kRow>(sQw, sDOw, sK + lane * S::kRow,
                               sV + lane * S::kRow, s, dpd);
      const int key_idx = k0 + lane;
      const bool in_k = key_idx < t_len;
      const float bias_k = sB[lane];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int col = warp * kRowsPerWarp + r;
        const int row = q0 + col;
        float pd = 0.f, ds = 0.f;
        if (in_k && row < t_len) {
          const float sv = __fadd_rn(__fmul_rn(s[r], scale), bias_k);
          const float p = expf(sv - sM[row]) * sInvL[row];
          float dp = dpd[r];
          pd = p;
          if (kDrop) {
            const bool keep = dropout_keep(key, threshold, b, h, row, key_idx);
            pd = keep ? p * inv_keep : 0.f;
            dp = keep ? dp * inv_keep : 0.f;
          }
          pd = round_to<T>(pd);
          ds = round_to<T>(p * (dp - sDelta[row]) * scale);
        }
        sPT[lane * S::kPT + col] = pd;
        sDST[lane * S::kPT + col] = ds;
        sDS[col * S::kDS + lane] = ds;
      }
      __syncthreads();  // dk and dv contract over the query rows of all warps

      // dv += Pd^T . dO and dk += dS^T . Q for the warp's 8 keys
      const int n_rows = min(kBQ, (t_len - q0 + 3) & ~3);
      const float* sPTw = sPT + warp * kKeysPerWarp * S::kPT;
      const float* sDSTw = sDST + warp * kKeysPerWarp * S::kPT;
      for (int j = 0; j < n_rows; j += 4) {
        float dov[4][kDims], qv[4][kDims];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int i = 0; i < kDims; ++i) {
            const int d = lane + 32 * i;
            dov[jj][i] = d < HD ? sDO[(j + jj) * S::kRow + d] : 0.f;
            qv[jj][i] = d < HD ? sQ[(j + jj) * S::kRow + d] : 0.f;
          }
#pragma unroll
        for (int r = 0; r < kKeysPerWarp; ++r) {
          const float4 p4 = *reinterpret_cast<const float4*>(sPTw + r * S::kPT + j);
          const float4 s4 = *reinterpret_cast<const float4*>(sDSTw + r * S::kPT + j);
#pragma unroll
          for (int i = 0; i < kDims; ++i) {
            dv_acc[r][i] = fmaf(p4.x, dov[0][i], dv_acc[r][i]);
            dv_acc[r][i] = fmaf(p4.y, dov[1][i], dv_acc[r][i]);
            dv_acc[r][i] = fmaf(p4.z, dov[2][i], dv_acc[r][i]);
            dv_acc[r][i] = fmaf(p4.w, dov[3][i], dv_acc[r][i]);
            dk_acc[r][i] = fmaf(s4.x, qv[0][i], dk_acc[r][i]);
            dk_acc[r][i] = fmaf(s4.y, qv[1][i], dk_acc[r][i]);
            dk_acc[r][i] = fmaf(s4.z, qv[2][i], dk_acc[r][i]);
            dk_acc[r][i] = fmaf(s4.w, qv[3][i], dk_acc[r][i]);
          }
        }
      }

      // dq tile = dS . K for the warp's 16 query rows
      float dq_t[kRowsPerWarp][kDims];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
        for (int i = 0; i < kDims; ++i) dq_t[r][i] = 0.f;
      const float* sDSw = sDS + warp * kRowsPerWarp * S::kDS;
      for (int j = 0; j < n_keys; j += 4) {
        float kv[4][kDims];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int i = 0; i < kDims; ++i) {
            const int d = lane + 32 * i;
            kv[jj][i] = d < HD ? sK[(j + jj) * S::kRow + d] : 0.f;
          }
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const float4 s4 = *reinterpret_cast<const float4*>(sDSw + r * S::kDS + j);
#pragma unroll
          for (int i = 0; i < kDims; ++i) {
            dq_t[r][i] = fmaf(s4.x, kv[0][i], dq_t[r][i]);
            dq_t[r][i] = fmaf(s4.y, kv[1][i], dq_t[r][i]);
            dq_t[r][i] = fmaf(s4.z, kv[2][i], dq_t[r][i]);
            dq_t[r][i] = fmaf(s4.w, kv[3][i], dq_t[r][i]);
          }
        }
      }
      // this thread alone reads and writes these elements of dq, in every
      // key tile, so the sum needs no atomic
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int row = q0 + warp * kRowsPerWarp + r;
        if (row >= t_len) continue;
#pragma unroll
        for (int i = 0; i < kDims; ++i) {
          const int d = lane + 32 * i;
          if (d >= HD) continue;
          const size_t idx = head + (size_t)row * HD + d;
          const float sum = k0 > 0 ? dq_acc[idx] + dq_t[r][i] : dq_t[r][i];
          if (last_key_tile)
            dq[idx] = from_float<T>(sum);
          else
            dq_acc[idx] = sum;
        }
      }
    }

#pragma unroll
    for (int r = 0; r < kKeysPerWarp; ++r) {
      const int key_row = k0 + warp * kKeysPerWarp + r;
      if (key_row >= t_len) continue;
#pragma unroll
      for (int i = 0; i < kDims; ++i) {
        const int d = lane + 32 * i;
        if (d >= HD) continue;
        const size_t idx = head + (size_t)key_row * HD + d;
        dk[idx] = from_float<T>(dk_acc[r][i]);
        dv[idx] = from_float<T>(dv_acc[r][i]);
      }
    }
  }
}

template <typename T, int HD, bool kDrop>
int launch(const void* q, const void* k, const void* v, const void* bias,
           const void* d_out, const void* seed, void* dq, void* dq_acc,
           void* dk, void* dv, int bs, int nh, int t_len, float scale,
           uint32_t threshold, float inv_keep, cudaStream_t stream) {
  auto kern = flash_bwd_kernel<T, HD, kDrop>;
  const int t_pad = (t_len + kBQ - 1) / kBQ * kBQ;
  const size_t smem = Smem<HD>::bytes(t_pad);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nh, bs);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<const T*>(d_out), static_cast<const long long*>(seed),
      static_cast<T*>(dq), static_cast<float*>(dq_acc), static_cast<T*>(dk),
      static_cast<T*>(dv), nh, t_len, t_pad, scale, threshold, inv_keep);
  return (int)cudaGetLastError();
}

template <typename T, bool kDrop>
int dispatch_hd(const void* q, const void* k, const void* v, const void* bias,
                const void* d_out, const void* seed, void* dq, void* dq_acc,
                void* dk, void* dv, int bs, int nh, int t_len, int hd,
                float scale, uint32_t threshold, float inv_keep,
                cudaStream_t stream) {
#define MIMRL_BWD_CASE(HD)                                                    \
  case HD:                                                                    \
    return launch<T, HD, kDrop>(q, k, v, bias, d_out, seed, dq, dq_acc, dk,   \
                                dv, bs, nh, t_len, scale, threshold,          \
                                inv_keep, stream)
  switch (hd) {
    MIMRL_BWD_CASE(8);
    MIMRL_BWD_CASE(16);
    MIMRL_BWD_CASE(32);
    MIMRL_BWD_CASE(64);
    MIMRL_BWD_CASE(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef MIMRL_BWD_CASE
}

template <typename T>
int dispatch_drop(const void* q, const void* k, const void* v,
                  const void* bias, const void* d_out, const void* seed,
                  void* dq, void* dq_acc, void* dk, void* dv, int bs, int nh,
                  int t_len, int hd, float scale, int dropout,
                  uint32_t threshold, float inv_keep, cudaStream_t stream) {
  if (dropout)
    return dispatch_hd<T, true>(q, k, v, bias, d_out, seed, dq, dq_acc, dk, dv,
                                bs, nh, t_len, hd, scale, threshold, inv_keep,
                                stream);
  return dispatch_hd<T, false>(q, k, v, bias, d_out, seed, dq, dq_acc, dk, dv,
                               bs, nh, t_len, hd, scale, threshold, inv_keep,
                               stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; compiled with -DMIMRL_DTYPE=0 or 1 the
// library holds that type's kernels only and refuses the other.
// dq_acc: float32 [bs, nh, T, hd] scratch for the sum of dq over key tiles;
// for float32 it may be dq itself.
// dropout: 0 = off (seed may be null), 1 = on: seed points to one int64 on
// the device, threshold is uint32(p * 2^32), inv_keep is 1 / (1 - p).
// Returns a cudaError_t value (0 = ok).
extern "C" int mimrl_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* bias,
    const void* d_out, const void* seed, void* dq, void* dq_acc, void* dk,
    void* dv, int bs, int nh, int t_len, int hd, int dtype, float scale,
    int dropout, unsigned int threshold, float inv_keep, void* stream) {
  if (bs <= 0 || nh <= 0 || t_len <= 0 || nh > 65535 || bs > 65535 ||
      t_len > kMaxT)
    return (int)cudaErrorInvalidValue;
  if (dropout && seed == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#if !defined(MIMRL_DTYPE) || MIMRL_DTYPE == 0
  if (dtype == 0)
    return dispatch_drop<float>(q, k, v, bias, d_out, seed, dq, dq_acc, dk, dv,
                                bs, nh, t_len, hd, scale, dropout, threshold,
                                inv_keep, s);
#endif
#if !defined(MIMRL_DTYPE) || MIMRL_DTYPE == 1
  if (dtype == 1)
    return dispatch_drop<__nv_bfloat16>(q, k, v, bias, d_out, seed, dq, dq_acc,
                                        dk, dv, bs, nh, t_len, hd, scale,
                                        dropout, threshold, inv_keep, s);
#endif
  return (int)cudaErrorInvalidValue;
}
