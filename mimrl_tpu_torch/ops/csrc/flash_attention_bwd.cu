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
// Bound on the H100 SXM at its 700 W limit (3.35 TB/s; 989 TFLOP/s bf16 and
// 495 TFLOP/s TF32 on the tensor cores) at the training shape
// [128, 12, 100, 64]: q, k, v, dO read and dq, dk, dv written once is
// 7 x 19.7 MB = 137.6 MB -> 41 us in bf16, 275 MB -> 82 us in float32; the
// five products are 10 * bs * nh * T^2 * hd = 9.8 GFLOP -> 10 us on the
// tensor cores in bf16, 60 us as three TF32 products each in float32. The
// function is bound by bytes in both types.
//
// Two instances, chosen by the wrapper (ops/flash_attention.py::_instance).
// Neither uses a float atomic, so two runs give the same bits.
//
// Tensor cores, bf16 (flash_bwd_tc_kernel, up to max_t, the main path). All products on
// mma.sync.m16n8k16 bf16 -> float32. One block per (head, batch row)
// stages the whole head, Q, K, V and dO, once, as bf16 by 16-byte cp.async
// (rows padded by 16 bytes against ldmatrix bank conflicts): every input is
// read from device memory exactly once, and nothing but dq, dk, dv is
// written. What bounds the instance is that shared memory: 4 x T x
// (hd + 8) x 2 bytes, the bias and three statistics (16 bytes per row) and
// the dropout mask (T^2 / 8 bytes) must fit the 227 KB a block may use, so
// T <= max_t(hd): 352 at hd 64 (68 KB at T 100, three blocks an SM; 98 KB
// at T 150), 192 at hd 128, 752 at hd 8 and 16. Longer T takes the SIMT
// instance. Warps: ceil(T / 16) groups of 16 rows, up to 16 warps at
// hd <= 64 and 8 at hd 128 (registers), evenly over rounds.
//
//   Pass 1, query rows (16 per warp, Q and dO fragments in registers).
//     1a walks the keys in groups of 16 for S = Q . K^T and dPd = dO . V^T
//     and keeps m, l and delta = rowsum(P * dP) with online rescaling:
//     exact, from dP and P, with no saved output. It draws the dropout
//     mask here, one Philox call per four (query, key) pairs (the pair
//     trade of philox.cuh), and keeps it as bits in shared memory. m, 1 / l
//     and delta go to shared memory too (12 bytes a row). 1b walks the keys
//     again, forms dS and accumulates dQ = dS . K in registers, dS taken
//     from the accumulators as the A fragment: dq is written once, in bf16.
//     No dq_acc scratch, no read-modify-write in device memory.
//   Pass 2, keys (16 per warp, K and V fragments read from shared memory
//     at each step: in registers they would spill at hd 64). It recomputes
//     S^T = K . Q^T and dPd^T = V . dO^T, forms
//     Pd^T and dS^T from the shared statistics and mask, and accumulates
//     dV = Pd^T . dO and dK = dS^T . Q in registers, written once.
//
//   The exponentials are ex2.approx (flash_common.cuh, softmax_exp).
//
//   Nine 16 x 16 x hd tile products per (16 rows, 16 keys) pair, where the
//   algebra needs five: the price of recomputing instead of keeping P or
//   dS (T^2 x 2 bytes each) in shared memory, which would cut max_t to
//   about 160 at hd 64.
//
// Tensor cores, float32 (flash_bwd_tf32x3_kernel, up to max_t: 192 at
// hd 64, 96 at hd 128). The passes above, with mma.sync.m16n8k8 tf32 in
// 3xTF32 (tf32x3.cuh: a rounded hi/lo split of each operand, three
// products, chunks of 16 terms added in float32), float32 rows hd + 4
// floats apart (4 mod 32 words), operands read as scalars and split at
// their use, and an A fragment taken from the C fragment of the previous
// product in the permuted key order of c_to_a_perm (flash_common.cuh; its
// B operand read in the same order). The head in float32 is twice as wide:
// 122 KB at T 100, so one block an SM; it has up to 12 warps at hd <= 64
// (168 registers: T 150's ten row groups in one round) and 8 at hd 128.
// Two schedules, by T:
//   - up to keep_max_t (112 at hd 64, 128 at hd <= 32, 80 at hd 128) the
//     block keeps S and dP in shared memory, two [T][T + 4] float tiles
//     (104 KB at T 100, 227.6 KB in all; the keep mask moves into the S
//     rows' pad). 1a stores S (scaled, biased) and the masked dP as it
//     computes them; 1b reads them back, turns them into Pd and dS in
//     place and accumulates dQ; pass 2 reads Pd^T and dS^T off the tiles.
//     Five products, the algebra's, 15 tensor-core passes per tile pair;
//   - past it, the nine products of the bf16 instance, 27 passes.
// At the training shape it read 0.362 ms against the 0.082 ms bound on an
// H100 80GB HBM3 at 700 W (PERF.md), at T 150 (nine products) 1.19 against
// 0.134: the mma.sync stream holds it back, as in the forward, with seven
// warps an SM. Tried and dropped: the nine-product schedule at T 100
// (slower than SDPA there, and than the kept tiles by far); the hi/lo
// split on the FP32 pipes (no change; with lo rounded by integer
// operations, slower); at most 8 warps a block (T 150 then ran two rounds
// of 5 warps, slower than one round of 10).
//
// SIMT (flash_bwd_kernel; either type past its tensor-core T limit): the
// first port's kernel, FP32 pipes, one block of 4 warps per
// (head, batch row) owning all of that head's dq, dk and dv, in two phases
// over 64-query and 32-key tiles staged in shared memory as float32:
//
//   A. softmax statistics: for each query tile the block walks the keys
//      once with an online softmax and gets m, l and delta as above.
//   B. gradients. Keys outside, queries inside: for a key tile the block
//      holds dK and dV in registers while it walks the query tiles,
//      recomputes S and dPd, forms Pd and dS, and adds the tile's dS . K
//      into dq. dq is summed over key tiles in float32 in device memory (dq
//      itself for float32, a scratch dq_acc the wrapper allocates for
//      bfloat16); the thread that wrote an element is the one that reads it
//      back, so there is no race and no atomic.
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
                     float inv_keep, int batch0) {
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
          dp = dropout_keep(key, threshold, b + batch0, h, row, key_idx) ? dp * inv_keep : 0.f;
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
            const bool keep = dropout_keep(key, threshold, b + batch0, h, row, key_idx);
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
           uint32_t threshold, float inv_keep, int batch0, cudaStream_t stream) {
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
      static_cast<T*>(dv), nh, t_len, t_pad, scale, threshold, inv_keep, batch0);
  return (int)cudaGetLastError();
}

template <typename T, bool kDrop>
int dispatch_hd(const void* q, const void* k, const void* v, const void* bias,
                const void* d_out, const void* seed, void* dq, void* dq_acc,
                void* dk, void* dv, int bs, int nh, int t_len, int hd,
                float scale, uint32_t threshold, float inv_keep, int batch0,
                cudaStream_t stream) {
#define MIMRL_BWD_CASE(HD)                                                    \
  case HD:                                                                    \
    return launch<T, HD, kDrop>(q, k, v, bias, d_out, seed, dq, dq_acc, dk,   \
                                dv, bs, nh, t_len, scale, threshold,          \
                                inv_keep, batch0, stream)
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
                  uint32_t threshold, float inv_keep, int batch0, cudaStream_t stream) {
  if (dropout)
    return dispatch_hd<T, true>(q, k, v, bias, d_out, seed, dq, dq_acc, dk, dv,
                                bs, nh, t_len, hd, scale, threshold, inv_keep, batch0,
                                stream);
  return dispatch_hd<T, false>(q, k, v, bias, d_out, seed, dq, dq_acc, dk, dv,
                               bs, nh, t_len, hd, scale, threshold, inv_keep, batch0,
                               stream);
}


constexpr size_t kTcSmemLimit = 232448;  // the 227 KB a block may use

#if !defined(MIMRL_DTYPE) || MIMRL_DTYPE == 1
// ---------------------------------------------------------------------------
// The bf16 tensor-core instance: mma.sync.m16n8k16 bf16 -> float32.
// ---------------------------------------------------------------------------

// 16 warps at hd <= 64 (at most 128 registers a thread), 8 at hd 128,
// whose pass-1 fragments and accumulators need more. (8 warps at hd 64 were
// as fast at T 100 without dropout, slower with it, which training runs,
// and faster at T 150 without it: 16 suits the main path.)
template <int HD>
constexpr int tc_max_warps() {
  return HD <= 64 ? 16 : 8;
}

template <int HD>
struct TcBwdSmem {
  static constexpr int kS = TcRow<HD>::kStride;
  // Q, K, V, dO: t_pad rows each; bias, m, 1 / l, delta: t_pad floats each;
  // with dropout the keep mask, t_pad rows of t_pad / 8 bytes
  static size_t bytes(int t_pad, bool drop) {
    return (size_t)4 * t_pad * kS * sizeof(bf16) +
           (size_t)4 * t_pad * sizeof(float) +
           (drop ? (size_t)t_pad * (t_pad / 8) : 0);
  }
  // the longest sequence whose head fits, mask included
  static int max_t() {
    int t = 16;
    while (bytes(t + 16, true) <= kTcSmemLimit) t += 16;
    return t;
  }
};

template <int HD, bool kDrop>
__global__ void __launch_bounds__(tc_max_warps<HD>() * 32)
    flash_bwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const float* __restrict__ bias,
                        const bf16* __restrict__ d_out,
                        const long long* __restrict__ seed,
                        bf16* __restrict__ dq, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int nh, int t_len, int t_pad,
                        float scale, uint32_t threshold, float inv_keep, int batch0) {
  using R = TcRow<HD>;
  constexpr int kS = R::kStride;
  constexpr int kKS = R::kKSteps;
  constexpr int kDT = R::kDTiles;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + t_pad * kS;
  bf16* sV = sK + t_pad * kS;
  bf16* sDO = sV + t_pad * kS;
  float* sB = reinterpret_cast<float*>(sDO + t_pad * kS);
  float* sM = sB + t_pad;
  float* sInvL = sM + t_pad;
  float* sDelta = sInvL + t_pad;
  uint8_t* sMask = reinterpret_cast<uint8_t*>(sDelta + t_pad);
  const int mstride = t_pad / 8;  // mask bytes per query row

  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int b = blockIdx.y, h = blockIdx.x;
  const size_t head = ((size_t)b * nh + h) * (size_t)t_len * HD;
  const float* bias_row = bias + (size_t)b * t_len;
  uint2 key = make_uint2(0u, 0u);
  if (kDrop) key = philox_key(seed);

  // the whole head, once: each input is read from device memory once
  zero_pad_cols<HD>(sQ, 4 * t_pad);  // the copies below write other bytes
  stage_rows<HD>(sQ, q + head, 0, t_pad, t_len);
  stage_rows<HD>(sK, k + head, 0, t_pad, t_len);
  stage_rows<HD>(sV, v + head, 0, t_pad, t_len);
  stage_rows<HD>(sDO, d_out + head, 0, t_pad, t_len);
  cp_async_commit();
  for (int i = threadIdx.x; i < t_pad; i += blockDim.x)
    sB[i] = i < t_len ? bias_row[i] : 0.f;
  cp_async_wait<0>();
  __syncthreads();
  const int groups = t_pad / 16;

  // ---- pass 1, query rows: 16 a warp ----
  for (int rg = warp; rg < groups; rg += warps) {
    const int r0 = rg * 16;
    uint32_t qf[kKS][4], dof[kKS][4];
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      ldsm_x4(qf[ks], sQ + r0 * kS + a_addr<kS>(lane, ks * 16));
      ldsm_x4(dof[ks], sDO + r0 * kS + a_addr<kS>(lane, ks * 16));
    }
    // S = Q . K^T and dPd = dO . V^T for the keys [kc, kc + 16); the score
    // is s * scale + bias rounded twice, as the reference computes it, and
    // -inf past T
    auto products = [&](int kc, float (&s)[2][4], float (&dp)[2][4]) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks) {
        uint32_t r[4];
        ldsm_x4(r, sK + kc * kS + bn_addr<kS>(lane, ks * 16));
        mma_bf16(s[0], qf[ks], r[0], r[1]);
        mma_bf16(s[1], qf[ks], r[2], r[3]);
        ldsm_x4(r, sV + kc * kS + bn_addr<kS>(lane, ks * 16));
        mma_bf16(dp[0], dof[ks], r[0], r[1]);
        mma_bf16(dp[1], dof[ks], r[2], r[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kk = kc + 8 * j + 2 * t4 + (e & 1);
          s[j][e] = kk < t_len ? __fadd_rn(__fmul_rn(s[j][e], scale), sB[kk])
                               : -INFINITY;
        }
    };

    // 1a: m, l and delta = rowsum(P * dP) with online rescaling; the keep
    // mask is drawn here, one Philox call per four (query, key) pairs, and
    // kept in shared memory as bits
    float m_run[2] = {-INFINITY, -INFINITY}, l_part[2] = {0.f, 0.f},
          d_part[2] = {0.f, 0.f};
    for (int kc = 0; kc < t_pad; kc += 16) {
      float s[2][4], dp[2][4];
      products(kc, s, dp);
      if (kDrop) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          bool keep[4];
          dropout_keep_frag(key, threshold, b + batch0, h, r0 + g, kc + 8 * j, lane,
                            keep);
          uint32_t lo = (keep[0] << (2 * t4)) | (keep[1] << (2 * t4 + 1));
          uint32_t hi = (keep[2] << (2 * t4)) | (keep[3] << (2 * t4 + 1));
          lo |= __shfl_xor_sync(0xffffffffu, lo, 1);
          lo |= __shfl_xor_sync(0xffffffffu, lo, 2);
          hi |= __shfl_xor_sync(0xffffffffu, hi, 1);
          hi |= __shfl_xor_sync(0xffffffffu, hi, 2);
          if (t4 == 0) sMask[(r0 + g) * mstride + kc / 8 + j] = (uint8_t)lo;
          if (t4 == 1) sMask[(r0 + g + 8) * mstride + kc / 8 + j] = (uint8_t)hi;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[j][e] = keep[e] ? dp[j][e] * inv_keep : 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mx = fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]),
                               fmaxf(s[1][2 * r], s[1][2 * r + 1]));
        const float m_new = fmaxf(m_run[r], quad_max(mx));
        const float alpha = softmax_exp(m_run[r] - m_new);  // 0 on the first tile
        m_run[r] = m_new;
        l_part[r] *= alpha;
        d_part[r] *= alpha;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float ex = softmax_exp(s[j][e] - m_run[e >> 1]);
          l_part[e >> 1] += ex;
          d_part[e >> 1] += ex * dp[j][e];
        }
    }
    float inv_l[2], delta[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      inv_l[r] = 1.f / quad_sum(l_part[r]);
      delta[r] = quad_sum(d_part[r]) * inv_l[r];
      if (t4 == 0) {
        const int row = r0 + g + 8 * r;
        sM[row] = m_run[r];
        sInvL[row] = inv_l[r];
        sDelta[row] = delta[r];
      }
    }
    __syncwarp();  // this warp's mask rows, for 1b

    // 1b: dS, and dQ = dS . K summed in registers, written once
    float dqa[kDT][4];
#pragma unroll
    for (int d = 0; d < kDT; ++d) dqa[d][0] = dqa[d][1] = dqa[d][2] = dqa[d][3] = 0.f;
    for (int kc = 0; kc < t_pad; kc += 16) {
      float s[2][4], dp[2][4];
      products(kc, s, dp);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t bits[2] = {0u, 0u};
        if (kDrop) {
          bits[0] = sMask[(r0 + g) * mstride + kc / 8 + j] >> (2 * t4);
          bits[1] = sMask[(r0 + g + 8) * mstride + kc / 8 + j] >> (2 * t4);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float p = softmax_exp(s[j][e] - m_run[r]) * inv_l[r];  // 0 past T
          float dpv = dp[j][e];
          if (kDrop) dpv = (bits[r] >> (e & 1)) & 1u ? dpv * inv_keep : 0.f;
          s[j][e] = p * (dpv - delta[r]) * scale;
        }
      }
      uint32_t a[4];
      c_to_a(a, s[0], s[1]);  // dS * scale rounded to bf16
#pragma unroll
      for (int dp2 = 0; dp2 < kDT / 2; ++dp2) {
        uint32_t r[4];
        ldsm_x4_t(r, sK + kc * kS + a_addr<kS>(lane, dp2 * 16));
        mma_bf16(dqa[2 * dp2], a, r[0], r[1]);
        mma_bf16(dqa[2 * dp2 + 1], a, r[2], r[3]);
      }
      if (kDT % 2) {  // hd 8
        uint32_t r[2];
        ldsm_x2_t(r, sK + kc * kS + a_addr<kS>(lane, 0));
        mma_bf16(dqa[kDT - 1], a, r[0], r[1]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + g + 8 * r;
      if (row >= t_len) continue;
      bf16* dst = dq + head + (size_t)row * HD + 2 * t4;
#pragma unroll
      for (int d = 0; d < kDT; ++d)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * d) =
            __floats2bfloat162_rn(dqa[d][2 * r], dqa[d][2 * r + 1]);
    }
  }
  __syncthreads();  // every row's m, 1 / l, delta and mask

  // ---- pass 2, keys: 16 a warp; S^T = K . Q^T and dPd^T = V . dO^T
  // recomputed, dV = Pd^T . dO and dK = dS^T . Q summed in registers ----
  for (int kg = warp; kg < groups; kg += warps) {
    const int k0 = kg * 16;
    bool k_in[2];
    float bk[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kr = k0 + g + 8 * r;
      k_in[r] = kr < t_len;
      bk[r] = sB[kr];
    }
    float dka[kDT][4], dva[kDT][4];
#pragma unroll
    for (int d = 0; d < kDT; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[d][e] = dva[d][e] = 0.f;

    for (int qc = 0; qc < t_pad; qc += 16) {
      float st[2][4], dpt[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks) {
        // K and V fragments from shared memory at each step: holding them
        // in registers would cost 32 at hd 64 and spill
        uint32_t ka[4], va[4], r[4];
        ldsm_x4(ka, sK + k0 * kS + a_addr<kS>(lane, ks * 16));
        ldsm_x4(va, sV + k0 * kS + a_addr<kS>(lane, ks * 16));
        ldsm_x4(r, sQ + qc * kS + bn_addr<kS>(lane, ks * 16));
        mma_bf16(st[0], ka, r[0], r[1]);
        mma_bf16(st[1], ka, r[2], r[3]);
        ldsm_x4(r, sDO + qc * kS + bn_addr<kS>(lane, ks * 16));
        mma_bf16(dpt[0], va, r[0], r[1]);
        mma_bf16(dpt[1], va, r[2], r[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int qi = qc + 8 * j + 2 * t4 + c;  // this column's query
          const bool q_in = qi < t_len;
          const float m = sM[qi], il = sInvL[qi], dl = sDelta[qi];
          // keys k0 .. k0 + 15 of this query's mask row, one bit each
          const uint32_t bits =
              kDrop ? *reinterpret_cast<const uint16_t*>(sMask + qi * mstride + k0 / 8)
                    : 0u;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int e = 2 * r + c;
            const float x = __fadd_rn(__fmul_rn(st[j][e], scale), bk[r]);
            const float p = k_in[r] && q_in ? softmax_exp(x - m) * il : 0.f;
            float pd = p, dpv = dpt[j][e];
            if (kDrop) {
              const bool keep = (bits >> (g + 8 * r)) & 1u;
              pd = keep ? p * inv_keep : 0.f;
              dpv = keep ? dpv * inv_keep : 0.f;
            }
            st[j][e] = pd;                          // Pd^T
            dpt[j][e] = p * (dpv - dl) * scale;     // dS^T * scale
          }
        }
      uint32_t apd[4], ads[4];
      c_to_a(apd, st[0], st[1]);  // rounded to bf16
      c_to_a(ads, dpt[0], dpt[1]);
#pragma unroll
      for (int dp2 = 0; dp2 < kDT / 2; ++dp2) {
        uint32_t r[4];
        ldsm_x4_t(r, sDO + qc * kS + a_addr<kS>(lane, dp2 * 16));
        mma_bf16(dva[2 * dp2], apd, r[0], r[1]);
        mma_bf16(dva[2 * dp2 + 1], apd, r[2], r[3]);
        ldsm_x4_t(r, sQ + qc * kS + a_addr<kS>(lane, dp2 * 16));
        mma_bf16(dka[2 * dp2], ads, r[0], r[1]);
        mma_bf16(dka[2 * dp2 + 1], ads, r[2], r[3]);
      }
      if (kDT % 2) {  // hd 8
        uint32_t r[2];
        ldsm_x2_t(r, sDO + qc * kS + a_addr<kS>(lane, 0));
        mma_bf16(dva[kDT - 1], apd, r[0], r[1]);
        ldsm_x2_t(r, sQ + qc * kS + a_addr<kS>(lane, 0));
        mma_bf16(dka[kDT - 1], ads, r[0], r[1]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kr = k0 + g + 8 * r;
      if (kr >= t_len) continue;
      const size_t off = head + (size_t)kr * HD + 2 * t4;
#pragma unroll
      for (int d = 0; d < kDT; ++d) {
        *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * d) =
            __floats2bfloat162_rn(dka[d][2 * r], dka[d][2 * r + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * d) =
            __floats2bfloat162_rn(dva[d][2 * r], dva[d][2 * r + 1]);
      }
    }
  }
}

#endif  // the bf16 tensor-core instance

#if !defined(MIMRL_DTYPE) || MIMRL_DTYPE == 0
// ---------------------------------------------------------------------------
// The float32 tensor-core instance: mma.sync.m16n8k8 tf32 in 3xTF32.
// ---------------------------------------------------------------------------

// One block fills an SM's shared memory from T 100 on, so its warps are all
// the SM has: up to 12 at hd <= 64 (168 registers a thread; T 150 runs 10
// warps in one round, against 5 in two rounds with 8), 8 at hd 128, whose
// T limit is 96 (6 warps) and whose accumulators need more registers.
template <int HD>
constexpr int f32_max_warps() {
  return HD <= 64 ? 12 : 8;
}

template <int HD>
struct F32BwdSmem {
  static constexpr int kS = F32Row<HD>::kStride;
  // Q, K, V, dO: t_pad float32 rows each; bias, m, 1 / l, delta: t_pad
  // floats each; with dropout the keep mask, t_pad rows of t_pad / 8 bytes
  static size_t bytes(int t_pad, bool drop) {
    return (size_t)4 * t_pad * kS * sizeof(float) +
           (size_t)4 * t_pad * sizeof(float) +
           (drop ? (size_t)t_pad * (t_pad / 8) : 0);
  }
  // the longest sequence whose head fits, mask included
  static int max_t() {
    int t = 16;
    while (bytes(t + 16, true) <= kTcSmemLimit) t += 16;
    return t;
  }
  // kKeep: the head, bias and statistics as above, and the S and dP tiles,
  // t_pad rows of t_pad + 4 floats each (the keep mask in the 16 bytes of
  // each S row's pad, so T <= 128)
  static size_t bytes_keep(int t_pad) {
    return (size_t)4 * t_pad * kS * sizeof(float) +
           (size_t)4 * t_pad * sizeof(float) +
           (size_t)2 * t_pad * (t_pad + 4) * sizeof(float);
  }
  static int keep_max_t() {
    int t = 0;
    while (t + 16 <= 128 && bytes_keep(t + 16) <= kTcSmemLimit) t += 16;
    return t;
  }
};

template <int HD, bool kDrop, bool kKeep>
__global__ void __launch_bounds__(f32_max_warps<HD>() * 32, 1)
    flash_bwd_tf32x3_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ bias,
                            const float* __restrict__ d_out,
                            const long long* __restrict__ seed,
                            float* __restrict__ dq, float* __restrict__ dk,
                            float* __restrict__ dv, int nh, int t_len,
                            int t_pad, float scale, uint32_t threshold,
                            float inv_keep, int batch0) {
  constexpr int kS = F32Row<HD>::kStride;
  constexpr int kDT = F32Row<HD>::kDTiles;
  constexpr int kSteps = HD < 16 ? 1 : 2;  // k8 steps of a 16-term chunk of hd
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sK = sQ + t_pad * kS;
  float* sV = sK + t_pad * kS;
  float* sDO = sV + t_pad * kS;
  float* sB = sDO + t_pad * kS;
  float* sM = sB + t_pad;
  float* sInvL = sM + t_pad;
  float* sDelta = sInvL + t_pad;
  // kKeep: the S and dP tiles, [query][key], rows of t_pad + 4 floats (4
  // or 20 mod 32 words: the transposed fragment reads of pass 2 fall into
  // distinct banks), the keep mask in each S row's 4 pad floats; else the
  // mask alone, t_pad / 8 bytes a row
  const int tstride = t_pad + 4;
  float* sS = sDelta + t_pad;
  float* sP = sS + t_pad * tstride;
  auto mask_row = [&](int row) {
    return kKeep ? reinterpret_cast<uint8_t*>(sS + row * tstride + t_pad)
                 : reinterpret_cast<uint8_t*>(sDelta + t_pad) + row * (t_pad / 8);
  };

  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int b = blockIdx.y, h = blockIdx.x;
  const size_t head = ((size_t)b * nh + h) * (size_t)t_len * HD;
  const float* bias_row = bias + (size_t)b * t_len;
  uint2 key = make_uint2(0u, 0u);
  if (kDrop) key = philox_key(seed);
  // two C fragments (rows r0 + g and + 8, columns c0 + 8j + 2t and + 1) to
  // and from a tile
  auto store_tile = [&](float* tile, int r0, int c0, const float (&c)[2][4]) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(tile + (r0 + g + 8 * r) * tstride + c0 +
                                   8 * j + 2 * t4) =
            make_float2(c[j][2 * r], c[j][2 * r + 1]);
  };
  auto load_tile = [&](const float* tile, int r0, int c0, float (&c)[2][4]) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 x = *reinterpret_cast<const float2*>(
            tile + (r0 + g + 8 * r) * tstride + c0 + 8 * j + 2 * t4);
        c[j][2 * r] = x.x;
        c[j][2 * r + 1] = x.y;
      }
  };

  // the whole head, once: each input is read from device memory once
  stage_rows_f32<HD>(sQ, q + head, 0, t_pad, t_len);
  stage_rows_f32<HD>(sK, k + head, 0, t_pad, t_len);
  stage_rows_f32<HD>(sV, v + head, 0, t_pad, t_len);
  stage_rows_f32<HD>(sDO, d_out + head, 0, t_pad, t_len);
  cp_async_commit();
  for (int i = threadIdx.x; i < t_pad; i += blockDim.x)
    sB[i] = i < t_len ? bias_row[i] : 0.f;
  cp_async_wait<0>();
  __syncthreads();
  const int groups = t_pad / 16;

  // X . Y^T for the 16 rows of `x` and of `y` (row g, column t of each),
  // both [rows][hd] in shared memory, over hd in chunks of 16 terms: the
  // C fragments of the two n8 tiles of y's rows, each chunk summed on the
  // tensor cores and added in float32
  auto rows_product = [&](const float* x, const float* y, float (&c)[2][4]) {
    zero4(c[0]);
    zero4(c[1]);
#pragma unroll
    for (int d0 = 0; d0 < HD; d0 += 16) {
      float part[2][4];
      zero4(part[0]);
      zero4(part[1]);
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        Tf32A a;
        load_a<kS>(a, x + d0 + 8 * kk);
        mma_b_rows(part[0], a, y + d0 + 8 * kk);
        mma_b_rows(part[1], a, y + 8 * kS + d0 + 8 * kk);
      }
      add4(c[0], part[0]);
      add4(c[1], part[1]);
    }
  };
  // acc[d] += A . Z over 16 rows of z (the contraction), A the C
  // fragments of two n8 tiles in c_to_a_perm's order; z [rows][hd] at its
  // row 2t, column g
  auto cols_product = [&](const float (&c)[2][4], const float* z,
                          float (&acc)[kDT][4]) {
    Tf32A a[2];
    c_to_a_perm(a[0], c[0]);
    c_to_a_perm(a[1], c[1]);
#pragma unroll
    for (int d = 0; d < kDT; ++d) {
      float part[4];
      zero4(part);
      mma_b_perm<kS>(part, a[0], z + 8 * d);
      mma_b_perm<kS>(part, a[1], z + 8 * kS + 8 * d);
      add4(acc[d], part);
    }
  };

  // ---- pass 1, query rows: 16 a warp ----
  for (int rg = warp; rg < groups; rg += warps) {
    const int r0 = rg * 16;
    const float* sQr = sQ + (r0 + g) * kS + t4;
    const float* sDOr = sDO + (r0 + g) * kS + t4;
    // S = Q . K^T and dPd = dO . V^T for the keys [kc, kc + 16); the score
    // is s * scale + bias rounded twice, as the reference computes it, and
    // -inf past T
    auto products = [&](int kc, float (&s)[2][4], float (&dp)[2][4]) {
      rows_product(sQr, sK + (kc + g) * kS + t4, s);
      rows_product(sDOr, sV + (kc + g) * kS + t4, dp);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kk = kc + 8 * j + 2 * t4 + (e & 1);
          s[j][e] = kk < t_len ? __fadd_rn(__fmul_rn(s[j][e], scale), sB[kk])
                               : -INFINITY;
        }
    };

    // 1a: m, l and delta = rowsum(P * dP) with online rescaling; the keep
    // mask is drawn here, one Philox call per four (query, key) pairs, and
    // kept in shared memory as bits
    float m_run[2] = {-INFINITY, -INFINITY}, l_part[2] = {0.f, 0.f},
          d_part[2] = {0.f, 0.f};
    for (int kc = 0; kc < t_pad; kc += 16) {
      float s[2][4], dp[2][4];
      products(kc, s, dp);
      if (kDrop) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          bool keep[4];
          dropout_keep_frag(key, threshold, b + batch0, h, r0 + g, kc + 8 * j, lane,
                            keep);
          uint32_t lo = (keep[0] << (2 * t4)) | (keep[1] << (2 * t4 + 1));
          uint32_t hi = (keep[2] << (2 * t4)) | (keep[3] << (2 * t4 + 1));
          lo |= __shfl_xor_sync(0xffffffffu, lo, 1);
          lo |= __shfl_xor_sync(0xffffffffu, lo, 2);
          hi |= __shfl_xor_sync(0xffffffffu, hi, 1);
          hi |= __shfl_xor_sync(0xffffffffu, hi, 2);
          if (t4 == 0) mask_row(r0 + g)[kc / 8 + j] = (uint8_t)lo;
          if (t4 == 1) mask_row(r0 + g + 8)[kc / 8 + j] = (uint8_t)hi;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[j][e] = keep[e] ? dp[j][e] * inv_keep : 0.f;
        }
      }
      if (kKeep) {  // for 1b, which then needs no product of its own
        store_tile(sS, r0, kc, s);
        store_tile(sP, r0, kc, dp);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mx = fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]),
                               fmaxf(s[1][2 * r], s[1][2 * r + 1]));
        const float m_new = fmaxf(m_run[r], quad_max(mx));
        const float alpha = softmax_exp(m_run[r] - m_new);  // 0 on the first tile
        m_run[r] = m_new;
        l_part[r] *= alpha;
        d_part[r] *= alpha;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float ex = softmax_exp(s[j][e] - m_run[e >> 1]);
          l_part[e >> 1] += ex;
          d_part[e >> 1] += ex * dp[j][e];
        }
    }
    float inv_l[2], delta[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      inv_l[r] = 1.f / quad_sum(l_part[r]);
      delta[r] = quad_sum(d_part[r]) * inv_l[r];
      if (t4 == 0) {
        const int row = r0 + g + 8 * r;
        sM[row] = m_run[r];
        sInvL[row] = inv_l[r];
        sDelta[row] = delta[r];
      }
    }
    __syncwarp();  // this warp's mask rows, for 1b

    // 1b: dS, and dQ = dS . K summed in registers, written once
    float dqa[kDT][4];
#pragma unroll
    for (int d = 0; d < kDT; ++d) zero4(dqa[d]);
    for (int kc = 0; kc < t_pad; kc += 16) {
      float s[2][4], dp[2][4];
      if (kKeep) {
        load_tile(sS, r0, kc, s);
        load_tile(sP, r0, kc, dp);  // the keep mask applied already
      } else {
        products(kc, s, dp);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t bits[2] = {0u, 0u};
        if (kDrop) {
          bits[0] = mask_row(r0 + g)[kc / 8 + j] >> (2 * t4);
          bits[1] = mask_row(r0 + g + 8)[kc / 8 + j] >> (2 * t4);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const bool kept = (bits[r] >> (e & 1)) & 1u;
          float p = softmax_exp(s[j][e] - m_run[r]) * inv_l[r];  // 0 past T
          float dpv = dp[j][e];
          if (kKeep) {
            // rows past T must add nothing to dK and dV in pass 2
            if (r0 + g + 8 * r >= t_len) p = 0.f;
            s[j][e] = kDrop ? (kept ? p * inv_keep : 0.f) : p;  // Pd
          } else if (kDrop) {
            dpv = kept ? dpv * inv_keep : 0.f;
          }
          dp[j][e] = p * (dpv - delta[r]) * scale;
        }
      }
      if (kKeep) {
        store_tile(sS, r0, kc, s);   // Pd
        store_tile(sP, r0, kc, dp);  // dS * scale
      }
      cols_product(dp, sK + (kc + 2 * t4) * kS + g, dqa);  // dS * scale . K
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + g + 8 * r;
      if (row >= t_len) continue;
      float* dst = dq + head + (size_t)row * HD + 2 * t4;
#pragma unroll
      for (int d = 0; d < kDT; ++d)
        *reinterpret_cast<float2*>(dst + 8 * d) =
            make_float2(dqa[d][2 * r], dqa[d][2 * r + 1]);
    }
  }
  __syncthreads();  // every row's m, 1 / l, delta and mask

  // ---- pass 2, keys: 16 a warp; S^T = K . Q^T and dPd^T = V . dO^T
  // recomputed, dV = Pd^T . dO and dK = dS^T . Q summed in registers ----
  for (int kg = warp; kg < groups; kg += warps) {
    const int k0 = kg * 16;
    const float* sKr = sK + (k0 + g) * kS + t4;
    const float* sVr = sV + (k0 + g) * kS + t4;
    bool k_in[2];
    float bk[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kr = k0 + g + 8 * r;
      k_in[r] = kr < t_len;
      bk[r] = sB[kr];
    }
    float dka[kDT][4], dva[kDT][4];
#pragma unroll
    for (int d = 0; d < kDT; ++d) {
      zero4(dka[d]);
      zero4(dva[d]);
    }

    for (int qc = 0; qc < t_pad; qc += 16) {
      float st[2][4], dpt[2][4];
      if (kKeep) {
        // Pd^T and dS^T from the tiles, in C order (rows: keys k0 + g and
        // + 8; columns: queries qc + 8j + 2t and + 1)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int off = (qc + 8 * j + 2 * t4 + (e & 1)) * tstride + k0 +
                            g + 8 * (e >> 1);
            st[j][e] = sS[off];
            dpt[j][e] = sP[off];
          }
        const int zrow = (qc + 2 * t4) * kS + g;
        cols_product(st, sDO + zrow, dva);
        cols_product(dpt, sQ + zrow, dka);
        continue;
      }
      rows_product(sKr, sQ + (qc + g) * kS + t4, st);
      rows_product(sVr, sDO + (qc + g) * kS + t4, dpt);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int qi = qc + 8 * j + 2 * t4 + c;  // this column's query
          const bool q_in = qi < t_len;
          const float m = sM[qi], il = sInvL[qi], dl = sDelta[qi];
          // keys k0 .. k0 + 15 of this query's mask row, one bit each
          const uint32_t bits =
              kDrop ? *reinterpret_cast<const uint16_t*>(mask_row(qi) + k0 / 8)
                    : 0u;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int e = 2 * r + c;
            const float x = __fadd_rn(__fmul_rn(st[j][e], scale), bk[r]);
            const float p = k_in[r] && q_in ? softmax_exp(x - m) * il : 0.f;
            float pd = p, dpv = dpt[j][e];
            if (kDrop) {
              const bool keep = (bits >> (g + 8 * r)) & 1u;
              pd = keep ? p * inv_keep : 0.f;
              dpv = keep ? dpv * inv_keep : 0.f;
            }
            st[j][e] = pd;                          // Pd^T
            dpt[j][e] = p * (dpv - dl) * scale;     // dS^T * scale
          }
        }
      const int zrow = (qc + 2 * t4) * kS + g;
      cols_product(st, sDO + zrow, dva);
      cols_product(dpt, sQ + zrow, dka);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kr = k0 + g + 8 * r;
      if (kr >= t_len) continue;
      const size_t off = head + (size_t)kr * HD + 2 * t4;
#pragma unroll
      for (int d = 0; d < kDT; ++d) {
        *reinterpret_cast<float2*>(dk + off + 8 * d) =
            make_float2(dka[d][2 * r], dka[d][2 * r + 1]);
        *reinterpret_cast<float2*>(dv + off + 8 * d) =
            make_float2(dva[d][2 * r], dva[d][2 * r + 1]);
      }
    }
  }
}
#endif  // the float32 tensor-core instance

#if !defined(MIMRL_DTYPE) || MIMRL_DTYPE <= 1
// the tensor-core instance of the library's input type
template <int HD, bool kDrop>
int launch_tc(const void* q, const void* k, const void* v, const void* bias,
              const void* d_out, const void* seed, void* dq, void* dk,
              void* dv, int bs, int nh, int t_len, float scale,
              uint32_t threshold, float inv_keep, int batch0, cudaStream_t stream) {
  const int t_pad = (t_len + 15) / 16 * 16;
#if defined(MIMRL_DTYPE) && MIMRL_DTYPE == 0
  using T = float;
  using Smem = F32BwdSmem<HD>;
  // short heads keep their S and dP tiles (five products, not nine)
  const bool keep = t_pad <= Smem::keep_max_t();
  auto kern = keep ? flash_bwd_tf32x3_kernel<HD, kDrop, true>
                   : flash_bwd_tf32x3_kernel<HD, kDrop, false>;
  const int max_warps = f32_max_warps<HD>();
  const size_t smem =
      keep ? Smem::bytes_keep(t_pad) : Smem::bytes(t_pad, kDrop);
#else
  using T = bf16;
  using Smem = TcBwdSmem<HD>;
  auto kern = flash_bwd_tc_kernel<HD, kDrop>;
  const int max_warps = tc_max_warps<HD>();
  const size_t smem = Smem::bytes(t_pad, kDrop);
#endif
  if (t_pad > Smem::max_t()) return (int)cudaErrorInvalidValue;
  // ceil(T / 16) groups of 16 rows (pass 1) or keys (pass 2) over the
  // fewest rounds of at most max_warps warps, evenly
  const int groups = t_pad / 16;
  const int rounds = (groups + max_warps - 1) / max_warps;
  const int warps = (groups + rounds - 1) / rounds;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(nh, bs), warps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<const T*>(d_out), static_cast<const long long*>(seed),
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), nh,
      t_len, t_pad, scale, threshold, inv_keep, batch0);
  return (int)cudaGetLastError();
}

template <bool kDrop>
int dispatch_tc(const void* q, const void* k, const void* v, const void* bias,
                const void* d_out, const void* seed, void* dq, void* dk,
                void* dv, int bs, int nh, int t_len, int hd, float scale,
                uint32_t threshold, float inv_keep, int batch0, cudaStream_t stream) {
#define MIMRL_BWD_TC_CASE(HD)                                                 \
  case HD:                                                                    \
    return launch_tc<HD, kDrop>(q, k, v, bias, d_out, seed, dq, dk, dv, bs,   \
                                nh, t_len, scale, threshold, inv_keep, batch0, stream)
  switch (hd) {
    MIMRL_BWD_TC_CASE(8);
    MIMRL_BWD_TC_CASE(16);
    MIMRL_BWD_TC_CASE(32);
    MIMRL_BWD_TC_CASE(64);
    MIMRL_BWD_TC_CASE(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef MIMRL_BWD_TC_CASE
}

#if defined(MIMRL_DTYPE) && MIMRL_DTYPE == 0
template <int HD>
using TcSmem = F32BwdSmem<HD>;
#else
template <int HD>
using TcSmem = TcBwdSmem<HD>;
#endif

int tc_max_t(int hd) {
  switch (hd) {
    case 8: return TcSmem<8>::max_t();
    case 16: return TcSmem<16>::max_t();
    case 32: return TcSmem<32>::max_t();
    case 64: return TcSmem<64>::max_t();
    case 128: return TcSmem<128>::max_t();
    default: return -1;
  }
}
#endif  // the tensor-core instances

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; compiled with -DMIMRL_DTYPE=0 or 1 the
// library holds that type's kernels only and refuses the other.
// dq_acc: float32 [bs, nh, T, hd] scratch for the sum of dq over key tiles;
// for float32 it may be dq itself.
// dropout: 0 = off (seed may be null), 1 = on: seed points to one int64 on
// the device, threshold is uint32(p * 2^32), inv_keep is 1 / (1 - p) and
// batch0 is the global batch row of q's row 0 in the Philox counter (a
// data-parallel rank draws the mask of its rows of the whole batch).
// Returns a cudaError_t value (0 = ok).
extern "C" int mimrl_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* bias,
    const void* d_out, const void* seed, void* dq, void* dq_acc, void* dk,
    void* dv, int bs, int nh, int t_len, int hd, int dtype, float scale,
    int dropout, unsigned int threshold, float inv_keep, int batch0, void* stream) {
  if (bs <= 0 || nh <= 0 || t_len <= 0 || nh > 65535 || bs > 65535 ||
      t_len > kMaxT)
    return (int)cudaErrorInvalidValue;
  if (dropout && seed == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#if !defined(MIMRL_DTYPE) || MIMRL_DTYPE == 0
  if (dtype == 0)
    return dispatch_drop<float>(q, k, v, bias, d_out, seed, dq, dq_acc, dk, dv,
                                bs, nh, t_len, hd, scale, dropout, threshold,
                                inv_keep, batch0, s);
#endif
#if !defined(MIMRL_DTYPE) || MIMRL_DTYPE == 1
  if (dtype == 1)
    return dispatch_drop<__nv_bfloat16>(q, k, v, bias, d_out, seed, dq, dq_acc,
                                        dk, dv, bs, nh, t_len, hd, scale,
                                        dropout, threshold, inv_keep, batch0, s);
#endif
  return (int)cudaErrorInvalidValue;
}

#if defined(MIMRL_DTYPE) && MIMRL_DTYPE <= 1
// The tensor-core instance of the library's input type (bf16 or float32
// tensors), no dq_acc; arguments otherwise as above without the dtype. T
// must not exceed mimrl_flash_attention_bwd_tc_max_t(hd), and q, k, v, d_out
// must be 16-byte aligned (the wrapper checks both).
extern "C" int mimrl_flash_attention_bwd_tc(
    const void* q, const void* k, const void* v, const void* bias,
    const void* d_out, const void* seed, void* dq, void* dk, void* dv, int bs,
    int nh, int t_len, int hd, float scale, int dropout,
    unsigned int threshold, float inv_keep, int batch0, void* stream) {
  if (bs <= 0 || nh <= 0 || t_len <= 0 || nh > 65535 || bs > 65535)
    return (int)cudaErrorInvalidValue;
  if (dropout && seed == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dropout)
    return dispatch_tc<true>(q, k, v, bias, d_out, seed, dq, dk, dv, bs, nh,
                             t_len, hd, scale, threshold, inv_keep, batch0, s);
  return dispatch_tc<false>(q, k, v, bias, d_out, seed, dq, dk, dv, bs, nh,
                            t_len, hd, scale, threshold, inv_keep, batch0, s);
}

// the longest T the library's tensor-core backward takes at head dim hd (-1:
// no such instance), from the 227 KB of shared memory a block may use
extern "C" int mimrl_flash_attention_bwd_tc_max_t(int hd) { return tc_max_t(hd); }
#endif
