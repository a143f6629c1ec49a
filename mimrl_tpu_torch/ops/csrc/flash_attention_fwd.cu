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
// Bound on the H100 SXM at its 700 W limit (3.35 TB/s; 989 TFLOP/s bf16 and
// 495 TFLOP/s TF32 on the tensor cores) at the serving shape
// [128, 12, 100, 64]: the kernel must read q, k, v and write out, in bf16
// 4 x 19.7 MB = 78.6 MB -> 23.5 us, in float32 157 MB -> 47 us; the two
// products are 4 * bs * nh * T^2 * hd = 3.9 GFLOP -> 4 us on the tensor cores
// in bf16, 24 us as three TF32 products each in float32. So the function is
// bound by bytes in both types.
//
// Two instances, chosen by the wrapper (ops/flash_attention.py::_instance);
// every shape takes the tensor-core one.
//
// Tensor cores, bf16 (flash_fwd_tc_kernel). Both products on
// mma.sync.m16n8k16 bf16 -> float32; the SIMT instance below would need
// 58 us for the FLOPs alone at the same card's 67 TFLOP/s FP32 peak. Each warp owns 16 query
// rows. One block per (head, batch row) holds ceil(T / 16) warps, split
// over ceil(T / 128) blocks where T > 128 (T 100: one block of 7 warps;
// T 150: two of 5), so K and V are read once per block and only the last
// warp carries rows past T. (A grid of fixed 64-row blocks would read K
// and V twice at T 100 and leave one warp of the second block idle.) Q is
// staged once, K and V in 64-key tiles, double-buffered, all by 16-byte
// cp.async into rows padded by 16 bytes, so that the eight rows an
// ldmatrix phase reads fall into distinct banks. S = Q . K^T takes Q and K as they lie
// (row-major [T, hd]: plain ldmatrix); P . V takes P from S's accumulator
// registers (the C fragments of two n8 tiles are the A fragment of one k16
// step; P is rounded to bf16 there and never goes to shared memory) and V
// through ldmatrix.trans. Online softmax over the 64-key tiles, so any T;
// keys are padded only to the mma's 16, keys past T get -inf, and a 16-key
// group wholly past T is skipped. Dropout draws one Philox block per lane
// per n8 tile: lanes 2j and 2j + 1 of a quad need the same four words for
// rows g and g + 8, so each computes one row and they trade two words
// (philox.cuh, dropout_keep_frag): one Philox call per four (query, key)
// pairs, the bits of dropout_keep_mask. The exponentials are ex2.approx
// (flash_common.cuh, softmax_exp). The output is stored from the
// registers, a bf16 pair per lane.
//
// Tensor cores, float32 (flash_fwd_tf32x3_kernel): the same blocks, warps,
// tiles, online softmax and dropout, with mma.sync.m16n8k8 tf32 in 3xTF32
// (tf32x3.cuh: each operand split into a rounded hi and lo, three products,
// the tensor cores' sums taken in chunks of 16 terms and added in float32),
// so float32 keeps its 2e-5 tolerance with TF32 switched off. Rows are
// float32, hd + 4 floats apart (4 mod 32 words: a fragment's eight rows and
// four columns fall into 32 banks), read as scalars and split at their use.
// P goes from the S registers into the A fragment of P . V without a
// shuffle: the C fragment holds keys 2t and 2t + 1, which the A fragment
// takes as its columns t and t + 4 (c_to_a_perm), and V's B fragment is
// read in the same key order, rows 2t and 2t + 1. 105 KB of shared memory
// at hd 64 and T 100: two blocks, 14 warps an SM. It read 0.132 ms against
// the 0.047 ms bound on an H100 80GB HBM3 at 700 W (PERF.md): 1.2 TB/s and
// a sixth of the TF32 rate. What holds it back is the mma.sync stream
// itself, three dependent TF32 products per k8 step for each product of
// bf16's k16 step, with the fragment loads and splits beside them: moving
// the splits to the FP32 pipes (hi as (c v) - ((c v) - v), c = 2^13 + 1,
// lo unrounded) left the time unchanged and was dropped, as was rounding
// that lo by integer operations (slower).
//
// SIMT (flash_fwd_kernel): the first port's kernel, FP32 pipes, either
// type. No shape routes to it any longer; its C entry point
// (mimrl_flash_attention_fwd, with a dtype argument) stays for
// chip_smoke.py, which times it beside the float32 tensor-core instance.
// One block of 4 warps per (64-query tile, head, batch row) stages its Q
// tile once, then walks the keys in tiles of 64 staged in shared memory
// (K, V and the bias converted to float32), with an online softmax: each
// warp owns 16 query rows, each lane two keys of the tile for Q . K^T and
// hd/32 output columns for P . V.
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
                     float inv_keep, int batch0) {
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
        if (!dropout_keep(key, threshold, b + batch0, h, row, k0 + lane)) pa = 0.f;
        if (!dropout_keep(key, threshold, b + batch0, h, row, k0 + lane + 32)) pb = 0.f;
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
           uint32_t threshold, float inv_keep, int batch0, cudaStream_t stream) {
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
      scale, threshold, inv_keep, batch0);
  return (int)cudaGetLastError();
}

template <typename T, bool kDrop>
int dispatch_hd(const void* q, const void* k, const void* v, const void* bias,
                void* out, const void* seed, int bs, int nh, int t_len, int hd,
                float scale, uint32_t threshold, float inv_keep, int batch0,
                cudaStream_t stream) {
#define MIMRL_FWD_CASE(HD)                                                   \
  case HD:                                                                   \
    return launch<T, HD, kDrop>(q, k, v, bias, out, seed, bs, nh, t_len,     \
                                scale, threshold, inv_keep, batch0, stream)
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
                  uint32_t threshold, float inv_keep, int batch0, cudaStream_t stream) {
  if (dropout)
    return dispatch_hd<T, true>(q, k, v, bias, out, seed, bs, nh, t_len, hd,
                                scale, threshold, inv_keep, batch0, stream);
  return dispatch_hd<T, false>(q, k, v, bias, out, seed, bs, nh, t_len, hd,
                               scale, threshold, inv_keep, batch0, stream);
}


// the tensor-core instances, both types
constexpr int kTcMaxWarps = 8;  // 16 query rows each
constexpr int kTcKeys = 64;     // keys per staged K/V tile

#if !defined(MIMRL_DTYPE) || MIMRL_DTYPE == 1

// ---------------------------------------------------------------------------
// The bf16 tensor-core instance: mma.sync.m16n8k16 bf16 -> float32.
// ---------------------------------------------------------------------------

template <int HD>
struct TcFwdSmem {
  static constexpr int kS = TcRow<HD>::kStride;
  // Q: warps * 16 rows; K and V: two buffers of kTcKeys rows each; bias: two
  // buffers of kTcKeys floats
  static size_t bytes(int warps) {
    return ((size_t)warps * 16 * kS + 4 * kTcKeys * kS) * sizeof(bf16) +
           2 * kTcKeys * sizeof(float);
  }
};

template <int HD, bool kDrop>
__global__ void __launch_bounds__(kTcMaxWarps * 32)
    flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const float* __restrict__ bias, bf16* __restrict__ out,
                        const long long* __restrict__ seed, int nh, int t_len,
                        float scale, uint32_t threshold, float inv_keep, int batch0) {
  using R = TcRow<HD>;
  constexpr int kS = R::kStride;
  constexpr int kNT = kTcKeys / 8;  // n8 tiles of one score tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x / 32, rows = warps * 16;
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + rows * kS;          // buffer j at sK + j * kTcKeys * kS
  bf16* sV = sK + 2 * kTcKeys * kS;
  float* sB = reinterpret_cast<float*>(sV + 2 * kTcKeys * kS);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * rows;
  const size_t head = ((size_t)b * nh + h) * (size_t)t_len * HD;
  const float* bias_row = bias + (size_t)b * t_len;
  const int row0 = q0 + warp * 16;
  const bool active = row0 < t_len;  // a warp past T does no products
  uint2 key = make_uint2(0u, 0u);
  if (kDrop) key = philox_key(seed);

  zero_pad_cols<HD>(sQ, rows);  // the copies below write other bytes
  zero_pad_cols<HD>(sK, 2 * kTcKeys);
  stage_rows<HD>(sQ, q + head, q0, rows, t_len);
  auto stage_kv = [&](int tile) {
    const int buf = tile & 1, k0 = tile * kTcKeys;
    stage_rows<HD>(sK + buf * kTcKeys * kS, k + head, k0, kTcKeys, t_len);
    stage_rows<HD>(sV + buf * kTcKeys * kS, v + head, k0, kTcKeys, t_len);
    for (int j = threadIdx.x; j < kTcKeys; j += blockDim.x)
      cp_async_4(sB + buf * kTcKeys + j, bias_row + (k0 + j < t_len ? k0 + j : 0),
                 k0 + j < t_len ? 4 : 0);
  };
  stage_kv(0);
  cp_async_commit();  // group 0: Q and the first K/V tile

  float o[R::kDTiles][4];
#pragma unroll
  for (int d = 0; d < R::kDTiles; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_part[2] = {0.f, 0.f};
  uint32_t qf[R::kKSteps][4];

  const int n_tiles = (t_len + kTcKeys - 1) / kTcKeys;
  for (int tile = 0; tile < n_tiles; ++tile) {
    // the next tile's loads overlap this tile's products; its buffer was
    // last read before the __syncthreads that ended the previous iteration
    if (tile + 1 < n_tiles) stage_kv(tile + 1);
    cp_async_commit();
    cp_async_wait<1>();  // everything but the newest group has landed
    __syncthreads();
    const int k0 = tile * kTcKeys, buf = tile & 1;
    const bf16* sKb = sK + buf * kTcKeys * kS;
    const bf16* sVb = sV + buf * kTcKeys * kS;
    const float* sBb = sB + buf * kTcKeys;
    const int keys_left = t_len - k0;  // >= 1: key k0 lies inside T
    if (active) {
      if (tile == 0) {
#pragma unroll
        for (int ks = 0; ks < R::kKSteps; ++ks)
          ldsm_x4(qf[ks], sQ + warp * 16 * kS + a_addr<kS>(lane, ks * 16));
      }
      // S = Q . K^T over the tile's 16-key groups that reach inside T
      float s[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int jp = 0; jp < kNT / 2; ++jp) {
        if (jp * 16 >= keys_left) break;
#pragma unroll
        for (int ks = 0; ks < R::kKSteps; ++ks) {
          uint32_t r[4];
          ldsm_x4(r, sKb + jp * 16 * kS + bn_addr<kS>(lane, ks * 16));
          mma_bf16(s[2 * jp], qf[ks], r[0], r[1]);
          mma_bf16(s[2 * jp + 1], qf[ks], r[2], r[3]);
        }
      }
      // s * scale + bias rounded twice, as the reference computes it; keys
      // past T get -inf
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kk = 8 * j + 2 * t4 + (e & 1);
          const float x = kk < keys_left
                              ? __fadd_rn(__fmul_rn(s[j][e], scale), sBb[kk])
                              : -INFINITY;
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m_run[r], quad_max(mx[r]));
        alpha[r] = softmax_exp(m_run[r] - m_new);  // 0 on the first tile
        m_run[r] = m_new;
        l_part[r] *= alpha[r];
      }
      // P = exp(s - m), summed over all keys, dropped or not; the kept,
      // unnormalised P feeds P . V
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = softmax_exp(s[j][e] - m_run[e >> 1]);
          l_part[e >> 1] += p;
          s[j][e] = p;
        }
        if (kDrop && j * 8 < keys_left) {
          bool keep[4];
          dropout_keep_frag(key, threshold, b + batch0, h, row0 + g, k0 + 8 * j, lane,
                            keep);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!keep[e]) s[j][e] = 0.f;
        }
      }
#pragma unroll
      for (int d = 0; d < R::kDTiles; ++d) {
        o[d][0] *= alpha[0];
        o[d][1] *= alpha[0];
        o[d][2] *= alpha[1];
        o[d][3] *= alpha[1];
      }
      // O += P . V: P from registers, rounded to bf16; V through
      // ldmatrix.trans, the keys as the contraction
#pragma unroll
      for (int kk = 0; kk < kNT / 2; ++kk) {
        if (kk * 16 >= keys_left) break;
        uint32_t a[4];
        c_to_a(a, s[2 * kk], s[2 * kk + 1]);
        const bf16* vrow = sVb + kk * 16 * kS;
#pragma unroll
        for (int dp = 0; dp < R::kDTiles / 2; ++dp) {
          uint32_t r[4];
          ldsm_x4_t(r, vrow + a_addr<kS>(lane, dp * 16));
          mma_bf16(o[2 * dp], a, r[0], r[1]);
          mma_bf16(o[2 * dp + 1], a, r[2], r[3]);
        }
        if (R::kDTiles % 2) {  // hd 8: one n8 tile
          uint32_t r[2];
          ldsm_x2_t(r, vrow + a_addr<kS>(lane, 0));
          mma_bf16(o[R::kDTiles - 1], a, r[0], r[1]);
        }
      }
    }
    __syncthreads();  // this tile's buffer is free for the tile after next
  }
  if (!active) return;
  const float l_row[2] = {quad_sum(l_part[0]), quad_sum(l_part[1])};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= t_len) continue;
    const float inv = (kDrop ? inv_keep : 1.f) / l_row[r];
    bf16* dst = out + head + (size_t)row * HD + 2 * t4;
#pragma unroll
    for (int d = 0; d < R::kDTiles; ++d)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * d) =
          __floats2bfloat162_rn(o[d][2 * r] * inv, o[d][2 * r + 1] * inv);
  }
}

#endif  // the bf16 tensor-core instance

#if !defined(MIMRL_DTYPE) || MIMRL_DTYPE == 0

// ---------------------------------------------------------------------------
// The float32 tensor-core instance: mma.sync.m16n8k8 tf32 in 3xTF32.
// ---------------------------------------------------------------------------

template <int HD>
struct F32FwdSmem {
  static constexpr int kS = F32Row<HD>::kStride;
  // Q: warps * 16 rows; K and V: two buffers of kTcKeys rows each; bias:
  // two buffers of kTcKeys floats
  static size_t bytes(int warps) {
    return ((size_t)warps * 16 * kS + 4 * kTcKeys * kS + 2 * kTcKeys) *
           sizeof(float);
  }
};

template <int HD, bool kDrop>
__global__ void __launch_bounds__(kTcMaxWarps * 32)
    flash_fwd_tf32x3_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ bias,
                            float* __restrict__ out,
                            const long long* __restrict__ seed, int nh,
                            int t_len, float scale, uint32_t threshold,
                            float inv_keep, int batch0) {
  constexpr int kS = F32Row<HD>::kStride;
  constexpr int kDT = F32Row<HD>::kDTiles;
  constexpr int kNT = kTcKeys / 8;  // n8 tiles of one score tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x / 32, rows = warps * 16;
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sK = sQ + rows * kS;  // buffer j at sK + j * kTcKeys * kS
  float* sV = sK + 2 * kTcKeys * kS;
  float* sB = sV + 2 * kTcKeys * kS;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * rows;
  const size_t head = ((size_t)b * nh + h) * (size_t)t_len * HD;
  const float* bias_row = bias + (size_t)b * t_len;
  const int row0 = q0 + warp * 16;
  const bool active = row0 < t_len;  // a warp past T does no products
  uint2 key = make_uint2(0u, 0u);
  if (kDrop) key = philox_key(seed);

  stage_rows_f32<HD>(sQ, q + head, q0, rows, t_len);
  auto stage_kv = [&](int tile) {
    const int buf = tile & 1, k0 = tile * kTcKeys;
    stage_rows_f32<HD>(sK + buf * kTcKeys * kS, k + head, k0, kTcKeys, t_len);
    stage_rows_f32<HD>(sV + buf * kTcKeys * kS, v + head, k0, kTcKeys, t_len);
    for (int j = threadIdx.x; j < kTcKeys; j += blockDim.x)
      cp_async_4(sB + buf * kTcKeys + j,
                 bias_row + (k0 + j < t_len ? k0 + j : 0),
                 k0 + j < t_len ? 4 : 0);
  };
  stage_kv(0);
  cp_async_commit();  // group 0: Q and the first K/V tile

  float o[kDT][4];
#pragma unroll
  for (int d = 0; d < kDT; ++d) zero4(o[d]);
  float m_run[2] = {-INFINITY, -INFINITY}, l_part[2] = {0.f, 0.f};
  // this lane's (row g, column t) of the warp's 16 query rows
  const float* sQw = sQ + (warp * 16 + g) * kS + t4;

  const int n_tiles = (t_len + kTcKeys - 1) / kTcKeys;
  for (int tile = 0; tile < n_tiles; ++tile) {
    // the next tile's loads overlap this tile's products; its buffer was
    // last read before the __syncthreads that ended the previous iteration
    if (tile + 1 < n_tiles) stage_kv(tile + 1);
    cp_async_commit();
    cp_async_wait<1>();  // everything but the newest group has landed
    __syncthreads();
    const int k0 = tile * kTcKeys, buf = tile & 1;
    const float* sKb = sK + buf * kTcKeys * kS;
    const float* sVb = sV + buf * kTcKeys * kS;
    const float* sBb = sB + buf * kTcKeys;
    const int keys_left = t_len - k0;  // >= 1: key k0 lies inside T
    if (active) {
      // S = Q . K^T over the tile's 16-key groups that reach inside T, hd
      // in chunks of 16 terms, each chunk summed on the tensor cores and
      // added in float32
      float s[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j) zero4(s[j]);
#pragma unroll
      for (int c = 0; c < HD; c += 16) {
        constexpr int kSteps = HD < 16 ? 1 : 2;
        Tf32A qa[kSteps];
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) load_a<kS>(qa[kk], sQw + c + 8 * kk);
#pragma unroll
        for (int jp = 0; jp < kNT / 2; ++jp) {
          if (jp * 16 >= keys_left) break;
          float part[2][4];
          zero4(part[0]);
          zero4(part[1]);
#pragma unroll
          for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              mma_b_rows(part[j], qa[kk],
                         sKb + (jp * 16 + 8 * j + g) * kS + c + 8 * kk + t4);
          add4(s[2 * jp], part[0]);
          add4(s[2 * jp + 1], part[1]);
        }
      }
      // s * scale + bias rounded twice, as the reference computes it; keys
      // past T get -inf
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kk = 8 * j + 2 * t4 + (e & 1);
          const float x = kk < keys_left
                              ? __fadd_rn(__fmul_rn(s[j][e], scale), sBb[kk])
                              : -INFINITY;
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m_run[r], quad_max(mx[r]));
        alpha[r] = softmax_exp(m_run[r] - m_new);  // 0 on the first tile
        m_run[r] = m_new;
        l_part[r] *= alpha[r];
      }
      // P = exp(s - m), summed over all keys, dropped or not; the kept,
      // unnormalised P feeds P . V
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = softmax_exp(s[j][e] - m_run[e >> 1]);
          l_part[e >> 1] += p;
          s[j][e] = p;
        }
        if (kDrop && j * 8 < keys_left) {
          bool keep[4];
          dropout_keep_frag(key, threshold, b + batch0, h, row0 + g, k0 + 8 * j, lane,
                            keep);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!keep[e]) s[j][e] = 0.f;
        }
      }
#pragma unroll
      for (int d = 0; d < kDT; ++d) {
        o[d][0] *= alpha[0];
        o[d][1] *= alpha[0];
        o[d][2] *= alpha[1];
        o[d][3] *= alpha[1];
      }
      // O += P . V in chunks of 16 keys: P from the S registers (the
      // permuted key order of c_to_a_perm), V rows 2t and 2t + 1 of each
      // 8-key step
#pragma unroll
      for (int kc = 0; kc < kNT / 2; ++kc) {
        if (kc * 16 >= keys_left) break;
        Tf32A pa[2];
        c_to_a_perm(pa[0], s[2 * kc]);
        c_to_a_perm(pa[1], s[2 * kc + 1]);
        const float* vrow = sVb + (kc * 16 + 2 * t4) * kS + g;
#pragma unroll
        for (int d = 0; d < kDT; ++d) {
          float part[4];
          zero4(part);
          mma_b_perm<kS>(part, pa[0], vrow + 8 * d);
          mma_b_perm<kS>(part, pa[1], vrow + 8 * kS + 8 * d);
          add4(o[d], part);
        }
      }
    }
    __syncthreads();  // this tile's buffer is free for the tile after next
  }
  if (!active) return;
  const float l_row[2] = {quad_sum(l_part[0]), quad_sum(l_part[1])};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= t_len) continue;
    const float inv = (kDrop ? inv_keep : 1.f) / l_row[r];
    float* dst = out + head + (size_t)row * HD + 2 * t4;
#pragma unroll
    for (int d = 0; d < kDT; ++d)
      *reinterpret_cast<float2*>(dst + 8 * d) =
          make_float2(o[d][2 * r] * inv, o[d][2 * r + 1] * inv);
  }
}
#endif  // the float32 tensor-core instance

#if !defined(MIMRL_DTYPE) || MIMRL_DTYPE <= 1
// Blocks per (head, batch row) and warps per block: ceil(T / 16) row groups
// of 16 split evenly over the fewest blocks of at most kTcMaxWarps warps, so
// that every block reads K and V once and no warp idles but in the last.
__host__ inline void tc_fwd_grid(int t_len, int* blocks, int* warps) {
  const int groups = (t_len + 15) / 16;
  *blocks = (groups + kTcMaxWarps - 1) / kTcMaxWarps;
  *warps = (groups + *blocks - 1) / *blocks;
}

// the tensor-core instance of the library's input type
template <int HD, bool kDrop>
int launch_tc(const void* q, const void* k, const void* v, const void* bias,
              void* out, const void* seed, int bs, int nh, int t_len,
              float scale, uint32_t threshold, float inv_keep, int batch0,
              cudaStream_t stream) {
  int blocks, warps;
  tc_fwd_grid(t_len, &blocks, &warps);
#if defined(MIMRL_DTYPE) && MIMRL_DTYPE == 0
  using T = float;
  auto kern = flash_fwd_tf32x3_kernel<HD, kDrop>;
  const size_t smem = F32FwdSmem<HD>::bytes(warps);
#else
  using T = bf16;
  auto kern = flash_fwd_tc_kernel<HD, kDrop>;
  const size_t smem = TcFwdSmem<HD>::bytes(warps);
#endif
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(blocks, nh, bs), warps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<T*>(out), static_cast<const long long*>(seed), nh, t_len,
      scale, threshold, inv_keep, batch0);
  return (int)cudaGetLastError();
}

template <bool kDrop>
int dispatch_tc(const void* q, const void* k, const void* v, const void* bias,
                void* out, const void* seed, int bs, int nh, int t_len, int hd,
                float scale, uint32_t threshold, float inv_keep, int batch0,
                cudaStream_t stream) {
#define MIMRL_FWD_TC_CASE(HD)                                                \
  case HD:                                                                   \
    return launch_tc<HD, kDrop>(q, k, v, bias, out, seed, bs, nh, t_len,     \
                                scale, threshold, inv_keep, batch0, stream)
  switch (hd) {
    MIMRL_FWD_TC_CASE(8);
    MIMRL_FWD_TC_CASE(16);
    MIMRL_FWD_TC_CASE(32);
    MIMRL_FWD_TC_CASE(64);
    MIMRL_FWD_TC_CASE(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef MIMRL_FWD_TC_CASE
}
#endif  // the tensor-core instances

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; compiled with -DMIMRL_DTYPE=0 or 1 the
// library holds that type's kernels only and refuses the other.
// dropout: 0 = off (seed may be null), 1 = on: seed points to one int64 on
// the device, threshold is uint32(p * 2^32), inv_keep is 1 / (1 - p) and
// batch0 is the global batch row of q's row 0 in the Philox counter (a
// data-parallel rank draws the mask of its rows of the whole batch).
// Returns a cudaError_t value (0 = ok).
extern "C" int mimrl_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, const void* bias,
                                         void* out, const void* seed, int bs,
                                         int nh, int t_len, int hd, int dtype,
                                         float scale, int dropout,
                                         unsigned int threshold,
                                         float inv_keep, int batch0, void* stream) {
  if (bs <= 0 || nh <= 0 || t_len <= 0 || nh > 65535 || bs > 65535)
    return (int)cudaErrorInvalidValue;
  if (dropout && seed == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#if !defined(MIMRL_DTYPE) || MIMRL_DTYPE == 0
  if (dtype == 0)
    return dispatch_drop<float>(q, k, v, bias, out, seed, bs, nh, t_len, hd,
                                scale, dropout, threshold, inv_keep, batch0, s);
#endif
#if !defined(MIMRL_DTYPE) || MIMRL_DTYPE == 1
  if (dtype == 1)
    return dispatch_drop<__nv_bfloat16>(q, k, v, bias, out, seed, bs, nh,
                                        t_len, hd, scale, dropout, threshold,
                                        inv_keep, batch0, s);
#endif
  return (int)cudaErrorInvalidValue;
}

#if defined(MIMRL_DTYPE) && MIMRL_DTYPE <= 1
// The tensor-core instance of the library's input type (bf16 or float32
// q, k, v, out); arguments as above without the dtype. Every 16-byte row
// chunk is read by cp.async, so q, k and v must be 16-byte aligned (the
// wrapper checks).
extern "C" int mimrl_flash_attention_fwd_tc(const void* q, const void* k,
                                            const void* v, const void* bias,
                                            void* out, const void* seed, int bs,
                                            int nh, int t_len, int hd,
                                            float scale, int dropout,
                                            unsigned int threshold,
                                            float inv_keep, int batch0, void* stream) {
  if (bs <= 0 || nh <= 0 || t_len <= 0 || nh > 65535 || bs > 65535)
    return (int)cudaErrorInvalidValue;
  if (dropout && seed == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dropout)
    return dispatch_tc<true>(q, k, v, bias, out, seed, bs, nh, t_len, hd,
                             scale, threshold, inv_keep, batch0, s);
  return dispatch_tc<false>(q, k, v, bias, out, seed, bs, nh, t_len, hd, scale,
                            threshold, inv_keep, batch0, s);
}
#endif
