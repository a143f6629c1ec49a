// Counter-based dropout mask shared by the attention forward and backward.
//
// The TPU kernels draw their keep mask from a stream that is a pure
// function of the seed and the position, so the backward regenerates it
// instead of storing it (mimrl_tpu/ops/pallas/flash_attention.py:16-20).
// Here the stream is Philox4x32-10 (Salmon et al., "Parallel random
// numbers: as easy as 1, 2, 3", SC'11):
//
//   key     = (low word of the seed, high word of the seed)
//   counter = (key index / 4, query row, head, batch row)
//   (the batch row of the whole batch: a kernel's row b is row b + batch0,
//   batch0 > 0 on a data-parallel rank)
//   bits(b, h, q, k) = word (k mod 4) of philox4x32_10(counter, key)
//   keep = bits > threshold,   threshold = uint32(p * 2^32)
//
// the threshold rule of flash_attention.py:156-159. Both kernels include
// this header, so they cannot drift; mimrl_tpu_torch/ops/philox.py is the
// same generator in integer tensor ops, for the plain versions.

#pragma once

#include <stdint.h>

namespace mimrl {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 key) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    if (round > 0) {
      key.x += kPhiloxW0;
      key.y += kPhiloxW1;
    }
    // one wide multiply gives both words of a product
    const uint64_t p0 = static_cast<uint64_t>(kPhiloxM0) * c.x;
    const uint64_t p1 = static_cast<uint64_t>(kPhiloxM1) * c.z;
    const uint32_t hi0 = static_cast<uint32_t>(p0 >> 32), lo0 = static_cast<uint32_t>(p0);
    const uint32_t hi1 = static_cast<uint32_t>(p1 >> 32), lo1 = static_cast<uint32_t>(p1);
    c = make_uint4(hi1 ^ c.y ^ key.x, lo1, hi0 ^ c.w ^ key.y, lo0);
  }
  return c;
}

// the seed is one int64 on the device; the kernels read it themselves so
// that drawing it never synchronises the host
__device__ __forceinline__ uint2 philox_key(const long long* seed) {
  const unsigned long long s = static_cast<unsigned long long>(seed[0]);
  return make_uint2(static_cast<uint32_t>(s), static_cast<uint32_t>(s >> 32));
}

__device__ __forceinline__ bool dropout_keep(uint2 key, uint32_t threshold,
                                             int b, int h, int q, int k) {
  const uint4 r = philox4x32_10(
      make_uint4(static_cast<uint32_t>(k) >> 2, static_cast<uint32_t>(q),
                 static_cast<uint32_t>(h), static_cast<uint32_t>(b)),
      key);
  const int w = k & 3;
  const uint32_t bits = w == 0 ? r.x : (w == 1 ? r.y : (w == 2 ? r.z : r.w));
  return bits > threshold;
}

// The keep flags of one mma C fragment whose rows are queries and whose
// columns are the keys [k8, k8 + 8): lane (g, t) holds (row_g, k8 + 2t),
// (row_g, k8 + 2t + 1), (row_g + 8, k8 + 2t), (row_g + 8, k8 + 2t + 1) in
// C's order. Keys k8 + 2t and k8 + 2t + 1 are words 2 (t % 2), +1 of the
// Philox block (k8 / 4 + t / 2). Lanes 2j and 2j + 1 of a quad need the
// same block for rows row_g and row_g + 8, so each computes one of the two
// and the pair trades the two words the other needs: one Philox call per
// lane per fragment, one per four (query, key) pairs, and the same bits as
// dropout_keep.
__device__ __forceinline__ void dropout_keep_frag(uint2 key, uint32_t threshold,
                                                  int b, int h, int row_g,
                                                  int k8, int lane,
                                                  bool (&keep)[4]) {
  const int t = lane & 3;
  const bool odd = t & 1;
  const uint4 r = philox4x32_10(
      make_uint4(static_cast<uint32_t>(k8 / 4 + (t >> 1)),
                 static_cast<uint32_t>(row_g + (odd ? 8 : 0)),
                 static_cast<uint32_t>(h), static_cast<uint32_t>(b)),
      key);
  // the even lane keeps words 0, 1 of row g and sends 2, 3; the odd lane
  // keeps words 2, 3 of row g + 8 and sends 0, 1
  const uint32_t got_x = __shfl_xor_sync(0xffffffffu, odd ? r.x : r.z, 1);
  const uint32_t got_y = __shfl_xor_sync(0xffffffffu, odd ? r.y : r.w, 1);
  keep[0] = (odd ? got_x : r.x) > threshold;
  keep[1] = (odd ? got_y : r.y) > threshold;
  keep[2] = (odd ? r.z : got_x) > threshold;
  keep[3] = (odd ? r.w : got_y) > threshold;
}

}  // namespace mimrl
