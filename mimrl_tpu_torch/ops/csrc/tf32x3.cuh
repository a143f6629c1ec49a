// 3xTF32 on the tensor cores: a float32 product from three TF32 products.
//
// Float32 means float32 in this port (plain TF32 is switched off,
// device.py), and one TF32 pass keeps 10 mantissa bits (about 1e-3 off). So
// each operand is split as hi = tf32(v), lo = tf32(v - hi), both rounded to
// nearest, and a product is taken as lo*hi + hi*lo + hi*hi: about 2^-22 of
// each product is lost (the lo*lo term and lo's rounding). Callers sum the
// tensor cores' partial sums in chunks of 16 contraction terms and add the
// chunks in float32 on the FP32 pipes: one tensor-core accumulator over a
// whole contraction drifts further (cubemlp_axis_mlp.cu's header).
//
// Shared by the axis MLP (cubemlp_axis_mlp.cu) and the float32 attention
// instances (flash_attention_{fwd,bwd}.cu).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mimrl {

// hi = tf32(v) and lo = tf32(v - hi), each rounded to the nearest tf32
// (ties away from zero: half a tf32 ulp added to the bit pattern, the low
// 13 mantissa bits cleared; as cvt.rna.tf32.f32, in two integer operations
// instead of its longer sequence). v - hi is exact, so hi + lo keeps 22 of
// v's 24 bits. Finite |v| below 2^128 (1 - 2^-11), as every input here.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(v - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

// d += a . b, mma.sync.m16n8k8 tf32 -> float32. Fragments, g = lane / 4,
// t = lane % 4: a0 (row g, col t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8,
// t + 4); b0 (k t, col g), b1 (k t + 4, col g); d0, d1 (row g, cols 2t,
// 2t + 1), d2, d3 (row g + 8, the same cols).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace mimrl
