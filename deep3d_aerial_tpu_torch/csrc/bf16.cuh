// bfloat16 helpers shared by the port's kernels (sweep.cu, red_step2.cu,
// red_step4.cu): bfloat16 tensors as their raw bits (unsigned short), their
// conversions to float32 and back (round to nearest, ties to even, as
// PyTorch's and XLA's casts), packed pairs, and the mma.sync m16n8k16
// bf16 product with float32 sums. cuda_build.library_path hashes this
// header with every source that includes it.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16_t = unsigned short;  // the bits of a bfloat16

__device__ __forceinline__ float bf2f(bf16_t b) { return __uint_as_float((uint32_t)b << 16); }

__device__ __forceinline__ bf16_t f2bf(float x) {
  bf16_t r;
  asm("cvt.rn.bf16.f32 %0, %1;\n" : "=h"(r) : "f"(x));
  return r;
}

// x rounded to bfloat16, as float32
__device__ __forceinline__ float bf16_round(float x) { return bf2f(f2bf(x)); }

// the low and high bfloat16 of a packed pair, as float32
__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// (lo, hi) rounded to bfloat16 and packed, lo in the low half (the lower
// K index of an MMA operand register)
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// a packed pair plus another, summed in float32 and rounded once
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  return pack_bf16x2(bf_lo(a) + bf_lo(b), bf_hi(a) + bf_hi(b));
}

// D += A B on the tensor cores: A 16x16 and B 16x8 in bfloat16, D float32.
// A: a[0] (row g, k 2t, 2t+1), a[1] (row g+8, k 2t, 2t+1), a[2] (row g,
// k 2t+8, 2t+9), a[3] (row g+8, k 2t+8, 2t+9); B: b0 (k 2t, 2t+1, column
// g), b1 (k 2t+8, 2t+9, column g); D as mma_tf32's (g = lane / 4, t =
// lane % 4).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An element of either storage type as float32, and a float32 stored as
// either (bfloat16 rounded).
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16_t x) { return bf2f(x); }
template <class T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16_t from_f32<bf16_t>(float x) { return f2bf(x); }

}  // namespace
