// int8 and packed int4 codes widened exactly in registers, for the kernels
// that read K3's quantized cross K/V (K4, K10) and K8's int8 weights: to
// fp32 for products on the CUDA cores, to pairs of bf16 for mma.sync
// operands.
//
// fp32: a byte permute puts the code, biased to 0..255 (int8: c ^ 0x80;
// int4: its nibble ^ 8), into the low bits of 2^23, and one subtraction
// takes the bias and 2^23 off again (exact). bf16 holds 7 bits of mantissa:
// an int4 code is (2^7 + nibble ^ 8) - 136 in one subtraction of bf16
// pairs; an int8 code c is (2^7 + (c & 127)) - (2^7 | (c & 128)), both
// terms exact in bf16, built by one logic op each.
//
// Everything here has internal linkage, as in hopper.cuh.
#pragma once

#include "common.cuh"

namespace {

// byte `sel` of w, a code biased to 0..255 -> the float with bits
// 0x4B0000 | byte, 2^23 + byte
__device__ __forceinline__ float biased(uint32_t w, uint32_t sel) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, sel));
}

// 4 int8 codes of a word -> floats (exact)
__device__ __forceinline__ void widen8(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = biased(u, 0x7650) - 8388736.f;
  f[1] = biased(u, 0x7651) - 8388736.f;
  f[2] = biased(u, 0x7652) - 8388736.f;
  f[3] = biased(u, 0x7653) - 8388736.f;
}

// 8 int4 codes of a word in pack4 order (byte j: code 2j low, 2j+1 high)
__device__ __forceinline__ void widen4(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x88888888u;
  const uint32_t lo = u & 0x0F0F0F0Fu, hi = (u >> 4) & 0x0F0F0F0Fu;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[2 * j] = biased(lo, 0x7650 + j) - 8388616.f;
    f[2 * j + 1] = biased(hi, 0x7650 + j) - 8388616.f;
  }
}

__device__ __forceinline__ uint32_t sub_bf16x2(uint32_t x, uint32_t y) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(x), "r"(y));
  return d;
}

// the int8 codes in bytes 0 and 2 of w -> one bf16 pair (byte 0 low)
__device__ __forceinline__ uint32_t pair8(uint32_t w) {
  return sub_bf16x2((w & 0x007F007Fu) | 0x43004300u, (w & 0x00800080u) | 0x43004300u);
}

// the four int8 codes of w (byte j: code j) -> two bf16 pairs in k order,
// lo = {code 0, code 1} and hi = {code 2, code 3}: one byte permute puts
// codes 0 and 1 in bytes 0 and 2 (codes 2 and 3 in bytes 1 and 3) for pair8
__device__ __forceinline__ void pairs8(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = __byte_perm(w, 0u, 0x3120);
  lo = pair8(u);
  hi = pair8(u >> 8);
}

// the int4 codes in bits 0-3 and 16-19 of w -> one bf16 pair (bits 0-3 low)
__device__ __forceinline__ uint32_t pair4(uint32_t w) {
  return sub_bf16x2((w & 0x000F000Fu) ^ 0x43084308u, 0x43084308u);
}

}  // namespace
