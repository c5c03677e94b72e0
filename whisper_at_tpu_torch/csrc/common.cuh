// Shared device helpers for the hand-written Hopper kernels of this package.
//
// Every kernel here is compiled for sm_90a by nvcc into its own shared
// library with a plain C interface (see ops/cuda.py). The tensor-core
// products here use the warp-level mma.sync m16n8k16 bf16 instruction with
// fp32 accumulation (the wgmma products are in hopper.cuh, attn_sm90.cuh
// and gemm_sm90.cuh); fragments are loaded from shared memory with plain 32-bit
// loads, in the register layout the PTX ISA defines for that shape:
//   A (16x16, row-major): reg0 = (row g,   cols 2t, 2t+1)
//                         reg1 = (row g+8, cols 2t, 2t+1)
//                         reg2 = (row g,   cols 2t+8, 2t+9)
//                         reg3 = (row g+8, cols 2t+8, 2t+9)
//   B (16x8, k-major):    reg0 = (k 2t, 2t+1, col g), reg1 = (k 2t+8, 2t+9, col g)
//   C (16x8, fp32):       c0, c1 = (row g, cols 2t, 2t+1); c2, c3 = row g+8
// with g = lane / 4 and t = lane % 4.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// (lo, hi) -> one register holding two bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16-byte async copy global -> shared; pred == false zero-fills the target
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the signed low nibble of a packed int4 byte (sign-extended to int); the
// high nibble of a sign-extended byte is byte >> 4
__device__ __forceinline__ int low_nibble(int byte) {
  return static_cast<int>(static_cast<unsigned>(byte) << 28) >> 28;
}
