// K3: one decoder layer's cross-attention K/V projection and symmetric int8
// quantization, fused:
//   k = bf16(xa @ Wk^T),  v = bf16(bf16(xa @ Wv^T) + bv)
//   per (position, head): scale = amax / 127 + 1e-12, q = clip(rint(y / scale))
//
// Replaces whisper_at_tpu/ops/kv_quant.py::project_quantize_kv (Pallas,
// TPU). The TPU kernel works in a transposed [B, D, Ta_pad] layout that
// Mosaic forced on it (kv_quant.py:30-38). Here the layout is chosen with
// K4's input: K and V are row-major int8 [B, Ta_pad, H*64] (the 64 codes of
// one (position, head) are contiguous) and the scales fp32 [B, H, Ta_pad].
// Rows t >= Ta get zero codes and zero scales.
// The int4 entry (kv_quant4_bf16, bits = 4 of the TPU kernel, qmax 7 at
// kv_quant.py:123) runs the same GEMM; its epilogue quantizes to [-7, 7] and
// writes packed bytes [B, Ta_pad, D/2] in the pack4 layout of
// models/layers.py (adjacent pairs along D, low nibble first): one thread
// holds a (position, head)'s 64 codes, so it packs its own pairs.
// What bounds it on the H100: 2 * 2*B*Ta*D*D = 2.4e11 FLOP per layer at
// large-v1 batch 24 (0.24 ms at 989 TFLOP/s) against ~0.23 GB of bytes
// (0.07 ms), so it is compute-bound. The design keeps the bf16 projection
// out of HBM: the GEMM tile (gemm.cuh) is rounded to bf16 into shared
// memory, and the same block quantizes it there and writes only int8 codes
// and scales. One launch covers K and V (grid.x spans 2*D columns).
#include "gemm.cuh"

namespace {

constexpr int LDY = gemm::BN + 8;  // padded bf16 row of the staged tile

template <int BITS>
__global__ void __launch_bounds__(gemm::THREADS)
    kv_quant_kernel(const bf16* __restrict__ xa, const bf16* __restrict__ wk,
                    const bf16* __restrict__ wv, const bf16* __restrict__ bv,
                    int8_t* __restrict__ kq, float* __restrict__ ks,
                    int8_t* __restrict__ vq, float* __restrict__ vs, int Ta,
                    int Ta_pad, int D) {
  __shared__ __align__(16) bf16 smem[gemm::SMEM_BF16];
  const int n_blk = D / gemm::BN;
  const bool is_v = blockIdx.x >= n_blk;
  const int n0 = (blockIdx.x - (is_v ? n_blk : 0)) * gemm::BN;
  const int m0 = blockIdx.y * gemm::BM;  // over B * Ta_pad rows
  gemm::Frag f;
  gemm::mainloop(
      f,
      [&](int r) -> const bf16* {
        const int gr = m0 + r;
        const int b = gr / Ta_pad, t = gr - b * Ta_pad;
        return t < Ta ? xa + ((size_t)b * Ta + t) * D : nullptr;
      },
      is_v ? wv : wk, D, n0, smem);

  // stage the bf16-rounded projection tile (+ bias for V) in shared memory
  // (the main loop ended on a barrier, so the ring is free)
  bf16* ys = smem;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int wr = gemm::warp_row0(), wc = gemm::warp_col0();
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int c = wc + ni * 8 + tg * 2;
      float b0 = 0.f, b1 = 0.f;
      if (is_v) {
        b0 = __bfloat162float(bv[n0 + c]);
        b1 = __bfloat162float(bv[n0 + c + 1]);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wr + mi * 16 + g + half * 8;
        float y0 = __bfloat162float(__float2bfloat16_rn(f.acc[mi][ni][2 * half]));
        float y1 = __bfloat162float(__float2bfloat16_rn(f.acc[mi][ni][2 * half + 1]));
        if (is_v) {
          y0 = __fadd_rn(y0, b0);
          y1 = __fadd_rn(y1, b1);
        }
        *reinterpret_cast<__nv_bfloat162*>(ys + r * LDY + c) = __floats2bfloat162_rn(y0, y1);
      }
    }
  }
  __syncthreads();

  // quantize: thread -> (tile row, one of the tile's two heads)
  const int r = threadIdx.x >> 1, hh = threadIdx.x & 1;
  const int gr = m0 + r;
  const int b = gr / Ta_pad, t = gr - b * Ta_pad;
  const bool valid = t < Ta;
  const uint4* yr = reinterpret_cast<const uint4*>(ys + r * LDY + hh * 64);
  float vals[64];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint4 w = yr[i];
    const bf16* e = reinterpret_cast<const bf16*>(&w);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      vals[i * 8 + j] = __bfloat162float(e[j]);
      amax = fmaxf(amax, fabsf(vals[i * 8 + j]));
    }
  }
  constexpr float QMAX = BITS == 8 ? 127.f : 7.f;
  const float scale = __fadd_rn(__fdiv_rn(amax, QMAX), 1e-12f);
  auto code = [&](int i) -> int {
    const float q = fminf(fmaxf(rintf(__fdiv_rn(vals[i], scale)), -QMAX), QMAX);
    return valid ? static_cast<int>(q) : 0;
  };
  if constexpr (BITS == 8) {
    int8_t* dst = (is_v ? vq : kq) + ((size_t)b * Ta_pad + t) * D + n0 + hh * 64;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint4 w;
      int8_t* e = reinterpret_cast<int8_t*>(&w);
#pragma unroll
      for (int j = 0; j < 16; ++j) e[j] = static_cast<int8_t>(code(i * 16 + j));
      reinterpret_cast<uint4*>(dst)[i] = w;
    }
  } else {  // 64 codes -> 32 bytes, low nibble = even element
    int8_t* dst = (is_v ? vq : kq) + ((size_t)b * Ta_pad + t) * (D / 2) + (n0 + hh * 64) / 2;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint4 w;
      uint8_t* e = reinterpret_cast<uint8_t*>(&w);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int lo = code(i * 32 + 2 * j), hi = code(i * 32 + 2 * j + 1);
        e[j] = static_cast<uint8_t>((lo & 0xF) | ((hi & 0xF) << 4));
      }
      reinterpret_cast<uint4*>(dst)[i] = w;
    }
  }
  const int H = D / 64;
  const int head = n0 / 64 + hh;
  (is_v ? vs : ks)[((size_t)b * H + head) * Ta_pad + t] = valid ? scale : 0.f;
}

template <int BITS>
int launch(const void* xa, const void* wk, const void* wv, const void* bv, void* kq,
           void* ks, void* vq, void* vs, int B, int Ta, int Ta_pad, int D, void* stream) {
  dim3 grid(2 * D / gemm::BN, B * Ta_pad / gemm::BM);
  kv_quant_kernel<BITS><<<grid, gemm::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(xa), static_cast<const bf16*>(wk),
      static_cast<const bf16*>(wv), static_cast<const bf16*>(bv),
      static_cast<int8_t*>(kq), static_cast<float*>(ks),
      static_cast<int8_t*>(vq), static_cast<float*>(vs), Ta, Ta_pad, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xa [B, Ta, D] bf16; wk, wv [D, D] bf16 (torch [out, in]); bv [D] bf16.
// kq, vq [B, Ta_pad, D] int8; ks, vs [B, D/64, Ta_pad] fp32.
// Requires D % 128 == 0 and Ta_pad % 128 == 0.
extern "C" int kv_quant_bf16(const void* xa, const void* wk, const void* wv,
                             const void* bv, void* kq, void* ks, void* vq,
                             void* vs, int B, int Ta, int Ta_pad, int D,
                             void* stream) {
  return launch<8>(xa, wk, wv, bv, kq, ks, vq, vs, B, Ta, Ta_pad, D, stream);
}

// The int4 entry: the same arguments, kq and vq packed int8 [B, Ta_pad, D/2].
extern "C" int kv_quant4_bf16(const void* xa, const void* wk, const void* wv,
                              const void* bv, void* kq, void* ks, void* vq,
                              void* vs, int B, int Ta, int Ta_pad, int D,
                              void* stream) {
  return launch<4>(xa, wk, wv, bv, kq, ks, vq, vs, B, Ta, Ta_pad, D, stream);
}
