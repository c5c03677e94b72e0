// K3: one decoder layer's cross-attention K/V projection and symmetric int8
// (or int4) quantization, fused:
//   k = bf16(xa @ Wk^T),  v = bf16(bf16(xa @ Wv^T) + bv)
//   per (position, head): scale = amax / qmax + 1e-12, q = clip(rint(y / scale))
//
// Replaces whisper_at_tpu/ops/kv_quant.py::project_quantize_kv (Pallas,
// TPU). The TPU kernel works in a transposed [B, D, Ta_pad] layout that
// Mosaic forced on it (kv_quant.py:30-38). Here the layout is chosen with
// K4's input: K and V are row-major int8 [B, Ta_pad, H*64] (the 64 codes of
// one (position, head) are contiguous) and the scales fp32 [B, H, Ta_pad].
// Rows t >= Ta get zero codes and zero scales.
// A tensor-parallel rank projects its own heads: Wk and Wv [N, D] with
// N = D / tp (a multiple of 64), codes [B, Ta_pad, N] and scales
// [B, N/64, Ta_pad]; at N = D this is the whole layer. N need not divide
// by the block width (320 at tp 4 of large-v1): each of K and V takes
// ceil(N / bn) tiles, the last one's excess columns load zero weights and
// are not stored.
// The int4 entry (kv_quant4_bf16, bits = 4 of the TPU kernel, qmax 7 at
// kv_quant.py:123) runs the same GEMM; its epilogue quantizes to [-7, 7] and
// writes packed bytes [B, Ta_pad, D/2] in the pack4 layout of
// models/layers.py (adjacent pairs along D, low nibble first).
// What bounds it on the H100: 2 * 2*B*Ta*D*D = 2.4e11 FLOP per layer at
// large-v1 batch 24 (0.24 ms at 989 TFLOP/s) against ~0.2 GB of bytes
// (0.06 ms), so it is compute-bound.
// The design: the products run on gemm_sm90.cuh (persistent blocks, a TMA
// ring, wgmma in two consumer warpgroups) with N = 2D, Wk's rows then Wv's,
// each from its own tensor map, so one launch covers K and V and the
// weights are not copied. xa is read through a 3-D map {D, Ta, B}: a tile's
// 128 rows never cross an audio row, positions past Ta load as zeros, and
// the tiles cover exactly B x Ta_pad / 128 panels, the padded layout of the
// codes, so the pad rows are written by the same stores. The sums start at
// zero: the bias is added after the bf16 rounding, as the reference adds
// it. The epilogue (KvQuantize) keeps the bf16 projection out of HBM and
// out of shared memory: a 64-column chunk of a warpgroup's sums is one
// head, and in the wgmma accumulator layout one row's 64 values of a chunk
// lie in the four threads of a quad, 16 each, so a (position, head)'s amax
// is a local max and two shuffles. The codes go through the warpgroup's
// staging buffer into a TMA store (int8 map {D*bits/8, Ta_pad, B}); each
// (position, head)'s scale is written by its quad's first thread.
// The codes are those of the IEEE division by the scale (__fdiv_rn): a
// multiply by the reciprocal alone flips codes on exact ties, so the
// multiply decides only where it cannot differ (KvQuantize::store).
#include "gemm_sm90.cuh"

namespace {

using gemm_sm90::EPI_BUFS;
using gemm_sm90::EPI_COLS;
using gemm_sm90::EPI_TILE;
using gemm_sm90::WG_ROWS;

__device__ __forceinline__ void st_shared_u16(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void st_shared_u8(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u8 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// The quantizing epilogue of gemm_sm90.cuh: columns [0, N) of the product
// are K, [N, 2N) are V (+ bv); each 64-column chunk is one head.
template <int BITS>
struct KvQuantize {
  static constexpr int ROW = EPI_COLS * BITS / 8;  // bytes of a staged row of codes: 64 or 32
  // the codes [B, Ta_pad, N * BITS / 8] of K and of V, box {ROW, 64, 1},
  // swizzled over ROW bytes
  CUtensorMap kmap, vmap;
  const bf16* bv;
  float* ks;  // scales [B, H, Ta_pad]
  float* vs;
  int Ta, Ta_pad, N;

  __device__ __forceinline__ float2 init(int, int) const { return make_float2(0.f, 0.f); }

  // the byte (row, col) of a staged box in the maps' swizzle (16-byte
  // chunk index XOR bits 7.. of the offset, over ROW / 16 chunks)
  __device__ __forceinline__ static uint32_t swizzle(int row, int col) {
    const uint32_t o = row * ROW + col;
    return o ^ (((o >> 7) & (ROW / 16 - 1)) << 4);
  }

  template <int NA>
  __device__ __forceinline__ void store(float (&acc)[NA], uint32_t bufs, int wg, int z,
                                        int row_g, int n0) const {
    constexpr float QMAX = BITS == 8 ? 127.f : 7.f;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, quad = lane & 3;
    const bool is_v = n0 >= N;
    const int col0 = is_v ? n0 - N : n0;
    const int r = warp * 16 + (lane >> 2);  // this thread's rows r and r + 8 of the 64
    const bool valid[2] = {row_g + r < Ta, row_g + r + 8 < Ta};
    float* scales = (is_v ? vs : ks) + ((size_t)z * (N / 64) + col0 / 64) * Ta_pad + row_g + r;
#pragma unroll
    for (int c = 0; c < 2 * NA / EPI_COLS; ++c) {
      // a part's last tile past its N columns (the same for the whole
      // warpgroup): nothing to store
      if (col0 + c * EPI_COLS >= N) continue;
      // the chunk's sums rounded to bf16 as the reference rounds them (V:
      // + bv, rounded again), in place, two at a time, and each row's amax
      // over the quad
      float amax[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < EPI_COLS / 8; ++j) {
        const int jj = c * (EPI_COLS / 8) + j;
        float2 b = make_float2(0.f, 0.f);
        if (is_v)
          b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              bv + col0 + c * EPI_COLS + 8 * j + 2 * quad));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float2 y = __bfloat1622float2(
              __floats2bfloat162_rn(acc[4 * jj + 2 * i], acc[4 * jj + 2 * i + 1]));
          if (is_v)
            y = __bfloat1622float2(__floats2bfloat162_rn(__fadd_rn(y.x, b.x), __fadd_rn(y.y, b.y)));
          acc[4 * jj + 2 * i] = y.x;
          acc[4 * jj + 2 * i + 1] = y.y;
          amax[i] = fmaxf(amax[i], fmaxf(fabsf(y.x), fabsf(y.y)));
        }
      }
      float scale[2], inv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        amax[i] = fmaxf(amax[i], __shfl_xor_sync(0xffffffffu, amax[i], 1));
        amax[i] = fmaxf(amax[i], __shfl_xor_sync(0xffffffffu, amax[i], 2));
        scale[i] = __fadd_rn(__fdiv_rn(amax[i], QMAX), 1e-12f);
        inv[i] = __frcp_rn(scale[i]);
      }
      // rint(y / scale) with the quotient rounded as IEEE division rounds
      // it: t = y * (1 / scale) lies within 1.5 * 2^-23 |y / scale| <= 2^-15
      // of that quotient (|y / scale| <= 127), so where t is over 2^-14
      // from a half-integer both round to the same integer; nearer, the
      // division itself decides (a fraction ~1e-4 of the values)
      auto code = [&](float y, int i) -> uint32_t {
        const float t = __fmul_rn(y, inv[i]);
        float q = rintf(t);
        if (fabsf(fabsf(t - q) - 0.5f) <= 0x1p-14f) q = rintf(__fdiv_rn(y, scale[i]));
        q = fminf(fmaxf(q, -QMAX), QMAX);
        return valid[i] ? static_cast<uint32_t>(static_cast<int>(q)) : 0u;
      };
      // a tile has an even number of chunks, so chunk c of every tile
      // takes buffer c % 2; the store that last read it is done with it
      const uint32_t buf = bufs + (c % EPI_BUFS) * EPI_TILE;
      if (tid == 0) bulk_wait_read<EPI_BUFS - 1>();
      named_sync(1 + wg, 128);
#pragma unroll
      for (int j = 0; j < EPI_COLS / 8; ++j) {
        const int jj = c * (EPI_COLS / 8) + j;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint32_t q0 = code(acc[4 * jj + 2 * i], i), q1 = code(acc[4 * jj + 2 * i + 1], i);
          if constexpr (BITS == 8)  // columns 8j + 2 quad, + 1
            st_shared_u16(buf + swizzle(r + 8 * i, 8 * j + 2 * quad), (q0 & 0xFF) | (q1 & 0xFF) << 8);
          else  // the pair's byte, low nibble first
            st_shared_u8(buf + swizzle(r + 8 * i, 4 * j + quad), (q0 & 0xF) | (q1 & 0xF) << 4);
        }
      }
      fence_async_shared();
      named_sync(1 + wg, 128);
      if (tid == 0)
        tma_store_async(is_v ? &vmap : &kmap, buf, (col0 + c * EPI_COLS) * BITS / 8, row_g, z);
      if (quad == 0) {
        scales[c * Ta_pad] = valid[0] ? scale[0] : 0.f;
        scales[c * Ta_pad + 8] = valid[1] ? scale[1] : 0.f;
      }
    }
  }
};

template <int BITS>
int launch(const void* xa, const void* wk, const void* wv, const void* bv, void* kq, void* ks,
           void* vq, void* vs, int B, int Ta, int Ta_pad, int D, int N, int bn, int blocks,
           void* stream) {
  if (D % 128 || N % 64 || N < 64 || N > D || Ta_pad % gemm_sm90::BM || Ta < 1 ||
      Ta > Ta_pad || B < 1 || blocks < 1 || (bn != 128 && bn != 256))
    return static_cast<int>(cudaErrorInvalidValue);
  EncodeTiled fn;
  const cudaError_t e = encode_function(&fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  KvQuantize<BITS> epi;
  epi.bv = static_cast<const bf16*>(bv);
  epi.ks = static_cast<float*>(ks);
  epi.vs = static_cast<float*>(vs);
  epi.Ta = Ta;
  epi.Ta_pad = Ta_pad;
  epi.N = N;
  constexpr int ROW = KvQuantize<BITS>::ROW;
  constexpr CUtensorMapSwizzle codes_swizzle =
      BITS == 8 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap am, bk, bvm;
  int rc = encode_3d(fn, &am, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, xa, D, Ta, B, gemm_sm90::BK,
                     gemm_sm90::BM, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
  if (rc == 0) rc = gemm_sm90::encode_matrix(fn, &bk, wk, N, D, bn, gemm_sm90::BK);
  if (rc == 0) rc = gemm_sm90::encode_matrix(fn, &bvm, wv, N, D, bn, gemm_sm90::BK);
  if (rc == 0)
    rc = encode_3d(fn, &epi.kmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, kq, N * BITS / 8, Ta_pad, B,
                   ROW, WG_ROWS, codes_swizzle, CU_TENSOR_MAP_L2_PROMOTION_NONE);
  if (rc == 0)
    rc = encode_3d(fn, &epi.vmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, vq, N * BITS / 8, Ta_pad, B,
                   ROW, WG_ROWS, codes_swizzle, CU_TENSOR_MAP_L2_PROMOTION_NONE);
  if (rc != 0) return rc;
  const gemm_sm90::Tiles tl = gemm_sm90::tiles(B, Ta_pad, 2 * N, N, D, bn);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 256) return gemm_sm90::launch<256>(am, bk, bvm, epi, tl, blocks, s);
  if (bn == 128) return gemm_sm90::launch<128>(am, bk, bvm, epi, tl, blocks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// xa [B, Ta, D] bf16; wk, wv [N, D] bf16 (torch [out, in]); bv [N] bf16.
// kq, vq [B, Ta_pad, N] int8; ks, vs [B, N/64, Ta_pad] fp32; all contiguous
// and 16-byte aligned. Requires D % 128 == 0, N % 64 == 0, N <= D and
// Ta_pad % 128 == 0; bn (256 or 128) and blocks are ops/kv_quant.py's plan.
extern "C" int kv_quant_bf16(const void* xa, const void* wk, const void* wv,
                             const void* bv, void* kq, void* ks, void* vq,
                             void* vs, int B, int Ta, int Ta_pad, int D, int N, int bn,
                             int blocks, void* stream) {
  return launch<8>(xa, wk, wv, bv, kq, ks, vq, vs, B, Ta, Ta_pad, D, N, bn, blocks, stream);
}

// The int4 entry: the same arguments, kq and vq packed int8 [B, Ta_pad, N/2].
extern "C" int kv_quant4_bf16(const void* xa, const void* wk, const void* wv,
                              const void* bv, void* kq, void* ks, void* vq,
                              void* vs, int B, int Ta, int Ta_pad, int D, int N, int bn,
                              int blocks, void* stream) {
  return launch<4>(xa, wk, wv, bv, kq, ks, vq, vs, B, Ta, Ta_pad, D, N, bn, blocks, stream);
}
