// K7: non-causal encoder self-attention over [B, T, H*64] bf16 (T = 1500),
// the generic flash kernel's formulation: keys past T masked, the
// 64^-0.5 scale applied to the fp32 scores, P rounded to bf16 for P V,
// the output normalized in fp32, query rows past T not stored.
//
// Replaces whisper_at_tpu/ops/flash.py::encoder_flash_attention, which
// calls JAX's library flash-attention kernel for the TPU
// (WHISPER_AT_TPU_ENC_ATTN=flash) over T padded to a multiple of 512 with
// segment ids masking the padding. It computes K1's function; it is its own
// entry beside K1 (csrc/enc_attention.cu), with what the generic flash
// kernel has and K1 lacks: the K/V tiles stream through an NST = 3 stage
// cp.async ring, so the next tiles load while this one is computed, and a
// block serves 128 query rows (8 warps of 16), halving the K/V tile loads
// per query row against K1's 64. Keys at T .. T_pad contribute exp(-inf) = 0,
// so the kernel visits only the tiles that hold keys below T.
//
// Per 64-key tile each warp computes S = Q K^T for its 16 rows on mma.sync
// (bf16 in, fp32 accumulate) from Q fragments held in registers, applies
// the scale and mask, updates its running max and sum, and forms P in
// bf16 A fragments; P V takes V's B fragments with ldmatrix.trans straight
// from the row-major tile the ring copied (no transposing copy as in K1).
// What bounds it on the H100: 4*B*H*T*T*64 FLOP = 2.8e11 at large-v1 batch
// 24 (0.28 ms at 989 TFLOP/s) against ~0.37 GB of q/k/v/out (0.11 ms):
// operations. The score and probability tiles live only in registers.
#include "common.cuh"

namespace {

constexpr int BQ = 128;       // query rows per block (16 per warp)
constexpr int BKV = 64;       // keys per tile
constexpr int DH = 64;        // head width
constexpr int LD = DH + 8;    // padded shared row (144 bytes): conflict-free fragments
constexpr int NST = 3;        // ring stages
constexpr int THREADS = 256;  // 8 warps
constexpr int TILE = BKV * LD;  // bf16 of one K or V tile
constexpr int SMEM = (BQ * LD + NST * 2 * TILE) * 2;

__global__ void __launch_bounds__(THREADS)
    enc_flash_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out, int T, int H,
                     float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  bf16* Qs = smem;              // [BQ][LD]
  bf16* ring = smem + BQ * LD;  // NST x (K tile, V tile), each [BKV][LD]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int D = H * DH;
  const size_t base = (size_t)b * T * D + (size_t)h * DH;
  const int n_tiles = (T + BKV - 1) / BKV;

  auto load_tile = [&](int c) {
    bf16* ks = ring + (c % NST) * 2 * TILE;
    bf16* vs = ks + TILE;
    for (int i = tid; i < BKV * DH / 8; i += THREADS) {
      const int r = i >> 3, col = (i & 7) * 8;
      const int t = c * BKV + r;
      const bool ok = t < T;
      const size_t off = base + (size_t)(ok ? t : 0) * D + col;
      cp_async16(ks + r * LD + col, k + off, ok);
      cp_async16(vs + r * LD + col, v + off, ok);
    }
  };

  // Q rides in the first commit group with tile 0
  for (int i = tid; i < BQ * DH / 8; i += THREADS) {
    const int r = i >> 3, col = (i & 7) * 8;
    const int t = qt * BQ + r;
    const bool ok = t < T;
    cp_async16(Qs + r * LD + col, q + base + (size_t)(ok ? t : 0) * D + col, ok);
  }
#pragma unroll
  for (int c = 0; c < NST - 1; ++c) {
    if (c < n_tiles) load_tile(c);
    cp_async_commit();
  }

  uint32_t qf[4][4];
  float o[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows g and g + 8
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the row sums

  for (int c = 0; c < n_tiles; ++c) {
    cp_async_wait<NST - 2>();
    // tile c (and Q) has landed for every thread, and every thread is done
    // with tile c - 1, whose stage the next load refills
    __syncthreads();
    if (c + NST - 1 < n_tiles) load_tile(c + NST - 1);
    cp_async_commit();
    if (c == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const bf16* p = Qs + (warp * 16 + g) * LD + kk * 16 + tg * 2;
        qf[kk][0] = ld_pair(p);
        qf[kk][1] = ld_pair(p + 8 * LD);
        qf[kk][2] = ld_pair(p + 8);
        qf[kk][3] = ld_pair(p + 8 * LD + 8);
      }
    }
    const bf16* Ks = ring + (c % NST) * 2 * TILE;
    const bf16* Vs = Ks + TILE;
    const int kv0 = c * BKV;

    // S = Q K^T for this warp's 16 rows x 64 keys (8 n-tiles)
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const bf16* p = Ks + (nt * 8 + g) * LD + kk * 16 + tg * 2;
        const uint32_t bb[2] = {ld_pair(p), ld_pair(p + 8)};
        mma_bf16_16816(s[nt], qf[kk], bb);
      }
    }

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool ok = kv0 + nt * 8 + tg * 2 + j < T;
        s[nt][j] = ok ? s[nt][j] * scale : -INFINITY;
        s[nt][2 + j] = ok ? s[nt][2 + j] * scale : -INFINITY;
        mx0 = fmaxf(mx0, s[nt][j]);
        mx1 = fmaxf(mx1, s[nt][2 + j]);
      }
    }
    // the four threads of a quad share a row
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // every visited tile holds a valid key, so mx0/mx1 are finite here
    const float c0 = __expf(m0 - mx0), c1 = __expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      o[nt][0] *= c0;
      o[nt][1] *= c0;
      o[nt][2] *= c1;
      o[nt][3] *= c1;
    }

    // P = exp(S - m) as bf16 A fragments: n-tiles 2kk, 2kk+1 form k-step kk
    uint32_t pf[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float p0 = __expf(s[nt][0] - m0), p1 = __expf(s[nt][1] - m0);
      const float p2 = __expf(s[nt][2] - m1), p3 = __expf(s[nt][3] - m1);
      l0 += p0 + p1;
      l1 += p2 + p3;
      const int kk = nt >> 1, hi = (nt & 1) * 2;
      pf[kk][hi] = pack_bf16(p0, p1);
      pf[kk][hi + 1] = pack_bf16(p2, p3);
    }

    // O += P V; ldmatrix.trans gives the B fragments of two 8-wide column
    // tiles from the [key][d] tile: lanes 0-7 keys 0-7, 8-15 keys 8-15 of
    // columns d0..d0+7, lanes 16-31 the same keys of columns d0+8..d0+15
    const int vrow = (lane & 7) + ((lane >> 3) & 1) * 8, vcol = (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, Vs + (kk * 16 + vrow) * LD + np * 16 + vcol);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_bf16_16816(o[2 * np], pf[kk], b0);
        mma_bf16_16816(o[2 * np + 1], pf[kk], b1);
      }
    }
  }
  cp_async_wait<0>();

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int r0 = qt * BQ + warp * 16 + g;
  const int r1 = r0 + 8;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = nt * 8 + tg * 2;
    if (r0 < T)
      *reinterpret_cast<uint32_t*>(out + base + (size_t)r0 * D + col) =
          pack_bf16(o[nt][0] * inv0, o[nt][1] * inv0);
    if (r1 < T)
      *reinterpret_cast<uint32_t*>(out + base + (size_t)r1 * D + col) =
          pack_bf16(o[nt][2] * inv1, o[nt][3] * inv1);
  }
}

}  // namespace

// q, k, v, out: contiguous [B, T, H*64] bf16.
extern "C" int enc_flash_bf16(const void* q, const void* k, const void* v, void* out, int B,
                              int T, int H, float scale, void* stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(enc_flash_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid((T + BQ - 1) / BQ, H, B);
  enc_flash_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), T, H, scale);
  return static_cast<int>(cudaGetLastError());
}
