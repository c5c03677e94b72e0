// Tiled bf16 tensor-core GEMM main loop of the cross-KV projection (K3) on
// mma.sync (K2's products run on gemm_sm90.cuh).
//
//   acc[BM x BN tile] = A[rows, K] @ B[n0 : n0 + BN, K]^T
//
// A and B are bf16 and K-contiguous (B is a weight in torch's [out, in]
// layout), the sum is fp32. One block of 256 threads (8 warps as 2 x 4)
// owns a 128 x 128 output tile; each warp owns 64 x 32 of it as 4 x 4
// m16n8k16 tiles. K advances 32 at a time through a two-stage cp.async
// ring in shared memory (rows padded to 40 bf16 = 80 bytes, which makes
// the fragment loads conflict-free). The caller maps tile rows to A rows
// (nullptr = a zero row), so a padded or ragged M needs no copy.
#pragma once

#include "common.cuh"

namespace gemm {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int LDS = BK + 8;  // padded shared-memory row, in bf16
constexpr int THREADS = 256;
constexpr int STAGE = (BM + BN) * LDS;           // bf16 per stage
constexpr int SMEM_BF16 = 2 * STAGE;             // 40960 bytes

struct Frag {
  float acc[4][4][4];  // [m16 tile][n8 tile][c0..c3]
};

// warp coordinates inside the block tile
__device__ __forceinline__ int warp_row0() { return (threadIdx.x >> 7) * 64; }
__device__ __forceinline__ int warp_col0() { return ((threadIdx.x >> 5) & 3) * 32; }

template <class ARow>
__device__ __forceinline__ void mainloop(Frag& f, ARow a_row,
                                         const bf16* __restrict__ B, int K,
                                         int n0, bf16* smem) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int wr = warp_row0(), wc = warp_col0();

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) f.acc[i][j][c] = 0.f;

  // each thread copies two 16-byte chunks of A and two of B per stage:
  // chunk c -> tile row c / 4, columns (c % 4) * 8 .. + 7
  const bf16* a_src[2];
  bool a_ok[2];
  const bf16* b_src[2];
  int s_off[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * THREADS;
    const int row = c >> 2, col = (c & 3) * 8;
    const bf16* p = a_row(row);
    a_ok[i] = p != nullptr;
    a_src[i] = (a_ok[i] ? p : B) + col;  // any valid address when zero-filling
    b_src[i] = B + (size_t)(n0 + row) * K + col;
    s_off[i] = row * LDS + col;
  }

  auto load_stage = [&](int stage, int k0) {
    bf16* As = smem + stage * STAGE;
    bf16* Bs = As + BM * LDS;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      cp_async16(As + s_off[i], a_src[i] + k0, a_ok[i]);
      cp_async16(Bs + s_off[i], b_src[i] + k0, true);
    }
  };

  const int nk = K / BK;
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load_stage((kt + 1) & 1, (kt + 1) * BK);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* As = smem + (kt & 1) * STAGE;
    const bf16* Bs = As + BM * LDS;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const bf16* p = As + (wr + mi * 16 + g) * LDS + ks + tg * 2;
        af[mi][0] = ld_pair(p);
        af[mi][1] = ld_pair(p + 8 * LDS);
        af[mi][2] = ld_pair(p + 8);
        af[mi][3] = ld_pair(p + 8 * LDS + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const bf16* p = Bs + (wc + ni * 8 + g) * LDS + ks + tg * 2;
        bfr[ni][0] = ld_pair(p);
        bfr[ni][1] = ld_pair(p + 8);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16_16816(f.acc[mi][ni], af[mi], bfr[ni]);
    }
    __syncthreads();
  }
}

}  // namespace gemm
