// One bf16 GEMM for Hopper (sm_90a), the products of K2 (enc_mlp.cu) and
// K3 (kv_quant.cu):
//
//   C[z] = epilogue(A[z] B^T),  A[z] [M, K] for z < Z, B [N, K], fp32 sums
//
// A and B are K-major (B is a weight in torch's Linear layout, which is
// wgmma's K-major B operand as it lies, so no transposing copy is made).
// A is one matrix (K2, Z = 1) or a batch of them (K3: xa [B, Ta, D], one
// matrix an audio row), read through one 3-D tensor map {K, M, Z}. B's
// rows come from two tensor maps: rows [0, n_split) from the first, the
// rest from the second (K3's Wk and Wv side by side, with no concatenated
// copy; K2 passes one map twice).
// The epilogue is a policy, Epi: the value each sum starts from, by row and
// column (epi.init), and what becomes of a warpgroup's finished 64 x BN
// sums (epi.store). StoreBf16 below is K2's: a function of each sum in
// registers (its GELU), bf16, a TMA store a 64-column chunk. K3's quantizes
// each 64-column chunk (one head) in registers and stores int8 or int4
// codes and fp32 scales (kv_quant.cu).
//
// Grid: persistent, one block per SM (the wrapper passes the card's SM
// count, fewer when there are fewer tiles). Block b takes the 128 x BN
// output tiles b, b + grid, b + 2 grid, ... of a list that walks N fastest
// inside a 128-row panel of A, panels of A[0] first, then A[1], ..., so the
// blocks in flight share a few panels of A and all of B in L2. BN is 256 or
// 128 (the wrapper's plan). A tile never spans two matrices of A: each
// has ceil(M / 128) panels, rows past M loading as zeros.
// A block is NC = 2 consumer warpgroups and one producer warpgroup:
//   Producer: one thread issues TMA copies through the tensor maps with
//     128-byte swizzle: per k-step of BK = 64 (one 128-byte span of bf16)
//     the A box {64, 128, 1} and the B box {64, BN} into a ring of
//     STAGES = 4 stages, each guarded by a full and an empty mbarrier. One
//     counter of k-steps runs through all the block's tiles, on both sides,
//     and gives each stage and its phase bit; the producer runs into the
//     next tile while the consumers finish this one. Rows of A past M load
//     as zeros (the tensor map's bounds), so a ragged M needs no padding.
//   Consumers: warpgroup w owns rows 64w .. 64w + 63 of the tile and runs
//     wgmma m64nBNk16 with both operands in shared memory, four k16 steps
//     a stage, one stage's group in flight (wgmma_wait<1>): a stage is
//     released to the producer when the group after it has been issued.
//     The accumulator is BN / 2 fp32 registers a thread (128 at BN = 256).
//     It starts from epi.init, loaded at the tile's start while those
//     registers are free: read in the epilogue, next to 128 live sums,
//     those loads left ptxas too few registers to keep them in flight, and
//     each waited its full latency (PERF.md).
//   Epilogue (StoreBf16): per 64-column chunk, epi in registers, bf16 into
//     one of the warpgroup's two 8 KB staging buffers (the 128-byte
//     swizzle: 16-byte chunk index XOR row % 8, conflict-free), then one
//     TMA store of the {64, 64} box, which clips rows past M. A buffer is
//     written again only after the store two chunks back has read it
//     (bulk_wait_read<1>), so stores overlap the next chunk's arithmetic,
//     and the producer's copies of the next tile overlap the whole
//     epilogue. K3's policy keeps the same buffers and the same order.
// Both warpgroups work on one tile ("cooperative"): the tensor cores idle
// while they run the epilogue, which at K = 1280 with erf-GELU is a large
// share of a tile's time. Warpgroups taking 128 x 128 tiles in turn, so
// that one's epilogue runs under the other's products (B multicast over a
// cluster of two blocks, to keep the operand bytes a FLOP at this tile's),
// measured slower on the H100 (PERF.md): one warpgroup's products
// alone ran far below the rate of two at once.
// Registers: 384 threads cap ptxas at 168 a thread (ENTRY_REGS); setmaxnreg
// takes the producer down to 40 and gives each consumer 232. launch() holds
// the compiled count to ENTRY_REGS at its first call: with fewer,
// setmaxnreg.inc would wait for registers the block never got, so it
// returns REGS_ERROR + the count instead of launching.
#pragma once

#include "hopper.cuh"

// Everything here has internal linkage, as in attn_sm90.cuh: a static of
// one instantiation (run's `configured`) is never bound to another's.
namespace gemm_sm90 {
namespace {

constexpr int BM = 128;                   // rows of a block tile
constexpr int BK = 64;                    // k of a stage
constexpr int ROW = BK * 2;               // bytes of a tile row: one swizzle span
constexpr int STAGES = 4;
constexpr int NC = 2;                     // consumer warpgroups
constexpr int WG_ROWS = BM / NC;          // 64 rows a consumer warpgroup
constexpr int THREADS = 128 * (NC + 1);
constexpr int A_TILE = BM * ROW;          // 16 KB
constexpr int EPI_COLS = 64;              // columns of an epilogue chunk
constexpr int EPI_TILE = WG_ROWS * EPI_COLS * 2;  // 8 KB
constexpr int EPI_BUFS = 2;               // staging buffers a warpgroup
constexpr int REGS_ERROR = 20000;
constexpr int ENTRY_REGS = (65536 / THREADS) / 8 * 8;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
static_assert(PRODUCER_REGS * 128 + CONSUMER_REGS * 128 * NC <= 65536,
              "setmaxnreg.inc may give the consumers only what the block holds");

template <int BN>
struct Layout {
  static_assert(BN == 128 || BN == 256, "wgmma's widths used here");
  static constexpr int B_TILE = BN * ROW;
  static constexpr int STAGE = A_TILE + B_TILE;
  // 1024 bytes of slack to align the tiles to the swizzle's 1024-byte
  // period; the ring, the staging buffers, then full[STAGES], empty[STAGES]
  static constexpr int SMEM = 1024 + STAGES * STAGE + NC * EPI_BUFS * EPI_TILE + 16 * STAGES;
  static_assert(SMEM <= 232448, "a block's shared memory");
  static_assert((BN / EPI_COLS) % EPI_BUFS == 0, "chunk c of every tile takes buffer c % 2");
};

// D[64 x 256] (+)= A[64 x 16] B[16 x 256], A and B K-major in shared memory
// (descriptor low words a_lo, b_lo); D is overwritten when accumulate is 0
__device__ __forceinline__ void wgmma_ss_m64n256(float (&d)[128], uint32_t a_lo, uint32_t b_lo,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "cvt.u64.u32 da, %128; or.b64 da, da, 0x4000004000000000;\n"
      "cvt.u64.u32 db, %129; or.b64 db, db, 0x4000004000000000;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "da, db, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a_lo), "r"(b_lo), "r"(accumulate));
}

// one k16 step of a consumer warpgroup's product, added to d, by its width
__device__ __forceinline__ void wgmma_acc(float (&d)[128], uint32_t a_lo, uint32_t b_lo) {
  wgmma_ss_m64n256(d, a_lo, b_lo, 1);
}

__device__ __forceinline__ void wgmma_acc(float (&d)[64], uint32_t a_lo, uint32_t b_lo) {
  wgmma_ss_m64n128(d, a_lo, b_lo, 1);
}

// The block's shared memory, by 32-bit shared-window address.
template <int BN>
struct Ring {
  uint32_t base;
  __device__ __forceinline__ uint32_t a_tile(int s) const { return base + s * Layout<BN>::STAGE; }
  __device__ __forceinline__ uint32_t b_tile(int s) const { return a_tile(s) + A_TILE; }
  __device__ __forceinline__ uint32_t epi_buf(int wg, int i) const {
    return base + STAGES * Layout<BN>::STAGE + (wg * EPI_BUFS + i) * EPI_TILE;
  }
  __device__ __forceinline__ uint32_t full(int s) const {
    return base + STAGES * Layout<BN>::STAGE + NC * EPI_BUFS * EPI_TILE + 8 * s;
  }
  __device__ __forceinline__ uint32_t empty(int s) const { return full(s) + 8 * STAGES; }
};

// The tile list: N fastest inside a 128-row panel, the panels of A[0],
// then those of A[1], ... The N columns come in runs ("parts") of n_split,
// one a map of B (K2: one part; K3: K and V), each covered by
// ceil(n_split / bn) tiles, so no tile straddles two parts; a part's last
// tile may run past its n_split columns (K3 at a tensor-parallel width of
// 320), whose rows of B load as zeros and whose columns the epilogue drops.
struct Tiles {
  int panels;      // 128-row panels of one matrix of A
  int n_tiles_n, count, nk;
  int n_split;     // columns of a part: B's rows from here on come from the second map
  int part_tiles;  // tiles of one part
  __device__ __forceinline__ int panel(int t) const { return t / n_tiles_n; }
  __device__ __forceinline__ int m0(int t) const { return (panel(t) % panels) * BM; }
  __device__ __forceinline__ int z(int t) const { return panel(t) / panels; }
  // the tile's first column: part * n_split + its offset in the part
  __device__ __forceinline__ int n0(int t, int bn) const {
    const int j = t % n_tiles_n;
    return (j / part_tiles) * n_split + (j % part_tiles) * bn;
  }
};

template <int BN>
__device__ __forceinline__ void produce(const Ring<BN>& r, const Tiles& tl, const CUtensorMap* amap,
                                        const CUtensorMap* bmap0, const CUtensorMap* bmap1) {
  uint32_t it = 0;
  for (int t = blockIdx.x; t < tl.count; t += gridDim.x) {
    const int m0 = tl.m0(t), z = tl.z(t), n0 = tl.n0(t, BN);
    const bool second = n0 >= tl.n_split;
    const CUtensorMap* bmap = second ? bmap1 : bmap0;
    const int nb = second ? n0 - tl.n_split : n0;
    for (int kb = 0; kb < tl.nk; ++kb, ++it) {
      const int s = it % STAGES;
      // stage s's previous k-step (it - STAGES) released by every consumer warp
      if (it >= STAGES) mbar_wait(r.empty(s), ((it / STAGES) & 1) ^ 1);
      mbar_expect_tx(r.full(s), Layout<BN>::STAGE);
      tma_load(r.a_tile(s), amap, kb * BK, m0, z, r.full(s));
      tma_load(r.b_tile(s), bmap, kb * BK, nb, 0, r.full(s));
    }
  }
}

// One consumer warpgroup `wg`: rows 64 wg .. 64 wg + 63 of every tile.
template <int BN, class Epi>
__device__ __forceinline__ void consume(const Ring<BN>& r, const Tiles& tl, const Epi& epi,
                                        int wg) {
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, quad = lane & 3;
  float acc[BN / 2];
  uint32_t it = 0;
  for (int t = blockIdx.x; t < tl.count; t += gridDim.x) {
    const int m0 = tl.m0(t), n0 = tl.n0(t, BN);
    const int row_g = m0 + wg * WG_ROWS;
    // the sums start from epi's values (bias, residual), loaded while the
    // accumulator's registers are free, so the epilogue reads no memory
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 v = epi.init(row_g + warp * 16 + (lane >> 2) + 8 * i, n0 + 8 * j + 2 * quad);
        acc[4 * j + 2 * i] = v.x;
        acc[4 * j + 2 * i + 1] = v.y;
      }
    for (int kb = 0; kb < tl.nk; ++kb, ++it) {
      const int s = it % STAGES;
      warp_wait(r.full(s), (it / STAGES) & 1);
      const uint32_t a = r.a_tile(s) + wg * WG_ROWS * ROW, b = r.b_tile(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_acc(acc, desc_lo(a + 32 * kk), desc_lo(b + 32 * kk));
      wgmma_commit();
      // the group before this one has retired: release its stage
      wgmma_wait<1>();
      if (kb > 0 && lane == 0) mbar_arrive(r.empty((it - 1) % STAGES));
    }
    wgmma_wait<0>();
    hold(acc);
    if (lane == 0) mbar_arrive(r.empty((it - 1) % STAGES));
    epi.store(acc, r.epi_buf(wg, 0), wg, tl.z(t), row_g, n0);
  }
  // the stores read shared memory and write C before the block retires
  if (tid == 0) bulk_wait_all();
}

// The accumulator layout of m64nNk16, which the policies read: for each
// 8-column block j, acc[4j], acc[4j+1] at row 16 warp + lane/4, columns
// 8j + 2 quad + {0, 1}, and acc[4j+2], acc[4j+3] 8 rows below.

// K2's epilogue: C = f(sum) in bf16 through the tensor map cmap ([M, N],
// box {EPI_COLS, WG_ROWS}, 128-byte swizzle); f.init gives the sums'
// start (bias, residual). `bufs` is the warpgroup's first staging buffer.
template <class F>
struct StoreBf16 {
  CUtensorMap cmap;
  F f;
  int M;
  __device__ __forceinline__ float2 init(int row, int col) const { return f.init(row, col); }
  template <int N>
  __device__ __forceinline__ void store(float (&acc)[N], uint32_t bufs, int wg, int,
                                        int row_g, int n0) const {
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, quad = lane & 3;
    if (row_g >= M) return;  // rows all past M: nothing to store
#pragma unroll
    for (int c = 0; c < 2 * N / EPI_COLS; ++c) {
      // a tile has an even number of chunks, so chunk c of every tile
      // takes buffer c % 2
      const uint32_t buf = bufs + (c % EPI_BUFS) * EPI_TILE;
      // the store that last read buf (two chunks back) is done with it
      if (tid == 0) bulk_wait_read<EPI_BUFS - 1>();
      named_sync(1 + wg, 128);
#pragma unroll
      for (int j = 0; j < EPI_COLS / 8; ++j) {
        const int jj = c * (EPI_COLS / 8) + j;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = warp * 16 + (lane >> 2) + 8 * i;
          st_shared(buf + row * ROW + ((j ^ (row & 7)) << 4) + quad * 4,
                    pack_bf16(f(acc[4 * jj + 2 * i]), f(acc[4 * jj + 2 * i + 1])));
        }
      }
      fence_async_shared();
      named_sync(1 + wg, 128);
      if (tid == 0) tma_store_async(&cmap, buf, n0 + c * EPI_COLS, row_g, 0);
    }
  }
};

template <int BN, class Epi>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap0,
                const __grid_constant__ CUtensorMap bmap1, const __grid_constant__ Epi epi,
                Tiles tl) {
  extern __shared__ uint8_t smem_raw[];
  Ring<BN> r;
  r.base = (smem_u32(smem_raw) + 1023) & ~1023u;  // 1024-aligned: the swizzle's period
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(r.full(s), 1);
      mbar_init(r.empty(s), NC * 4);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (wg == NC) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == NC * 128) produce(r, tl, &amap, &bmap0, &bmap1);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    consume(r, tl, epi, wg);
  }
}

// ---- host ------------------------------------------------------------------- //
// the 2-D map (d2 = 1) of a contiguous [rows, cols] bf16 matrix whose box
// is {box_cols, box_rows}, 128-byte swizzle
inline int encode_matrix(EncodeTiled fn, CUtensorMap* map, const void* x, int rows, int cols,
                         int box_rows, int box_cols) {
  return encode_3d(fn, map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, cols, rows, 1, box_cols,
                   box_rows, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
}

// The tile list of Z matrices of A of M rows, N columns of B in parts of
// n_split (N a multiple of n_split; the first part from the first map),
// depth K, at block width bn.
inline Tiles tiles(int Z, int M, int N, int n_split, int K, int bn) {
  Tiles tl;
  tl.panels = (M + BM - 1) / BM;
  tl.part_tiles = (n_split + bn - 1) / bn;
  tl.n_tiles_n = (N / n_split) * tl.part_tiles;
  tl.count = Z * tl.panels * tl.n_tiles_n;
  tl.nk = K / BK;
  tl.n_split = n_split;
  return tl;
}

// The GEMM of the tile list tl on `blocks` persistent blocks: A through
// amap (box {BK, BM, 1}), B through bmap0 and bmap1 (box {BK, BN}), all
// bf16 with 128-byte swizzle; epi as above. N % BN == 0, K % 64 == 0.
template <int BN, class Epi>
inline int launch(const CUtensorMap& amap, const CUtensorMap& bmap0, const CUtensorMap& bmap1,
                  const Epi& epi, const Tiles& tl, int blocks, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    // the register count ptxas compiled is what setmaxnreg's arithmetic
    // takes (ENTRY_REGS); a block that starts with fewer would hang
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, gemm_kernel<BN, Epi>);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (attr.numRegs != ENTRY_REGS) return REGS_ERROR + attr.numRegs;
    e = cudaFuncSetAttribute(gemm_kernel<BN, Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Layout<BN>::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  gemm_kernel<BN, Epi><<<blocks, THREADS, Layout<BN>::SMEM, stream>>>(amap, bmap0, bmap1, epi, tl);
  return static_cast<int>(cudaGetLastError());
}

// C[M, N] = f(A[M, K] B[N, K]^T) in bf16 (K2's products) on `blocks`
// persistent blocks; A, B, C contiguous bf16, 16-byte aligned; N % BN == 0,
// K % 64 == 0, M >= 1.
template <int BN, class F>
inline int run(const void* a, const void* b, void* c, const F& f, int M, int N, int K,
               int blocks, cudaStream_t stream) {
  EncodeTiled fn;
  const cudaError_t e = encode_function(&fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  StoreBf16<F> epi;
  epi.f = f;
  epi.M = M;
  CUtensorMap am, bm;
  int rc = encode_matrix(fn, &am, a, M, K, BM, BK);
  if (rc == 0) rc = encode_matrix(fn, &bm, b, N, K, BN, BK);
  if (rc == 0) rc = encode_matrix(fn, &epi.cmap, c, M, N, WG_ROWS, EPI_COLS);
  if (rc != 0) return rc;
  return launch<BN>(am, bm, bm, epi, tiles(1, M, N, N, K, BN), blocks, stream);
}

}  // namespace
}  // namespace gemm_sm90
