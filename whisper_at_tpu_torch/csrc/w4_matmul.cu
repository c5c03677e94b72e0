// K5: the decode loop's int4-weight matmul,
//   out fp32 [M, N] = x bf16 [M, K] @ unpack4(Wp)^T,  M <= 256,
// with Wp int8 [N, K/2] in the pack4 layout of models/layers.py (adjacent
// pairs along K, low nibble first).
//
// Replaces whisper_at_tpu/ops/w4_matmul.py::w4_matmul (Pallas, TPU), which
// keeps all of x resident in VMEM and packs halves of the output axis. On
// Hopper x does not fit a block (fc2 at M = 24 is 245 KB), so K is split.
// What bounds it on the H100: the bytes. At large-v1 the decode steps give
// M = 24 (greedy) to 120 (beam 5) rows against (K, N) = (1280, 3840),
// (1280, 1280), (1280, 5120) and (5120, 1280); fc1 at M = 24 moves 3.3 MB
// of packed weight, 61 KB of x and 0.5 MB of output (~1.1 us at 3.35 TB/s)
// for 0.3 GFLOP (0.3 us at 989 TFLOP/s). The decode loop meets each weight
// cold, after 31 other layers' weights have passed through the L2.
//
// Design: one round trip to HBM and as little fixed cost as the split
// allows.
//  - Copies: at the start every thread issues all of its block's weight and
//    x copies at once (cp.async, 16 bytes each; a weight copy is 32 codes of
//    one column, so four threads read a column's 64 contiguous bytes of a
//    128-wide K chunk), then one wait and one __syncthreads; no ring and no
//    barrier per chunk (above 96 rows a block of many chunks takes x in two
//    parts). The codes are widened to bf16 in registers (a byte permute,
//    one LOP3 and one bf16x2 subtraction a pair, exact) and never stored.
//  - K order: a lane's 32 codes span K offsets 32t .. 32t+31 of a chunk,
//    t = lane % 4, and feed 8 k-steps of mma.sync m16n8k16 (4 codes a step:
//    offsets 32t + 4s .. +3 stand for the instruction's k 2t, 2t+1, 2t+8,
//    2t+9). x takes the same permutation, so each lane reads its weight as
//    one 16-byte shared load a chunk and its x fragments as 16-byte shared
//    loads (8 bf16: two k-steps) from a tile whose 16-byte units are
//    XOR-swizzled so that those loads are free of bank conflicts. The chunk
//    loop is rolled, so the code stays short.
//  - Column tile: 8 warps of 8 columns, BN = 64. x is read from L2 once a
//    column block, N / 64 times: 1.5x the weight's bytes at M = 24, 6x at
//    M = 96. Tiles of 128 columns read x half as often but ran slower
//    (fewer blocks to share the card, PERF.md): x comes from L2, and the
//    weight's latency, not L2's rate, bounds these products.
//  - Split: the K chunks are split over a thread block cluster of up to 8
//    blocks along K, sized so that the grid fits one wave; the partial tiles
//    are pushed through distributed shared memory to the block that sums
//    their row, and summed in rank order (deterministic, no float atomics,
//    one launch). A split of 1 writes its tile directly. The cluster arrive
//    is issued at the start and its wait sits just before the remote
//    writes, so the only exposed barrier is the one after them.
//  - TMA copies, wgmma with the weight as the A operand from registers, and
//    one block per SM were each tried and measured no faster (PERF.md): at
//    these sizes the launch, the loads' latency and the cluster reduction
//    set most of the time.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;    // 8 warps of 8 output columns
constexpr int BN = 64;          // output columns of a block
constexpr int BKC = 128;        // K per chunk: 4 lanes x 32 codes
constexpr int MAX_SPLIT = 8;    // blocks of a cluster (portable limit)
constexpr int MAX_CPB = 5;      // chunks per block: K <= 8 * 5 * 128
constexpr int X_SMEM_MAX = 128 * 1024;  // bytes of x a block holds at once

constexpr int W_BYTES = BN * BKC / 2;  // packed weight of one chunk of a block

template <int MT>
struct Tile {
  static constexpr int ROWS = MT * 16;
  static constexpr int CHUNK_BYTES = ROWS * BKC * 2;  // x of one chunk in shared memory
  static constexpr int XCH = X_SMEM_MAX / CHUNK_BYTES < MAX_CPB ? X_SMEM_MAX / CHUNK_BYTES
                                                                 : MAX_CPB;
};

// a word of four pack4 bytes (byte j: the codes of k 2j, low nibble, and
// 2j + 1) -> four bf16x2 {2j, 2j+1}: each nibble biased by 8 goes into the
// mantissa of 0x4300 (bf16 128), making 136 + code, and one bf16x2
// subtraction leaves the code (exact); a byte permute and one LOP3 a pair
__device__ __forceinline__ void widen_word(uint32_t w, uint32_t b[4]) {
  const uint32_t u = w ^ 0x88888888u;
  const uint32_t lo = u & 0x0F0F0F0Fu, hi = (u >> 4) & 0x0F0F0F0Fu;
  const __nv_bfloat162 bias = __floats2bfloat162_rn(136.f, 136.f);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t r = (__byte_perm(lo, hi, j | (4 + j) << 8) & 0x00FF00FFu) | 0x43004300u;
    __nv_bfloat162 v = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&r), bias);
    b[j] = *reinterpret_cast<uint32_t*>(&v);
  }
}

// the shared-memory slot of 16-byte unit u (8 bf16, 0..15) of a row's chunk:
// lanes (g, t) read unit 4t + i of rows g; flipping bit 1 for u >= 8 and
// bit 0 for odd rows puts the 8 lanes of a quarter-warp on 8 distinct
// 16-byte bank groups
__device__ __forceinline__ int x_slot(int u, int row) {
  return u ^ (((u >> 3) & 1) << 1) ^ (row & 1);
}

template <int MT>
__global__ void __launch_bounds__(THREADS, MT <= 2 ? 2 : 1)
    w4_matmul_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ wp,
                     float* __restrict__ out, int M, int N, int K, int cpb, int split) {
  using T = Tile<MT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int xch = cpb < T::XCH ? cpb : T::XCH;
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [xch][ROWS][BKC], units swizzled
  // the block's packed weight: [cpb][BN columns][4 parts t] of 16 bytes
  unsigned char* ws = smem_raw + xch * T::CHUNK_BYTES;
  // partial tiles pushed here by the cluster's blocks: [rank][row / split][BN]
  float* recv = reinterpret_cast<float*>(ws + cpb * W_BYTES);

  const int nchunks = (K + BKC - 1) / BKC;
  const int rank = blockIdx.y;  // the cluster spans grid y
  const int c_begin = rank * cpb;
  const int nc = min(cpb, nchunks - c_begin);
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // a block's shared memory may be written by the cluster only once the
  // block runs: arrive now, wait before the first remote write
  if (split > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // the block's whole weight slice, every copy in flight at once: 16 bytes
  // are 32 codes of one column, four threads cover a column's 64-byte chunk
  for (int i = tid; i < nc * BN * 4; i += THREADS) {
    const int part = i & 3, col = (i >> 2) % BN, c = (i >> 2) / BN;
    const int k = (c_begin + c) * BKC + 32 * part;
    const bool ok = n0 + col < N && k < K;
    cp_async16(ws + i * 16, wp + (ok ? (size_t)(n0 + col) * (K / 2) + k / 2 : 0), ok);
  }

  // chunks c0 .. c0 + cnt - 1 of the block's x slice into shared memory
  auto load_x = [&](int c0, int cnt) {
    for (int c = 0; c < cnt; ++c) {
      for (int i = tid; i < T::ROWS * 16; i += THREADS) {
        const int u = i & 15, row = i >> 4, k = (c_begin + c0 + c) * BKC + u * 8;
        const bool ok = row < M && k < K;
        cp_async16(xs + (c * T::ROWS + row) * BKC + x_slot(u, row) * 8,
                   x + (ok ? (size_t)row * K + k : 0), ok);
      }
    }
    cp_async_commit();
  };

  float acc[MT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) acc[mi][0] = acc[mi][1] = acc[mi][2] = acc[mi][3] = 0.f;

  // this lane's weight: column 8 warp + g, part t
  const uint4* wl = reinterpret_cast<const uint4*>(ws) + (warp * 8 + g) * 4 + t;
#pragma unroll 1
  for (int c = 0; c < nc; ++c) {
    if (c % T::XCH == 0) {
      if (c > 0) __syncthreads();  // every warp is done with the previous part
      load_x(c, min(T::XCH, nc - c));
      cp_async_wait<0>();
      __syncthreads();
    }
    const bf16* xc = xs + (c % T::XCH) * T::ROWS * BKC;
    const uint4 w = wl[c * BN * 4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // k-steps 2i and 2i + 1
      const int slot = x_slot(4 * t + i, g) * 8;
      uint32_t b[4];
      widen_word((&w.x)[i], b);  // codes 8i .. 8i+7
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const uint4 r0 = *reinterpret_cast<const uint4*>(xc + (mi * 16 + g) * BKC + slot);
        const uint4 r1 = *reinterpret_cast<const uint4*>(xc + (mi * 16 + g + 8) * BKC + slot);
        const uint32_t a0[4] = {r0.x, r1.x, r0.y, r1.y};  // K 32t+8i .. +3
        const uint32_t a1[4] = {r0.z, r1.z, r0.w, r1.w};  // K 32t+8i+4 .. +7
        mma_bf16_16816(acc[mi], a0, b);
        mma_bf16_16816(acc[mi], a1, b + 2);
      }
    }
  }

  const int colw = warp * 8 + 2 * t;  // this lane's first column within the block
  if (split == 1) {
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = mi * 16 + g + half * 8;
        if (row < M && n0 + colw < N)
          *reinterpret_cast<float2*>(out + (size_t)row * N + n0 + colw) =
              make_float2(acc[mi][2 * half], acc[mi][2 * half + 1]);
      }
    return;
  }

  // push each partial to the block that sums its row (row % split), into
  // that block's slot for this rank; one cluster barrier, then every block
  // adds its rows' partials in rank order and writes them
  cg::cluster_group cluster = cg::this_cluster();
  const int rows_per = (M + split - 1) / split;
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = mi * 16 + g + half * 8;
      if (row < M)
        *reinterpret_cast<float2*>(cluster.map_shared_rank(recv, row % split) +
                                   (rank * rows_per + row / split) * BN + colw) =
            make_float2(acc[mi][2 * half], acc[mi][2 * half + 1]);
    }
  cluster.sync();
  for (int e = tid; e < rows_per * BN; e += THREADS) {
    const int row = (e / BN) * split + rank, col = n0 + e % BN;
    if (row >= M) break;
    if (col >= N) continue;
    float s = recv[e];
    for (int r = 1; r < split; ++r) s += recv[r * rows_per * BN + e];
    out[(size_t)row * N + col] = s;
  }
}

template <int MT>
cudaError_t launch(const bf16* x, const int8_t* wp, float* out, int M, int N, int K, int sms,
                   cudaStream_t stream) {
  using T = Tile<MT>;
  static int per_sm = 0;  // blocks of this instantiation an SM holds at its largest
  if (per_sm == 0) {
    const int most = T::XCH * T::CHUNK_BYTES + MAX_CPB * W_BYTES +
                     (T::ROWS + MAX_SPLIT) * BN * 4;
    cudaError_t e = cudaFuncSetAttribute(
        w4_matmul_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, w4_matmul_kernel<MT>, THREADS,
                                                        most);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) per_sm = 1;
  }
  const int nchunks = (K + BKC - 1) / BKC;
  const int cols = (N + BN - 1) / BN;
  // the largest split (<= 8) whose grid fits one wave, at least the one that
  // keeps every block within MAX_CPB chunks; then as few chunks a block as
  // that split allows, and no block without a chunk
  int want = MAX_SPLIT;
  while (want > 1 && cols * want > per_sm * sms) --want;
  const int least = (nchunks + MAX_CPB - 1) / MAX_CPB;
  if (want < least) want = least;
  if (want > MAX_SPLIT) return cudaErrorInvalidValue;
  const int cpb = (nchunks + want - 1) / want;
  const int split = (nchunks + cpb - 1) / cpb;
  const int xch = cpb < T::XCH ? cpb : T::XCH;
  const int rows_per = (M + split - 1) / split;
  const int smem = xch * T::CHUNK_BYTES + cpb * W_BYTES +
                   (split > 1 ? split * rows_per * BN * 4 : 0);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cols, split, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = split;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, w4_matmul_kernel<MT>, x, wp, out, M, N, K, cpb, split);
}

}  // namespace

// x [M, K] bf16, Wp [N, K/2] int8 (pack4), out [M, N] fp32. Requires
// 1 <= M <= 256, N % 64 == 0, K % 32 == 0 and K <= 5120.
extern "C" int w4_matmul_bf16(const void* x, const void* wp, void* out, int M, int N, int K,
                              void* stream) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (M < 1 || M > 256 || N < 64 || N % 64 || K < 32 || K % 32 || K > 5120)
    return static_cast<int>(cudaErrorInvalidValue);
  const bf16* xb = static_cast<const bf16*>(x);
  const int8_t* w = static_cast<const int8_t*>(wp);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (M <= 16) e = launch<1>(xb, w, o, M, N, K, sms, st);
  else if (M <= 32) e = launch<2>(xb, w, o, M, N, K, sms, st);
  else if (M <= 64) e = launch<4>(xb, w, o, M, N, K, sms, st);
  else if (M <= 96) e = launch<6>(xb, w, o, M, N, K, sms, st);
  else if (M <= 128) e = launch<8>(xb, w, o, M, N, K, sms, st);
  else if (M <= 192) e = launch<12>(xb, w, o, M, N, K, sms, st);
  else e = launch<16>(xb, w, o, M, N, K, sms, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
