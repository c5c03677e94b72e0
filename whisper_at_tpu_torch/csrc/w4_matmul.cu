// K5: the decode loop's int4-weight matmul,
//   out fp32 [M, N] = x bf16 [M, K] @ unpack4(Wp)^T,  M <= 256,
// with Wp int8 [N, K/2] in the pack4 layout of models/layers.py (adjacent
// pairs along K, low nibble first).
//
// Replaces whisper_at_tpu/ops/w4_matmul.py::w4_matmul (Pallas, TPU), which
// keeps all of x resident in VMEM and packs halves of the output axis. On
// Hopper x does not fit a block (fc2 at M = 24 is 245 KB), so K is tiled.
// What bounds it on the H100: the bytes. At large-v1 the decode steps give
// M = 24 (greedy) to 120 (beam 5) rows against (K, N) = (1280, 3840),
// (1280, 1280), (1280, 5120) and (5120, 1280); fc1 at M = 24 moves 3.3 MB
// of packed weight, 61 KB of x and 0.5 MB of output (~1.1 us at 3.35 TB/s)
// for 0.3 GFLOP (0.3 us at 989 TFLOP/s). A bf16 product would stream four
// times the weight bytes.
//
// Design: the packed weight is read once from HBM, straight into
// registers, and widened to bf16 in registers; no bf16 copy of the weight
// exists anywhere. A block of 8 warps owns 64 output columns (8 per warp,
// one m16n8k16 n-tile) and all M rows (MT m-tiles); x streams through an
// 8-deep cp.async ring in shared memory in chunks of 32 K, shared by the 8
// warps. Each lane's 32-bit weight word holds the 8 codes of K offsets
// 8t .. 8t+7 of its column; the dot product's K order is permuted the same
// way for both operands, so x's fragment is one 16-byte shared-memory
// load per row and the weight's one 4-byte global load per chunk. To put
// enough blocks on the card at N = 1280 the K axis is split over a thread
// block cluster of up to 8 blocks; the partial tiles are summed through
// distributed shared memory in rank order (deterministic, one launch).
// A block does little work behind fixed latencies, so they are kept few:
// one __syncthreads a chunk, partials pushed to the block that sums them
// (remote writes, no remote reads), one cluster barrier, and a split sized
// so that the grid fits one wave at the kernel's measured occupancy.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;    // 8 warps x 8 output columns
constexpr int BN = 64;          // output columns per block
constexpr int BK = 32;          // K per chunk
constexpr int NST = 8;          // x chunks in flight
constexpr int MAX_SPLIT = 8;    // blocks of a cluster (portable limit)
constexpr int MAX_CHUNKS = 20;  // K chunks per block: K <= 8 * 20 * 32

// one pack4 byte (low nibble = even k) -> bf16x2 {even k, odd k}: the bits
// 0x4300 | u are the bf16 value 128 + u, so each nibble biased by 8 becomes
// 136 + code, and one bf16x2 subtraction leaves the code (exact)
__device__ __forceinline__ uint32_t nibbles_to_bf16x2(uint32_t byte) {
  const uint32_t u = byte ^ 0x88u;
  uint32_t r = 0x43004300u | (u & 0xFu) | ((u & 0xF0u) << 12);
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&r);
  v = __hsub2(v, __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int MT>
__global__ void __launch_bounds__(THREADS, MT <= 2 ? 3 : MT <= 6 ? 2 : 1)
    w4_matmul_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ wp,
                     float* __restrict__ out, int M, int N, int K, int split) {
  constexpr int ROWS = MT * 16;
  constexpr int STAGE = ROWS * BK;  // bf16 per ring stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [NST][ROWS][BK]
  // partial sums pushed here by the cluster's blocks: [slice][row / split][BN]
  float* recv = reinterpret_cast<float*>(smem_raw + NST * STAGE * sizeof(bf16));

  cg::cluster_group cluster = cg::this_cluster();
  const int slice = static_cast<int>(cluster.block_rank());
  const int n0 = blockIdx.x * BN;
  const int kb = K / split;
  const int k_begin = slice * kb;
  const int nch = kb / BK;
  const int rows_per = (ROWS + split - 1) / split;  // tile rows each block sums
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // a block's shared memory may be written by the cluster only once the
  // block runs: arrive now, wait before the first remote write
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // every weight word of this lane's column, all loads in flight at once
  const int8_t* wrow = wp + (size_t)(n0 + warp * 8 + g) * (K / 2) + k_begin / 2 + 4 * t;
  uint32_t wreg[MAX_CHUNKS];
#pragma unroll
  for (int c = 0; c < MAX_CHUNKS; ++c)
    wreg[c] = c < nch ? __ldg(reinterpret_cast<const uint32_t*>(wrow + c * (BK / 2))) : 0u;

  auto load_stage = [&](int c) {
    bf16* dst = xs + (c % NST) * STAGE;
    const int k0 = k_begin + c * BK;
    for (int i = tid; i < ROWS * 4; i += THREADS) {
      const int row = i >> 2, col = (i & 3) * 8;
      const bool ok = row < M;
      cp_async16(dst + row * BK + col, x + (size_t)(ok ? row : 0) * K + k0 + col, ok);
    }
  };

  float acc[MT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) acc[mi][0] = acc[mi][1] = acc[mi][2] = acc[mi][3] = 0.f;

#pragma unroll
  for (int c = 0; c < NST - 1; ++c) {
    if (c < nch) load_stage(c);
    cp_async_commit();
  }
#pragma unroll
  for (int c = 0; c < MAX_CHUNKS; ++c) {
    if (c < nch) {
      cp_async_wait<NST - 2>();
      // one barrier a chunk: chunk c has landed for every thread, and every
      // thread is done with chunk c - 1, whose stage the next load refills
      __syncthreads();
      if (c + NST - 1 < nch) load_stage(c + NST - 1);
      cp_async_commit();
      const bf16* xc = xs + (c % NST) * STAGE;
      const uint32_t w = wreg[c];
      const uint32_t b0[2] = {nibbles_to_bf16x2(w & 0xFFu), nibbles_to_bf16x2((w >> 8) & 0xFFu)};
      const uint32_t b1[2] = {nibbles_to_bf16x2((w >> 16) & 0xFFu), nibbles_to_bf16x2(w >> 24)};
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        // rows g and g + 8 of the m-tile, K offsets 8t .. 8t+7 of the chunk
        const uint4 r0 = *reinterpret_cast<const uint4*>(xc + (mi * 16 + g) * BK + 8 * t);
        const uint4 r1 = *reinterpret_cast<const uint4*>(xc + (mi * 16 + g + 8) * BK + 8 * t);
        const uint32_t a0[4] = {r0.x, r1.x, r0.y, r1.y};  // K 8t..8t+3
        const uint32_t a1[4] = {r0.z, r1.z, r0.w, r1.w};  // K 8t+4..8t+7
        mma_bf16_16816(acc[mi], a0, b0);
        mma_bf16_16816(acc[mi], a1, b1);
      }
    }
  }

  // push each partial to the block that sums its row (row % split), into
  // that block's slot for this slice; one cluster barrier, then every
  // block adds its rows' partials in rank order and writes them
  const int col = warp * 8 + 2 * t;
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = mi * 16 + g + half * 8;
      if (row < M) {
        float* dst = cluster.map_shared_rank(recv, row % split);
        *reinterpret_cast<float2*>(dst + (slice * rows_per + row / split) * BN + col) =
            make_float2(acc[mi][2 * half], acc[mi][2 * half + 1]);
      }
    }
  }
  cluster.sync();
  for (int e = tid; e < rows_per * BN; e += THREADS) {
    const int row = (e / BN) * split + slice;
    if (row >= M) break;
    float s = recv[e];
    for (int r = 1; r < split; ++r) s += recv[r * rows_per * BN + e];
    out[(size_t)row * N + n0 + (e % BN)] = s;
  }
}

template <int MT>
cudaError_t launch(const bf16* x, const int8_t* wp, float* out, int M, int N, int K, int sms,
                   cudaStream_t stream) {
  constexpr int ROWS = MT * 16;
  // the x ring, then the partials a block receives: split * rows_per <= ROWS + MAX_SPLIT rows
  const int smem = NST * ROWS * BK * static_cast<int>(sizeof(bf16)) +
                   (ROWS + MAX_SPLIT) * BN * static_cast<int>(sizeof(float));
  static int per_sm = 0;  // blocks of this instantiation an SM holds
  if (per_sm == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        w4_matmul_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, w4_matmul_kernel<MT>, THREADS,
                                                        smem);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) per_sm = 1;
  }
  // the largest split whose grid fits one wave (else the smallest that
  // keeps every block within MAX_CHUNKS chunks)
  int split = 0;
  for (int s = MAX_SPLIT; s >= 1; s /= 2) {
    if (K % (s * BK) == 0 && K / (s * BK) <= MAX_CHUNKS) {
      if (split == 0 || (N / BN) * split > per_sm * sms) split = s;
    }
  }
  if (split == 0) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N / BN, split, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = split;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, w4_matmul_kernel<MT>, x, wp, out, M, N, K, split);
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
  if (M < 1 || M > 256 || N % BN || K % BK) return static_cast<int>(cudaErrorInvalidValue);
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
