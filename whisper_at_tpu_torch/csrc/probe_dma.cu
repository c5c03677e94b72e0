// P1 and P2: HBM streaming-bandwidth probes. Each streams a whole int8
// buffer x [rows, 128] (a whole number of chunks of chunk_rows rows) from
// device memory once and returns, in out int32 [129]:
//   out[0..127]  the column sums of the first 8 KB (64 rows) of every
//                chunk, summed over all chunks (the JAX probe's output);
//   out[128]     the XOR of every 32-bit word of x.
// The XOR word consumes every byte that crosses: without it nvcc deletes
// the loads of the bytes outside the slivers and the probe times 8 KB a
// chunk. It costs four integer XORs per 16-byte load (one per word), far
// below the card's integer rate. Integer addition and XOR are exact in any
// order, so merging the blocks with atomics gives the plain version's bits
// on every run. The caller zeroes out.
//
// Replaces tools/probe_dma.py (Pallas, TPU):
//   probe_auto      <- `auto` (:88, kernel body `auto_kernel` :79): a grid
//                      of one step per chunk, Pallas's pipeline copying each
//                      chunk into VMEM;
//   probe_ring_cp   <- `manual` (:136, kernel body `manual_kernel` :106):
//   probe_ring_tma     one invocation with an N-deep ring of manual DMA
//                      copies of whole chunks, N = 2, 4, 8.
//
// What bounds them on the H100: the bytes. rows * 128 bytes read once over
// 3.35 TB/s (512 MiB: 0.1603 ms); the arithmetic is a few integer
// operations per 16 bytes. Each design keeps enough bytes in flight per SM
// to cover device-memory latency and spends no more than a load, an XOR and
// (for the ring) a shared-memory read per 16 bytes:
//   * probe_auto streams through registers. The TPU grid carries its
//     output across sequential steps; GPU blocks run in parallel with no
//     carry, so the grid is chunks x parts (a part is 64 KB of a chunk), each
//     thread keeps UNROLL = 8 16-byte loads in flight per pass, and the part
//     holding a chunk's first 8 KB adds its column sums with int32 atomics.
//   * probe_ring_cp / probe_ring_tma are persistent: one block per SM (the
//     count read from the device), each walking its own contiguous share of
//     the buffer's stages. A TPU v5e is one core, so "one invocation" there
//     is the whole chip. A 1 MiB chunk does not fit in a block's 227 KB of
//     shared memory, so the ring's unit is a stage of stage_bytes (a power
//     of two dividing the chunk; the wrapper picks 64/32/16 KB at N =
//     2/4/8), N stages in flight per block. The cp_async entry has every
//     thread copy 16 bytes at a time (cp.async.cg, one commit group per
//     stage, wait_group<N-1>); the tma entry has one thread issue one bulk
//     copy per stage (cp.async.bulk, completion counted in bytes on the
//     stage's mbarrier). Consumers read the stage back from shared memory
//     into the XOR, adding the column sums of any rows that lie in a
//     chunk's first 8 KB; a barrier releases the slot before it is refilled.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int LANES = 128;
constexpr int SLIVER_BYTES = 8192;
constexpr int THREADS = 256;
constexpr int UNROLL = 8;
constexpr int PASS = THREADS * UNROLL * 16;  // bytes a P1 block loads per pass
constexpr int PART = 2 * PASS;               // a P1 block's part of a chunk
constexpr int RING_BYTES = 200 * 1024;       // the most nbuf * stage_bytes may take

// the 16 signed bytes of v added to the partial column sums col[0..15]
__device__ __forceinline__ void add_columns(int col[16], const uint4 v) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      col[4 * q + b] += static_cast<int>(w[q] << (24 - 8 * b)) >> 24;
}

// Merge the block's XOR words, and when `sliver` its column sums, into out.
// A thread's 16-byte pieces always cover the columns 16 (lane % 8) ..
// 16 (lane % 8) + 15: pieces are 16 bytes, rows 128, and every piece index
// a thread touches is congruent to threadIdx.x mod 8. `sliver` is uniform
// over the block.
__device__ __forceinline__ void merge_block(int* out, unsigned acc, int col[16], bool sliver) {
  __shared__ int s_col[LANES];
  __shared__ unsigned s_xor[THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x < LANES) s_col[threadIdx.x] = 0;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc ^= __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) s_xor[warp] = acc;
  if (sliver) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      col[j] += __shfl_xor_sync(0xffffffffu, col[j], 8);
      col[j] += __shfl_xor_sync(0xffffffffu, col[j], 16);
    }
  }
  __syncthreads();
  if (sliver && lane < 8) {
#pragma unroll
    for (int j = 0; j < 16; ++j) atomicAdd(&s_col[16 * lane + j], col[j]);
  }
  __syncthreads();
  if (sliver && threadIdx.x < LANES) atomicAdd(&out[threadIdx.x], s_col[threadIdx.x]);
  if (threadIdx.x == 0) {
    unsigned x = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) x ^= s_xor[w];
    atomicXor(reinterpret_cast<unsigned*>(out + LANES), x);
  }
}

// ---- P1: a grid over chunks x parts, through registers ------------------ //
__global__ void __launch_bounds__(THREADS)
    probe_auto_kernel(const unsigned char* __restrict__ x, int* __restrict__ out,
                      long long chunk_bytes, int parts) {
  const long long chunk = blockIdx.x / parts;
  const int part = blockIdx.x % parts;
  const long long begin = static_cast<long long>(part) * PART;
  const long long end = min(begin + PART, chunk_bytes);
  const unsigned char* base = x + chunk * chunk_bytes;
  const bool sliver = part == 0;  // a chunk's first 8 KB lie in its first part
  unsigned acc = 0;
  int col[16] = {};
  for (long long pass = begin; pass < end; pass += PASS) {
    uint4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long o = pass + static_cast<long long>(u * THREADS + threadIdx.x) * 16;
      v[u] = o < end ? __ldcs(reinterpret_cast<const uint4*>(base + o)) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      acc ^= v[u].x ^ v[u].y ^ v[u].z ^ v[u].w;
      if (sliver && pass + (u * THREADS + threadIdx.x) * 16 < SLIVER_BYTES) add_columns(col, v[u]);
    }
  }
  merge_block(out, acc, col, sliver);
}

// ---- P2: persistent rings ----------------------------------------------- //
// One stage read back from shared memory: every word into the XOR, and the
// pieces before chunk offset 8 KB (off is the stage's offset in its chunk)
// into the column sums.
__device__ __forceinline__ void consume(const unsigned char* stage, int pieces, long long off,
                                        unsigned& acc, int col[16]) {
  const uint4* s = reinterpret_cast<const uint4*>(stage);
  const int sliver_pieces =
      off < SLIVER_BYTES ? min(pieces, static_cast<int>(SLIVER_BYTES - off) / 16) : 0;
#pragma unroll 4
  for (int p = threadIdx.x; p < pieces; p += THREADS) {
    const uint4 v = s[p];
    acc ^= v.x ^ v.y ^ v.z ^ v.w;
    if (p < sliver_pieces) add_columns(col, v);
  }
}

// this block's share of the stages: [s0, s0 + n)
__device__ __forceinline__ void block_share(long long n_stages, long long& s0, int& n) {
  s0 = n_stages * blockIdx.x / gridDim.x;
  n = static_cast<int>(n_stages * (blockIdx.x + 1) / gridDim.x - s0);
}

template <int NBUF>
__global__ void __launch_bounds__(THREADS)
    probe_ring_cp_kernel(const unsigned char* __restrict__ x, int* __restrict__ out,
                         long long n_stages, int stage_bytes, long long chunk_bytes) {
  extern __shared__ __align__(128) unsigned char ring[];
  long long s0;
  int n;
  block_share(n_stages, s0, n);
  const int pieces = stage_bytes / 16;
  auto issue = [&](int i) {
    const unsigned char* src = x + (s0 + i) * stage_bytes;
    unsigned char* dst = ring + (i % NBUF) * stage_bytes;
    for (int p = threadIdx.x; p < pieces; p += THREADS)
      cp_async16(dst + 16 * p, src + 16 * p, true);
  };
  // prologue: at most NBUF stages, one commit group each (empty past n, so
  // that group i always holds stage i)
#pragma unroll
  for (int i = 0; i < NBUF; ++i) {
    if (i < n) issue(i);
    cp_async_commit();
  }
  unsigned acc = 0;
  int col[16] = {};
  for (int i = 0; i < n; ++i) {
    cp_async_wait<NBUF - 1>();  // this thread's copies of stage i have landed
    __syncthreads();            // and every other thread's
    consume(ring + (i % NBUF) * stage_bytes, pieces, ((s0 + i) * stage_bytes) % chunk_bytes, acc,
            col);
    __syncthreads();            // every thread is done with the slot
    if (i + NBUF < n) issue(i + NBUF);
    cp_async_commit();
  }
  merge_block(out, acc, col, true);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// wait for the completion of the barrier's phase of this parity; a wait of
// over 2^35 clocks (~17 s) traps, so a lost copy fails the launch instead of
// hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const long long start = clock64();
  unsigned done = 0;
  while (!done) {
    if (clock64() - start > (1LL << 35)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// one 1-D bulk copy global -> shared whose completion is counted, in
// bytes, on bar; dst, src and bytes are multiples of 16
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

template <int NBUF>
__global__ void __launch_bounds__(THREADS)
    probe_ring_tma_kernel(const unsigned char* __restrict__ x, int* __restrict__ out,
                          long long n_stages, int stage_bytes, long long chunk_bytes) {
  extern __shared__ __align__(128) unsigned char ring[];
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + NBUF * stage_bytes);  // one per slot
  long long s0;
  int n;
  block_share(n_stages, s0, n);
  // stage i goes to slot i % NBUF; its barrier's phase i / NBUF completes
  // when the copy's stage_bytes have landed (the issuer's one arrival plus
  // the transaction count)
  auto issue = [&](int i) {
    uint64_t* bar = full + i % NBUF;
    mbar_expect_tx(bar, stage_bytes);
    bulk_copy(ring + (i % NBUF) * stage_bytes, x + (s0 + i) * stage_bytes, stage_bytes, bar);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < NBUF; ++s) mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 0; i < min(NBUF, n); ++i) issue(i);
  }
  unsigned acc = 0;
  int col[16] = {};
  for (int i = 0; i < n; ++i) {
    mbar_wait(full + i % NBUF, (i / NBUF) & 1);
    consume(ring + (i % NBUF) * stage_bytes, stage_bytes / 16,
            ((s0 + i) * stage_bytes) % chunk_bytes, acc, col);
    __syncthreads();  // every thread has released the slot (and passed its wait)
    if (threadIdx.x == 0 && i + NBUF < n) issue(i + NBUF);
  }
  merge_block(out, acc, col, true);
}

bool geometry_ok(long long rows, int chunk_rows) {
  return rows > 0 && chunk_rows > 0 && static_cast<long long>(chunk_rows) * LANES >= SLIVER_BYTES &&
         rows % chunk_rows == 0;
}

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int>(e);
}

template <int NBUF, bool TMA>
int launch_ring(const void* x, void* out, long long rows, int chunk_rows, int stage_bytes,
                cudaStream_t stream) {
  const long long chunk_bytes = static_cast<long long>(chunk_rows) * LANES;
  if (!geometry_ok(rows, chunk_rows) || stage_bytes < LANES || stage_bytes % LANES ||
      chunk_bytes % stage_bytes || NBUF * stage_bytes > RING_BYTES)
    return static_cast<int>(cudaErrorInvalidValue);
  using Kernel = void (*)(const unsigned char*, int*, long long, int, long long);
  const Kernel kernel = TMA ? static_cast<Kernel>(probe_ring_tma_kernel<NBUF>)
                            : static_cast<Kernel>(probe_ring_cp_kernel<NBUF>);
  static int sms = 0;
  static bool configured = false;
  if (!configured) {
    int e = sm_count(&sms);
    if (e) return e;
    e = static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              RING_BYTES + NBUF * 8));
    if (e) return e;
    configured = true;
  }
  const long long n_stages = rows * LANES / stage_bytes;
  const int grid = static_cast<int>(std::min<long long>(sms, n_stages));
  const size_t smem = static_cast<size_t>(NBUF) * stage_bytes + (TMA ? NBUF * 8 : 0);
  kernel<<<grid, THREADS, smem, stream>>>(static_cast<const unsigned char*>(x),
                                          static_cast<int*>(out), n_stages, stage_bytes,
                                          chunk_bytes);
  return static_cast<int>(cudaGetLastError());
}

template <bool TMA>
int ring(const void* x, void* out, long long rows, int chunk_rows, int nbuf, int stage_bytes,
         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nbuf) {
    case 2: return launch_ring<2, TMA>(x, out, rows, chunk_rows, stage_bytes, st);
    case 4: return launch_ring<4, TMA>(x, out, rows, chunk_rows, stage_bytes, st);
    case 8: return launch_ring<8, TMA>(x, out, rows, chunk_rows, stage_bytes, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x [rows, 128] int8, 16-byte aligned, rows a multiple of chunk_rows and
// chunk_rows >= 64; out int32 [129], zeroed by the caller.
extern "C" int probe_auto(const void* x, void* out, long long rows, int chunk_rows,
                          void* stream) {
  if (!geometry_ok(rows, chunk_rows)) return static_cast<int>(cudaErrorInvalidValue);
  const long long chunk_bytes = static_cast<long long>(chunk_rows) * LANES;
  const int parts = static_cast<int>((chunk_bytes + PART - 1) / PART);
  const long long blocks = rows / chunk_rows * parts;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  probe_auto_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(
      static_cast<const unsigned char*>(x), static_cast<int*>(out), chunk_bytes, parts);
  return static_cast<int>(cudaGetLastError());
}

// As probe_auto, plus nbuf in {2, 4, 8} and stage_bytes a multiple of 128
// (whole rows) dividing the chunk, with nbuf * stage_bytes <= 200 KB.
extern "C" int probe_ring_cp(const void* x, void* out, long long rows, int chunk_rows, int nbuf,
                             int stage_bytes, void* stream) {
  return ring<false>(x, out, rows, chunk_rows, nbuf, stage_bytes, stream);
}

extern "C" int probe_ring_tma(const void* x, void* out, long long rows, int chunk_rows, int nbuf,
                              int stage_bytes, void* stream) {
  return ring<true>(x, out, rows, chunk_rows, nbuf, stage_bytes, stream);
}
