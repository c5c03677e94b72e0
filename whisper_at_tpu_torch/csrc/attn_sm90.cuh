// Encoder self-attention on Hopper (sm_90a): the kernel behind K1
// (enc_attention.cu) and K7 (enc_flash.cu).
//
// out = softmax(q k^T * scale) v per head, non-causal, over q, k, v and out
// [B, T, H*64] bf16: fp32 scores and softmax with a real running max, P
// rounded to bf16 for the value product (fp32 accumulate), the output
// normalised in fp32 and rounded to bf16 once. Keys at t >= T are masked
// (-inf); query rows at t >= T are not stored.
//
// Grid: one CTA per (query tile of BQ = 192 rows, head, batch row), the
// query tile fastest, so the CTAs of one head run together and share its
// K/V in L2. A CTA is NC = 3 consumer warpgroups and one producer
// warpgroup (the last). ptxas compiles every path within the launch-bounds
// cap, 64K / 512 = 128 registers a thread; at run time setmaxnreg takes the
// producer down to 24 and gives each consumer 160. run() holds the compiled
// count to those 128 at its first call: with fewer, setmaxnreg.inc would
// wait for registers the block never got and hang, so it returns
// REGS_ERROR + the count instead of launching. Shared memory is addressed
// by 32-bit shared-window addresses throughout (descriptors, barriers,
// copies, the epilogue's stores), so no 64-bit pointer stays live in a
// consumer.
//   Producer: one thread issues TMA copies through 3-D tensor maps of
//     [B, T, H*64] (box {64, rows, 1} at {h*64, t, b}, 128-byte swizzle: a
//     64-wide bf16 row is one swizzle span). The map's T dimension makes
//     rows past T read as zeros, never as the next batch row's. Q is copied
//     once; K and V tiles of BKV = 128 keys go into a ring of STAGES = 2
//     stages, each guarded by mbarriers: k_full / v_full (the tile's bytes
//     have landed) and kv_empty (every consumer thread is done with it).
//   Consumers: each owns 64 query rows and runs both products on wgmma:
//     S = Q K^T  m64n128k16, Q and K K-major in shared memory, 4 k-steps;
//     O += P V   m64n64k16, P from registers (the S accumulator packed to
//                bf16 pairs is the A fragment layout), V the B operand
//                MN-major with the transpose bit, 8 k-steps: no
//                transposing copy and no ldmatrix.
//     Softmax: scale * log2(e) folded into one FFMA a score before
//     ex2.approx; row max and sum reduce over the 4 threads of a quad; only
//     the last key tile carries the mask (zero-filled keys score 0, not
//     -inf). It runs between a warpgroup's two products, and the three
//     warpgroups overlap one another's softmax and products. Issuing tile
//     j's S product ahead of tile j-1's P V, so that a warpgroup's own
//     softmax hides behind its products (FlashAttention-3), needs S, P and
//     O live together, 128 registers a thread before any other value:
//     ptxas, held to 128, serialises the products (C7512), so that
//     schedule is not used (PERF.md).
//   Epilogue: each warpgroup writes its O rows into its own Q tile in
//     shared memory (the same swizzle) and one thread stores them with a
//     TMA copy, which clips the rows past T.
// Three consumer warpgroups and two stages took the least time of two or
// three warpgroups and two to four stages at large-v1 batch 24 (PERF.md).
//
// What bounds it on the H100: 4*B*H*T*T*64 FLOP, 2.8e11 at large-v1 batch
// 24 (0.28 ms at 989 TFLOP/s), against ~0.37 GB of q/k/v/out (0.11 ms):
// operations. Beside that bound, one ex2 a score: B*H*T*T = 1.08e9 at 16 a
// clock on each of 132 SMs is ~0.26 ms at 1.98 GHz, as long as the two
// products, so the softmax has to overlap the tensor cores.
//
// The tensor maps are encoded on the host per call (hopper.cuh, the
// copy engine's helpers shared with K10); a map that does not encode
// returns ENCODE_ERROR + the CUresult.
#pragma once

#include "hopper.cuh"

// Everything here has internal linkage: each kernel library (K1's, K7's)
// holds its own copy, and a static of one (run's `configured`) is never
// bound to the other's.
namespace attn_sm90 {
namespace {

constexpr int DH = 64;                  // head width
constexpr int ROW = DH * 2;             // bytes of a row: one 128-byte swizzle span
constexpr int BKV = 128;                // keys per tile
constexpr int WG_ROWS = 64;             // query rows of a consumer warpgroup
constexpr int WG_TILE = WG_ROWS * ROW;  // 8 KB
constexpr int KV_TILE = BKV * ROW;      // 16 KB
constexpr int REGS_ERROR = 20000;

constexpr int NC = 3;                   // consumer warpgroups
constexpr int STAGES = 2;               // K/V stages of the ring
constexpr int BQ = WG_ROWS * NC;        // query rows of a CTA
constexpr int THREADS = 128 * (NC + 1);
constexpr int BARRIERS = 1 + 3 * STAGES;
// 1024 bytes of slack to align the tiles to the swizzle's 1024-byte period
constexpr int SMEM = 1024 + NC * WG_TILE + 2 * STAGES * KV_TILE + 8 * BARRIERS;
// a thread's registers at launch (the launch-bounds cap, which ptxas
// takes with setmaxnreg); setmaxnreg.inc may give the consumers only what
// the producer's .dec frees
constexpr int ENTRY_REGS = (65536 / THREADS) / 8 * 8;
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = ((ENTRY_REGS * (NC + 1) - PRODUCER_REGS) / NC) / 8 * 8;
static_assert(CONSUMER_REGS <= 256, "setmaxnreg takes at most 256");

// ---- wgmma: the RS product (the descriptors, fences and the SS product
// are hopper.cuh's) ------------------------------------------------------- //
// D[64 x 64] += A[64 x 16] B[16 x 64], A in registers (four bf16 pairs a
// thread), B MN-major in shared memory (the transpose bit set; descriptor
// low word b_lo)
__device__ __forceinline__ void wgmma_rs_m64n64_tb(float (&d)[32], const uint32_t (&a)[4],
                                                    uint32_t b_lo) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 db;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "cvt.u64.u32 db, %36; or.b64 db, db, 0x4000004000000000;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, db, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b_lo), "r"(1));
}

// S = Q K^T over the 64 head columns: 4 k-steps of 16 (32 bytes)
__device__ __forceinline__ void issue_s(float (&s)[64], uint32_t q, uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss_m64n128(s, desc_lo(q + 32 * kk), desc_lo(k + 32 * kk), kk);
}

// O += P V over the 128 keys: 8 k-steps of 16 keys (2048 bytes of V)
__device__ __forceinline__ void issue_pv(float (&o)[32], const uint32_t (&p)[8][4], uint32_t v) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) wgmma_rs_m64n64_tb(o, p[kk], desc_lo(v + 2048 * kk));
}

// ---- softmax ---------------------------------------------------------------- //
// The accumulator layout of m64nNk16 (fp32): thread `lane` of warp w of the
// warpgroup holds, for each 8-column block j, s[4j], s[4j+1] at row
// 16w + lane/4, columns 8j + 2(lane%4) + {0, 1}, and s[4j+2], s[4j+3] at
// row 16w + lane/4 + 8, the same columns.

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One key tile of the online softmax. s holds this thread's raw scores (2
// rows x 32 keys, its first key key0); keys >= T are masked when `ragged`.
// m (running max, in units of scale*log2(e)) and l (this thread's share of
// the row sums) are updated; s is left holding exp2(s*sl2 - m) and c the
// factor that rescales the earlier sums and output.
__device__ __forceinline__ void softmax_tile(float (&s)[64], int key0, int T, bool ragged,
                                             float sl2, float (&m)[2], float (&l)[2],
                                             float (&c)[2]) {
  if (ragged) {
#pragma unroll
    for (int i = 0; i < 64; ++i)
      if (key0 + 8 * (i >> 2) + (i & 1) >= T) s[i] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // the four threads of a quad share a row; every tile holds a valid key,
    // so the new max is finite
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float mn = fmaxf(m[r], mx[r] * sl2);
    c[r] = ex2(m[r] - mn);
    m[r] = mn;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = ex2(fmaf(s[i], sl2, -m[r]));
    sum[r] += s[i];
  }
  l[0] = l[0] * c[0] + sum[0];
  l[1] = l[1] * c[1] + sum[1];
}

// P in bf16 as the A fragments of the 8 k-steps of P V: k-step kk covers
// the 8-column blocks 2kk and 2kk+1 of s
__device__ __forceinline__ void pack_p(const float (&s)[64], uint32_t (&p)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) p[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

__device__ __forceinline__ void rescale(float (&o)[32], const float (&c)[2]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] *= c[(i >> 1) & 1];
}

// ---- the kernel --------------------------------------------------------------- //
// The CTA's shared memory, by 32-bit shared-window address: NC Q tiles of
// 64 rows, STAGES K tiles and STAGES V tiles of 128 rows, then the
// barriers (q_full; k_full, v_full and kv_empty per stage).
struct Ring {
  uint32_t q, k, v, bars;
  __device__ __forceinline__ uint32_t k_tile(int st) const { return k + st * KV_TILE; }
  __device__ __forceinline__ uint32_t v_tile(int st) const { return v + st * KV_TILE; }
  __device__ __forceinline__ uint32_t q_full() const { return bars; }
  __device__ __forceinline__ uint32_t k_full(int st) const { return bars + 8 * (1 + st); }
  __device__ __forceinline__ uint32_t v_full(int st) const {
    return bars + 8 * (1 + STAGES + st);
  }
  __device__ __forceinline__ uint32_t kv_empty(int st) const {
    return bars + 8 * (1 + 2 * STAGES + st);
  }
};

// One consumer warpgroup: rows row0 .. row0+63 of the query tile, whose Q
// lies at qw.
__device__ __forceinline__ void consume(const Ring& r, uint32_t qw, const CUtensorMap* omap,
                                        int T, float sl2, int h, int row0, int b, int wg) {
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, quad = lane & 3;
  const int n_tiles = (T + BKV - 1) / BKV;
  float s[64], o[32];
  uint32_t p[8][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, c[2];
  warp_wait(r.q_full(), 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % STAGES;
    const uint32_t ph = (j / STAGES) & 1;
    warp_wait(r.k_full(st), ph);
    wgmma_fence();
    issue_s(s, qw, r.k_tile(st));
    wgmma_commit();
    wgmma_wait<0>();
    hold(s);
    softmax_tile(s, j * BKV + 2 * quad, T, (j + 1) * BKV > T, sl2, m, l, c);
    rescale(o, c);
    pack_p(s, p);
    warp_wait(r.v_full(st), ph);
    wgmma_fence();
    issue_pv(o, p, r.v_tile(st));
    wgmma_commit();
    wgmma_wait<0>();
    hold(o);
    mbar_arrive(r.kv_empty(st));
  }

  // normalise, write O into this warpgroup's Q tile in the 128-byte swizzle
  // (16-byte chunk index XOR row % 8), and store it with one TMA copy
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.f / l[i];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = warp * 16 + (lane >> 2) + 8 * i;
      st_shared(qw + row * ROW + ((j ^ (row & 7)) << 4) + quad * 4,
                pack_bf16(o[4 * j + 2 * i] * inv[i], o[4 * j + 2 * i + 1] * inv[i]));
    }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  if (tid == 0) tma_store(omap, qw, h * DH, row0, b);
}

__global__ void __launch_bounds__(THREADS, 1)
    attn_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap omap,
                int T, float sl2) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  Ring r;
  r.q = (raw + 1023) & ~1023u;  // 1024-aligned: the 128-byte swizzle's period
  r.k = r.q + NC * WG_TILE;
  r.v = r.k + STAGES * KV_TILE;
  r.bars = r.v + STAGES * KV_TILE;

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  // consumer warpgroups with rows below T (fewer than NC only in a last,
  // short query tile)
  const int live = min(NC, (T - q0 + WG_ROWS - 1) / WG_ROWS);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(r.q_full(), 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(r.k_full(st), 1);
      mbar_init(r.v_full(st), 1);
      mbar_init(r.kv_empty(st), live * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == NC) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == NC * 128) {
      const int n_tiles = (T + BKV - 1) / BKV;
      mbar_expect_tx(r.q_full(), live * WG_TILE);
      for (int w = 0; w < live; ++w)
        tma_load(r.q + w * WG_TILE, &qmap, h * DH, q0 + w * WG_ROWS, b, r.q_full());
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % STAGES;
        // stage st's previous tile (j - STAGES) released by every consumer
        if (j >= STAGES) mbar_wait(r.kv_empty(st), ((j / STAGES) & 1) ^ 1);
        mbar_expect_tx(r.k_full(st), KV_TILE);
        tma_load(r.k_tile(st), &kmap, h * DH, j * BKV, b, r.k_full(st));
        mbar_expect_tx(r.v_full(st), KV_TILE);
        tma_load(r.v_tile(st), &vmap, h * DH, j * BKV, b, r.v_full(st));
      }
    }
  } else if (wg < live) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    consume(r, r.q + wg * WG_TILE, &omap, T, sl2, h, q0 + wg * WG_ROWS, b, wg);
  }
}

// ---- host ------------------------------------------------------------------- //
// the 3-D map of x [B, T, H*64] bf16 (innermost first) whose box is
// {64, rows, 1}; 0, or ENCODE_ERROR + the CUresult
inline int encode_map(EncodeTiled fn, CUtensorMap* map, const void* x, int B, int T, int H,
                      int rows) {
  return encode_3d(fn, map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, H * DH, T, B, DH, rows,
                   CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B);
}

// q, k, v, out: contiguous, 16-byte aligned [B, T, H*64] bf16
inline int run(const void* q, const void* k, const void* v, void* out, int B, int T, int H,
               float scale, void* stream) {
  static bool configured = false;
  if (!configured) {
    // the register count ptxas compiled is what setmaxnreg's arithmetic
    // takes (ENTRY_REGS); a block that starts with fewer would hang
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, attn_kernel);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (attr.numRegs != ENTRY_REGS) return REGS_ERROR + attr.numRegs;
    e = cudaFuncSetAttribute(attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  EncodeTiled fn;
  const cudaError_t e = encode_function(&fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap qm, km, vm, om;
  int rc = encode_map(fn, &qm, q, B, T, H, WG_ROWS);
  if (rc == 0) rc = encode_map(fn, &km, k, B, T, H, BKV);
  if (rc == 0) rc = encode_map(fn, &vm, v, B, T, H, BKV);
  if (rc == 0) rc = encode_map(fn, &om, out, B, T, H, WG_ROWS);
  if (rc != 0) return rc;
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  attn_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      qm, km, vm, om, T, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace attn_sm90
