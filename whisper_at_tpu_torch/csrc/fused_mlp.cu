// K8: the decode step's MLP,
//   out [M, D] = fc2(gelu(fc1(x))),  x [M, D] bf16, hidden F = 4D, M <= 256,
// with bf16 weights or int8 weights and per-output-channel fp32 scales
// (the port's Linear / QuantLinear, [out, in]), in the TPU kernel's
// rounding: h = x W1^T (* s1) + b1 in fp32, exact GELU in fp32 (erff),
// rounded to bf16; the fc2 products summed in fp32, (* s2), b2 added last.
//
// Replaces whisper_at_tpu/ops/fused_mlp.py::fused_mlp (Pallas, TPU; bf16
// and int8 entries), whose grid walks the hidden axis in order on one core
// and accumulates the output in VMEM. Its Abramowitz-Stegun erf exists
// because Mosaic has no erf and is not carried over.
//
// What bounds it on the H100: the bytes, and the latency of getting them
// moving. At large-v1 (D 1280, F 5120) and M = 24 the int8 weights are
// 13.1 MB (~0.0039 ms at 3.35 TB/s; bf16 weights 26.2 MB, ~0.0078 ms) for
// 0.63 GFLOP (~0.0006 ms at 989 TFLOP/s). The decode loop meets each
// layer's pair cold, after the other 31 layers' pairs have passed through
// the 50 MB L2. Streaming near the rate needs the whole card's SMs loading
// and ~3-5 MB in flight.
//
// Design: two launches of one product template, out[M, N] = epi(A[M, K]
// W[N, K]^T), fc1 (A = x, N = F, epilogue scale, bias, GELU, bf16 h) then
// fc2 (A = h, N = D, epilogue scale, bias, bf16 out). h [M, F] bf16 (245 KB
// at M = 24) is the only intermediate, written once and read from L2; there
// is no fp32 scratch.
//  - Grid: blocks of `bn` weight rows (1 to 5 strips of 16) and a share of
//    K, K split over a thread-block cluster of `split` blocks (grid y), at
//    most one wave of the card (ops/fused_mlp.py: `plan`; at large-v1,
//    M = 24: fc1 80 rows x 2, fc2 80 rows x 8, 128 blocks each). Every
//    weight byte is read from HBM once, at any M; each block reads its A
//    slice [M, K / split] once, all M rows in each stage.
//  - One producer lane streams the block's weight and A through a ring of
//    `stages` stages of KC = 64 columns of K (TMA through 3-D tensor maps:
//    the weight box [bn][64] in the 64-byte (int8) or 128-byte (bf16)
//    swizzle, the A box [M rounded to 8][64] bf16 in the 128-byte swizzle),
//    each stage with a full and an empty barrier; it initialises the
//    barriers and issues the first stages itself, the tensor maps
//    prefetched, before the block's first __syncthreads.
//  - fc2 is launched with programmatic dependent launch: fc1's blocks let
//    it start at once, its blocks take the SM room fc1 leaves (plan keeps
//    each block within half an SM's shared memory where the ring still
//    holds four stages), its producer issues the first stages' W2 boxes,
//    then waits for fc1's grid (griddepcontrol.wait) before the h boxes. So
//    W2 streams while fc1 runs and the two launches cost one stream.
//  - Products on wgmma m64n{bn}k16 (bf16, fp32 sums; bn = 16 to 80, a
//    template parameter), one a 16-deep k-step and 64-row tile of A, both
//    operands K-major in shared memory: A straight from its TMA box (rows
//    past the box are read from the pad after it and their sums dropped),
//    the weight from its box (bf16) or, for int8, from a bf16 copy that the
//    warpgroup widens from the box once a stage (exact: codes.cuh, pairs8)
//    into the 128-byte swizzle. Two consumer warpgroups: up to 64 rows they take the stages
//    in turn, each with sums of every tile, added in order at the end;
//    above, each takes its own 64-row tiles. On mma.sync m16n8k16, and on
//    wgmma with one m64n16k16 a strip, the products' issue, not the bytes,
//    bounded this kernel at every M (PERF.md section 6).
//  - K split: the blocks of a cluster add their partial tiles in rank
//    order: each pushes its partials, two columns at a time, by st.async
//    into the shared memory of the block that owns those columns (bn /
//    split a block), completing on that block's barrier; the owner adds
//    the split partials in rank order and runs the epilogue, with the
//    scales and biases it fetched while the first stages streamed in.
//    Deterministic: no float atomics, one order of summation, the same
//    bits every run.
#include "codes.cuh"
#include "hopper.cuh"

namespace {

constexpr int NWG = 2;                   // consumer warpgroups
constexpr int CONSUMERS = 128 * NWG;
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int KC = 64;                   // K of a stage: one 128-byte swizzle span of bf16
constexpr int MAX_STRIPS = 5;            // 16-row strips of a block's weight rows (BN <= 80)
constexpr int MAX_SPLIT = 8;             // blocks of a cluster (portable limit)
constexpr int MAX_ROWS = 256;
constexpr int MAX_STAGES = 16;
constexpr int MAX_SMEM = 227 * 1024;
constexpr int FC1 = 1, FC2 = 2;          // roles: fc1 lets fc2 start, fc2 waits for fc1's h

// one product out[M, N] = epi(A[M, K] W[N, K]^T) and its tiling
struct Gemm {
  const float* scale;  // per output channel (int8 weights), else null
  const bf16* bias;
  bf16* out;
  int M, N, K, bn, split, stages, kgroups, gelu;
};

__host__ __device__ inline int round8(int m) { return (m + 7) & ~7; }
__host__ __device__ inline int round64(int m) { return (m + 63) & ~63; }

// byte offsets in dynamic shared memory, after its start is aligned to
// 1024: the ring (each stage the weight box, then the A box of M rounded
// to 8 rows), padded so that the last stage's 64-row A tiles stay inside
// it (rows past the box are read and their sums dropped), which the
// groups' partial tiles [kgroups][M][bn + 4] fp32 take over once drained;
// int8: a bf16 copy of a stage's weight box for each consumer warpgroup;
// the partials the cluster pushes here [split][M][bn / split] fp32; the
// block's scales [bn] fp32 and biases [bn] bf16; the barriers full,
// empty, recv
struct Layout {
  int wbytes, abytes, stage, conv, recv, params, bar, bytes;
};

template <bool Q>
__host__ __device__ inline Layout layout(const Gemm& p) {
  Layout l;
  l.wbytes = p.bn * KC * (Q ? 1 : 2);
  l.abytes = round8(p.M) * KC * 2;
  l.stage = l.wbytes + l.abytes;
  const int ring = p.stages * l.stage + (round64(p.M) - round8(p.M)) * KC * 2;
  const int red = p.kgroups * p.M * (p.bn + 4) * 4;
  l.conv = ((ring > red ? ring : red) + 1023) & ~1023;
  l.recv = l.conv + (Q ? NWG * p.bn * KC * 2 : 0);
  l.params = l.recv + (p.split > 1 ? p.M * p.bn * 4 : 0);
  l.bar = (l.params + p.bn * 6 + 7) & ~7;
  l.bytes = 1024 + l.bar + 8 * (2 * p.stages + 1);
  return l;
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// D[64 x BN] += A[64 x 16] B[16 x BN]: A (64 rows of x or h) and B (BN
// weight rows) K-major in shared memory, 128-byte swizzle (descriptor low
// words a_lo, b_lo; hopper.cuh's DESC_HI); D is wgmma's fragment, d[4j + q]
// at row 16 (warp % 4) + g + 8 (q >> 1), column 8j + 2t + (q & 1)
template <int BN>
__device__ __forceinline__ void wgmma_bn(float (&d)[BN / 2], uint32_t a_lo, uint32_t b_lo);

template <>
__device__ __forceinline__ void wgmma_bn<16>(float (&d)[8], uint32_t a_lo, uint32_t b_lo) {
  asm volatile(
      "{\n.reg .b64 da, db;\n"
      "cvt.u64.u32 da, %8; or.b64 da, da, 0x4000004000000000;\n"
      "cvt.u64.u32 db, %9; or.b64 db, db, 0x4000004000000000;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, da, db, 1, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a_lo), "r"(b_lo));
}

template <>
__device__ __forceinline__ void wgmma_bn<32>(float (&d)[16], uint32_t a_lo, uint32_t b_lo) {
  asm volatile(
      "{\n.reg .b64 da, db;\n"
      "cvt.u64.u32 da, %16; or.b64 da, da, 0x4000004000000000;\n"
      "cvt.u64.u32 db, %17; or.b64 db, db, 0x4000004000000000;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      " %10, %11, %12, %13, %14, %15}, da, db, 1, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a_lo), "r"(b_lo));
}

template <>
__device__ __forceinline__ void wgmma_bn<48>(float (&d)[24], uint32_t a_lo, uint32_t b_lo) {
  asm volatile(
      "{\n.reg .b64 da, db;\n"
      "cvt.u64.u32 da, %24; or.b64 da, da, 0x4000004000000000;\n"
      "cvt.u64.u32 db, %25; or.b64 db, db, 0x4000004000000000;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      " %10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      " %20, %21, %22, %23}, da, db, 1, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a_lo), "r"(b_lo));
}

template <>
__device__ __forceinline__ void wgmma_bn<64>(float (&d)[32], uint32_t a_lo, uint32_t b_lo) {
  asm volatile(
      "{\n.reg .b64 da, db;\n"
      "cvt.u64.u32 da, %32; or.b64 da, da, 0x4000004000000000;\n"
      "cvt.u64.u32 db, %33; or.b64 db, db, 0x4000004000000000;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      " %10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      " %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31}, da, db, 1, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a_lo), "r"(b_lo));
}

template <>
__device__ __forceinline__ void wgmma_bn<80>(float (&d)[40], uint32_t a_lo, uint32_t b_lo) {
  asm volatile(
      "{\n.reg .b64 da, db;\n"
      "cvt.u64.u32 da, %40; or.b64 da, da, 0x4000004000000000;\n"
      "cvt.u64.u32 db, %41; or.b64 db, db, 0x4000004000000000;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      " %10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      " %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, da, db, 1, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a_lo), "r"(b_lo));
}

// a stage's int8 weight box (bn rows of 64 codes, 64-byte swizzle) as bf16
// rows of 128 bytes in the 128-byte swizzle, wgmma's K-major B operand; by
// the 128 threads of a warpgroup, exactly (codes.cuh)
__device__ __forceinline__ void widen_box(const unsigned char* src, unsigned char* dst, int bn,
                                         int tid) {
  for (int e = tid; e < bn * 4; e += 128) {
    const int n = e >> 2, u = e & 3;  // row, 16-code unit
    const uint4 w = *reinterpret_cast<const uint4*>(src + n * 64 + 16 * (u ^ ((n >> 1) & 3)));
    uint4 lo, hi;
    pairs8(w.x, lo.x, lo.y);
    pairs8(w.y, lo.z, lo.w);
    pairs8(w.z, hi.x, hi.y);
    pairs8(w.w, hi.z, hi.w);
    unsigned char* row = dst + n * 128;
    *reinterpret_cast<uint4*>(row + 16 * ((2 * u) ^ (n & 7))) = lo;
    *reinterpret_cast<uint4*>(row + 16 * ((2 * u + 1) ^ (n & 7))) = hi;
  }
}

// the epilogue of the block's column c (output n0 + c) at row m: (* scale)
// + bias from shared memory, GELU for fc1, to bf16
template <bool Q>
__device__ __forceinline__ void emit(const Gemm& p, const float* sc, const bf16* bi, float s,
                                     int m, int n0, int c) {
  float v = (Q ? s * sc[c] : s) + __bfloat162float(bi[c]);
  if (p.gelu) v = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
  p.out[(size_t)m * p.N + n0 + c] = __float2bfloat16_rn(v);
}

// BN weight rows a block; MTW 64-row tiles of A a warpgroup; KG = 2: both
// warpgroups take every tile (M <= 64), each every other stage; KG = 1:
// warpgroup w the tiles w, w + 2, ... over every stage
template <bool Q, int BN, int MTW, int KG>
__global__ void __launch_bounds__(THREADS, MTW == 1 ? 2 : 1)
    fused_mlp_gemm(const __grid_constant__ CUtensorMap amap,
                   const __grid_constant__ CUtensorMap wmap, const Gemm p, int role) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const Layout L = layout<Q>(p);
  float* sc = reinterpret_cast<float*>(base + L.params);
  bf16* bi = reinterpret_cast<bf16*>(sc + BN);
  const uint32_t full0 = smem_u32(base + L.bar), empty0 = full0 + 8 * p.stages,
                 recv_bar = empty0 + 8 * p.stages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * BN, rank = blockIdx.y;  // the cluster spans grid y
  const int nchunks = p.K / KC, cpb = (nchunks + p.split - 1) / p.split;
  const int c0 = rank * cpb, nc = min(cpb, nchunks - c0);
  const int nl = BN / p.split;  // output columns whose partials this block adds

  if (role == FC1) griddep_launch_dependents();
  if (warp == CONSUMERS / 32) {  // the producer
    if (lane == 0) {
      tma_prefetch_map(&wmap);
      tma_prefetch_map(&amap);
      for (int st = 0; st < p.stages; ++st) {
        mbar_init(full0 + 8 * st, 1);
        mbar_init(empty0 + 8 * st, 4 * NWG / KG);  // every warp that takes the stage
      }
      mbar_init(recv_bar, 1);
      mbar_fence_init();
      if (p.split > 1) mbar_expect_tx(recv_bar, (p.split - 1) * p.M * nl * 4);
      // the first stages' weight boxes need nothing of an earlier grid
      const uint32_t ring = smem_u32(base);
      const int first = min(nc, p.stages);
      for (int j = 0; j < first; ++j) {
        mbar_expect_tx(full0 + 8 * j, L.stage);
        tma_load(ring + j * L.stage, &wmap, (c0 + j) * KC, n0, 0, full0 + 8 * j);
      }
      if (role == FC2) griddep_wait();  // h is fc1's output
      for (int j = 0; j < first; ++j)
        tma_load(ring + j * L.stage + L.wbytes, &amap, (c0 + j) * KC, 0, 0, full0 + 8 * j);
    }
    __syncthreads();  // the barriers exist before any consumer waits on them
    if (p.split > 1) cluster_arrive();  // and before any block of the cluster writes here
    if (lane == 0) {
      const uint32_t ring = smem_u32(base);
      for (int j = p.stages; j < nc; ++j) {
        const int st = j % p.stages;
        const uint32_t stage = ring + st * L.stage, full = full0 + 8 * st;
        mbar_wait(empty0 + 8 * st, ((j / p.stages) - 1) & 1);  // its last use released
        mbar_expect_tx(full, L.stage);
        tma_load(stage, &wmap, (c0 + j) * KC, n0, 0, full);
        tma_load(stage + L.wbytes, &amap, (c0 + j) * KC, 0, 0, full);
      }
    }
    return;
  }

  // the epilogue's scales and biases, fetched while the first stages stream in
  if (tid < BN) {
    if constexpr (Q) sc[tid] = p.scale[n0 + tid];
    bi[tid] = p.bias[n0 + tid];
  }
  __syncthreads();
  if (p.split > 1) cluster_arrive();

  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, t = lane & 3;
  const int kg = KG == 2 ? wg : 0;
  const int mtiles = round64(p.M) / 64;
  unsigned char* conv = base + L.conv + wg * BN * KC * 2;
  float acc[MTW][BN / 2];
#pragma unroll
  for (int i = 0; i < MTW; ++i)
#pragma unroll
    for (int r = 0; r < BN / 2; ++r) acc[i][r] = 0.f;

  // a warpgroup takes the stages j = kg, kg + KG, ...; stages % KG == 0 (or
  // no stage is reused), so each ring slot has one taker and no warp waits
  // more than one phase ahead of a barrier
#pragma unroll 1
  for (int j = kg; j < nc; j += KG) {
    const int st = j % p.stages;
    const unsigned char* stage = base + st * L.stage;
    warp_wait(full0 + 8 * st, (j / p.stages) & 1);
    uint32_t wsrc = smem_u32(stage);
    if constexpr (Q) {
      named_sync(2 + wg, 128);  // the warpgroup's last products have read conv
      widen_box(stage, conv, BN, tid & 127);
      fence_async_shared();
      named_sync(2 + wg, 128);
      wsrc = smem_u32(conv);
    }
    const uint32_t asrc = smem_u32(stage) + L.wbytes;
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < MTW; ++i) {
      const int mt = KG == 2 ? i : wg + NWG * i;
      if (mt < mtiles) {
#pragma unroll
        for (int kk = 0; kk < KC / 16; ++kk)
          wgmma_bn<BN>(acc[i], desc_lo(asrc + mt * 64 * 128 + 32 * kk), desc_lo(wsrc + 32 * kk));
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < MTW; ++i) hold(acc[i]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * st);
  }

  // the warpgroups' partial tiles into the drained ring: red[kg][m][c], c
  // the block's column; acc[i][4j + q] is row 64 mt + 16 wq + g + 8 (q >> 1),
  // column 8j + 2t + (q & 1)
  constexpr int RS = BN + 4;  // row stride (floats) of red
  float* red = reinterpret_cast<float*>(base);
  consumers_sync();  // every stage is consumed, so every copy has landed
#pragma unroll
  for (int i = 0; i < MTW; ++i) {
    const int m0 = 64 * (KG == 2 ? i : wg + NWG * i) + 16 * wq + g;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (m0 + 8 * h < p.M)
          *reinterpret_cast<float2*>(red + (kg * p.M + m0 + 8 * h) * RS + 8 * j + 2 * t) =
              make_float2(acc[i][4 * j + 2 * h], acc[i][4 * j + 2 * h + 1]);
  }
  consumers_sync();

  // column pairs: the groups' partials added in order; with K split, pushed
  // to the block that owns the columns (st.async, 8 bytes), else emitted.
  // A thread keeps one column pair and walks the rows.
  float* recv = reinterpret_cast<float*>(base + L.recv);
  if (p.split > 1) cluster_wait();  // every block of the cluster has started
  constexpr int HALF = BN / 2, ROW_STEP = CONSUMERS / HALF;
  if (tid < ROW_STEP * HALF) {
    const int c = 2 * (tid % HALF), owner = c / nl;
    const uint32_t remote_bar = p.split > 1 ? map_rank(recv_bar, owner) : 0u;
    float* dst = recv + (size_t)rank * p.M * nl + c - owner * nl;
#pragma unroll 1
    for (int m = tid / HALF; m < p.M; m += ROW_STEP) {
      float2 v = *reinterpret_cast<const float2*>(red + m * RS + c);
      if (KG == 2) {
        const float2 w = *reinterpret_cast<const float2*>(red + (p.M + m) * RS + c);
        v.x += w.x, v.y += w.y;
      }
      if (p.split == 1) {
        emit<Q>(p, sc, bi, v.x, m, n0, c);
        emit<Q>(p, sc, bi, v.y, m, n0, c + 1);
      } else if (owner == rank) {
        *reinterpret_cast<float2*>(dst + m * nl) = v;
      } else {
        st_async2(map_rank(smem_u32(dst + m * nl), owner), v.x, v.y, remote_bar);
      }
    }
  }
  if (p.split == 1) return;

  // the split's partials of this block's columns, added in rank order
  consumers_sync();
  mbar_wait_cluster(recv_bar, 0);
  const int per = p.M * nl, step = CONSUMERS / nl;
  if (tid < step * nl) {
    const int q = tid % nl;
#pragma unroll 1
    for (int m = tid / nl; m < p.M; m += step) {
      float s = recv[m * nl + q];
#pragma unroll 1
      for (int r = 1; r < p.split; ++r) s += recv[r * per + m * nl + q];
      emit<Q>(p, sc, bi, s, m, n0, rank * nl + q);
    }
  }
}

template <bool Q, int BN, int MTW, int KG>
cudaError_t run(const CUtensorMap& am, const CUtensorMap& wm, const Gemm& p, int role,
                cudaStream_t stream) {
  auto kernel = fused_mlp_gemm<Q, BN, MTW, KG>;
  const int smem = layout<Q>(p).bytes;
  static int configured = 0;
  if (smem > configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.N / BN, p.split, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  int n = 0;
  if (p.split > 1) {
    attr[n].id = cudaLaunchAttributeClusterDimension;
    attr[n].val.clusterDim.x = 1, attr[n].val.clusterDim.y = p.split;
    attr[n].val.clusterDim.z = 1;
    ++n;
  }
  if (role == FC2) {
    attr[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[n].val.programmaticStreamSerializationAllowed = 1;
    ++n;
  }
  cfg.attrs = attr;
  cfg.numAttrs = n;
  return cudaLaunchKernelEx(&cfg, kernel, am, wm, p, role);
}

template <bool Q>
bool valid(const Gemm& p) {
  const int nchunks = p.K / KC;
  const int mtiles = round64(p.M) / 64;
  if (p.bn < 16 || p.bn % 16 || p.bn > 16 * MAX_STRIPS || p.N % p.bn || p.split < 1 ||
      p.split > MAX_SPLIT || p.bn % p.split || (p.bn / p.split) % 2 || p.split > nchunks ||
      p.stages < 1 || p.stages > MAX_STAGES || (p.kgroups != 1 && p.kgroups != 2) ||
      (p.kgroups == 2 && mtiles > 1) || layout<Q>(p).bytes > MAX_SMEM)
    return false;
  const int cpb = (nchunks + p.split - 1) / p.split;
  // no block of the cluster without a chunk, no warpgroup without a stage,
  // and a ring slot's stages all taken by one warpgroup
  return nchunks - (p.split - 1) * cpb >= p.kgroups &&
         (p.stages >= cpb || p.stages % p.kgroups == 0);
}

template <bool Q, int BN>
cudaError_t run_width(const CUtensorMap& am, const CUtensorMap& wm, const Gemm& p, int role,
                      cudaStream_t stream) {
  if (p.kgroups == 2) return run<Q, BN, 1, 2>(am, wm, p, role, stream);
  if (round64(p.M) / 64 <= NWG) return run<Q, BN, 1, 1>(am, wm, p, role, stream);
  return run<Q, BN, 2, 1>(am, wm, p, role, stream);
}

template <bool Q>
cudaError_t run_gemm(const CUtensorMap& am, const CUtensorMap& wm, const Gemm& p, int role,
                     cudaStream_t stream) {
  switch (p.bn) {
    case 16: return run_width<Q, 16>(am, wm, p, role, stream);
    case 32: return run_width<Q, 32>(am, wm, p, role, stream);
    case 48: return run_width<Q, 48>(am, wm, p, role, stream);
    case 64: return run_width<Q, 64>(am, wm, p, role, stream);
    default: return run_width<Q, 80>(am, wm, p, role, stream);
  }
}

template <bool Q>
int launch(const void* x, const void* w1, const void* s1, const void* b1, const void* w2,
           const void* s2, const void* b2, void* h, void* out, int M, int D, int F,
           const int* t1, const int* t2, cudaStream_t stream) {
  const Gemm p1{static_cast<const float*>(s1), static_cast<const bf16*>(b1),
                static_cast<bf16*>(h), M, F, D, t1[0], t1[1], t1[2], t1[3], 1};
  const Gemm p2{static_cast<const float*>(s2), static_cast<const bf16*>(b2),
                static_cast<bf16*>(out), M, D, F, t2[0], t2[1], t2[2], t2[3], 0};
  if (M < 1 || M > MAX_ROWS || D < KC || D % KC || F < KC || F % KC || !valid<Q>(p1) ||
      !valid<Q>(p2))
    return static_cast<int>(cudaErrorInvalidValue);
  EncodeTiled fn;
  const cudaError_t e = encode_function(&fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  const CUtensorMapDataType wtype =
      Q ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle wswz = Q ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
  const int esz = Q ? 1 : 2;
  // x [M, D] and h [M, F] bf16, box {64, M rounded to 8} (rows past M read
  // as zeros); W1 [F, D] and W2 [D, F], box {64, bn}
  CUtensorMap xm, w1m, hm, w2m;
  int rc = encode_3d(fn, &xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, D, M, 1, KC, round8(M),
                     CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
  if (rc == 0)
    rc = encode_3d(fn, &w1m, wtype, esz, w1, D, F, 1, KC, p1.bn, wswz,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
  if (rc == 0)
    rc = encode_3d(fn, &hm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, h, F, M, 1, KC, round8(M),
                   CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
  if (rc == 0)
    rc = encode_3d(fn, &w2m, wtype, esz, w2, F, D, 1, KC, p2.bn, wswz,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
  if (rc != 0) return rc;
  cudaError_t err = run_gemm<Q>(xm, w1m, p1, FC1, stream);
  if (err == cudaSuccess) err = run_gemm<Q>(hm, w2m, p2, FC2, stream);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// x [M, D] bf16, 1 <= M <= 256; w1 [F, D], w2 [D, F] bf16; b1 [F], b2 [D]
// bf16; h [M, F] bf16 (fc1's output, written here); out [M, D] bf16. D and F
// multiples of 64. Each product's tiling {bn, split, stages, kgroups} (bn
// rows a block, a multiple of 16 dividing its N; K split over `split` <= 8
// blocks of a cluster; `stages` ring stages; `kgroups` warp groups taking
// the stages in turn) comes from ops/fused_mlp.py's `plan`, fc1's at t1 and
// fc2's at t2; a tiling outside what the kernel takes is refused
// (cudaErrorInvalidValue).
extern "C" int fused_mlp_bf16(const void* x, const void* w1, const void* b1, const void* w2,
                              const void* b2, void* h, void* out, int M, int D, int F,
                              const int* t1, const int* t2, void* stream) {
  return launch<false>(x, w1, nullptr, b1, w2, nullptr, b2, h, out, M, D, F, t1, t2,
                       static_cast<cudaStream_t>(stream));
}

// The int8 entry: w1, w2 int8 with per-output-channel scales s1 [F], s2 [D] fp32.
extern "C" int fused_mlp_int8(const void* x, const void* w1, const void* s1, const void* b1,
                              const void* w2, const void* s2, const void* b2, void* h,
                              void* out, int M, int D, int F, const int* t1, const int* t2,
                              void* stream) {
  return launch<true>(x, w1, s1, b1, w2, s2, b2, h, out, M, D, F, t1, t2,
                      static_cast<cudaStream_t>(stream));
}
