// K4: decode-step cross-attention over int8 or int4 K/V with
// per-(head, position) fp32 scales, an additive pad bias and an exact fp32
// softmax.
//
// Replaces whisper_at_tpu/ops/cross_decode.py::cross_attention_int8 (Pallas,
// TPU). The TPU kernel folds all heads into one block-diagonal matmul to
// dodge the MXU's M = 1 issue cost; that has no reason on Hopper.
//
// What bounds it on the H100: the bytes. At large-v1 batch 24, G = 1, the
// 1500 valid positions' int8 K and V (92 MB) and their scales (5.8 MB)
// need ~0.029 ms at 3.35 TB/s (int4: half the codes, ~0.016 ms); the
// arithmetic is ~1.9e8 FLOP. The decode loop meets each layer's K/V cold.
// At A = 1 (the sequential call) the 20 (head, audio row) pairs would fill
// 20 of 132 SMs, so there the positions are split over a cluster.
//
// Design (hopper.cuh's copy engine, as K10):
//  - A block serves one (head, audio row, run of the positions) and up to
//    GR query rows of that head, every row in one pass over K and V (more
//    rows take further row slices on grid z). The runs (`n_split` of
//    `per_split` stages of CHUNK = 128 or 256 positions) are the blocks of
//    one cluster (grid z, launch attribute), chosen by the wrapper so that
//    the grid fills the card (ops/cross_decode.py: `plan`).
//  - One producer lane issues every copy into one ring of `1 << ring_log2`
//    stages (four, or two where four would leave room for fewer than four
//    blocks an SM): first the run's K stages (codes by TMA through a 3-D
//    tensor map of [A, Ta_pad, H * 64 or 32 bytes], box {64 or 32, CHUNK,
//    1}, in the 64- or 32-byte swizzle; the K scales and the bias by 1-D
//    bulk copies), then its V stages (codes, V scales). Rows past Ta_pad are
//    zero-filled and weigh 0. Each stage has a `full` and an `empty`
//    barrier, so the V stages fill while the consumers finish the logits
//    and the softmax.
//  - Four consumer warps, PW = CHUNK / 4 positions of each stage a warp. K
//    phase: the logits (q . k) * ks + bias in fp32 go to shared memory
//    ([rows][run]), with each thread's running max. The softmax is exact: M
//    is the maximum over all positions, S the sum of expf(l - M), p =
//    expf(l - M) / S (__fdiv_rn), pw = bf16(p * vs). Maxima and sums are
//    reduced by shuffles, across the consumer warps through a named barrier
//    that leaves the producer out, and across the cluster by st.async into
//    every block's shared memory (each block adds the runs' sums in rank
//    order). V phase: out += pw . v over the run; the runs' partial outputs
//    are added in rank order into rank 0, which writes `out`. One launch.
//  - The products run on the tensor cores (TC, mma.sync m16n8k16 bf16 with
//    fp32 sums; K: q [16 rows] x k^T, V: v^T [64 x 16 positions] x pw^T
//    [16 x 8 rows]) for G > 1: one widening of the codes serves every row
//    (on the H100 the CUDA cores took 1.7-2x as long at G = 5). At G = 1
//    they run on the CUDA cores (a lane a position for the logits; 16
//    lanes x 4 columns a V row, two positions at a time), no slower there.
//    Codes widen exactly in registers (codes.cuh): to bf16 pairs for
//    the tensor cores, to fp32 otherwise. The mma operands' k order is free
//    (a sum), so a thread takes 16 contiguous code bytes of its position
//    (K) or 8 of four positions (V), and q and pw are laid out to match.
// Measured on the H100 (PERF.md section 6, batch 24, G = 1): the
// same ring with consumers that only release each stage takes 0.040 ms
// (int8) and 0.026 ms (int4); the K phase's work hides under the copies,
// the V phase's products do not (+0.003 ms and +0.010 ms). Stages of 256
// positions (two positions a lane on the CUDA cores) cut the per-stage
// overhead at G = 1.
#include "codes.cuh"
#include "hopper.cuh"

namespace {

constexpr int DH = 64;
constexpr int NW = 4;                   // consumer warps
constexpr int CONSUMERS = 32 * NW;
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int MAX_SPLIT = 8;            // blocks of a cluster
constexpr int MAX_SMEM = 227 * 1024;
constexpr int SMEM_4 = 56 * 1024;       // a block's share when four fit an SM

template <int BITS, int CHUNK>
struct Stage {
  static constexpr int CODE = DH * BITS / 8;        // bytes of a head's codes of a position
  static constexpr int CODES = CHUNK * CODE;
  static constexpr int SC_OFF = CODES;              // ks or vs [CHUNK] fp32
  static constexpr int B_OFF = SC_OFF + CHUNK * 4;  // bias [CHUNK] (K stages)
  static constexpr int STRIDE = (B_OFF + CHUNK * 4 + 1023) / 1024 * 1024;  // swizzle alignment
};

// byte offsets in dynamic shared memory, after its start is aligned to 1024:
// the ring; the logits [rows][npos] fp32 (later the warps' partial outputs
// [NW][rows][64]); pw [NW][gr][pw] (bf16 for the tensor cores, else fp32);
// q [gr][64] fp32 (CUDA cores); each run's max and sum [MAX_SPLIT][gr]; the
// warps' max and sum [2][NW][gr]; the other runs' outputs [n_split -
// 1][rows][64] (rank 0); the barriers full[ring], empty[ring], max, sum, out
struct Layout {
  int lg, pw, qs, xmax, xsum, red, xout, bar, bytes;
};

__host__ __device__ inline Layout layout(int stride, int ring, int gr, int pw, int rows,
                                         int npos, int n_split, bool tc) {
  Layout l;
  l.lg = ring * stride;
  l.pw = l.lg + rows * (npos > NW * DH ? npos : NW * DH) * 4;
  l.qs = l.pw + NW * gr * pw * (tc ? 2 : 4);
  l.xmax = l.qs + (tc ? 0 : gr * DH * 4);
  l.xsum = l.xmax + MAX_SPLIT * gr * 4;
  l.red = l.xsum + MAX_SPLIT * gr * 4;
  l.xout = l.red + 2 * NW * gr * 4;
  l.bar = l.xout + (n_split - 1) * rows * DH * 4;
  l.bytes = 1024 + l.bar + 8 * (2 * ring + 3);
  return l;
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// v into `slot` (in this block's shared memory) of every block of the
// cluster, completing on their barrier `bar`; a lone block stores it
__device__ __forceinline__ void share(float* slot, float v, uint32_t bar, int n_split) {
  if (n_split == 1) {
    *slot = v;
    return;
  }
  const uint32_t addr = smem_u32(slot);
  for (int r = 0; r < n_split; ++r) st_async(map_rank(addr, r), v, map_rank(bar, r));
}

// every consumer thread sees what `share` wrote through `bar`
__device__ __forceinline__ void shared_wait(uint32_t bar, int n_split) {
  if (n_split == 1) {
    consumers_sync();
  } else {
    mbar_wait_cluster(bar, 0);
    __syncwarp();
  }
}

// the code feature d of the tensor-core K phase's k slot j (0: k = 2c,
// 1: 2c + 1, 2: 2c + 8, 3: 2c + 9) at k-step s for lane group c: the order
// in which `pair8` / `pair4` hand out a thread's 16 codes
template <int BITS>
__device__ __forceinline__ int k_feature(int s, int c, int j) {
  if constexpr (BITS == 8) return 16 * c + 4 * s + ((j & 1) << 1) + (j >> 1);
  const int pair = 2 * s + (j >> 1);
  return 16 * c + (pair & 3) + 8 * (pair >> 2) + 4 * (j & 1);
}

template <int BITS, bool TC, int GR, int PW>
__global__ void __launch_bounds__(THREADS, 4)
    cross_decode_kernel(const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap, const bf16* __restrict__ q,
                        const float* __restrict__ ks, const float* __restrict__ vs,
                        const float* __restrict__ bias, float* __restrict__ out, int H, int G,
                        int Ta_pad, int n_split, int per_split, int ring_log2) {
  static_assert(TC || GR == 1, "the CUDA cores take one query row");
  constexpr int CHUNK = NW * PW;       // positions of a stage, PW a consumer warp
  using S = Stage<BITS, CHUNK>;
  constexpr int NT = GR > 8 ? 2 : 1;  // 8-row tiles of the tensor cores' V product
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int ring = 1 << ring_log2, npos = per_split * CHUNK, rows = min(GR, G);
  const Layout L = layout(S::STRIDE, ring, GR, PW, rows, npos, n_split, TC);
  float* lg = reinterpret_cast<float*>(base + L.lg);
  float* xmax = reinterpret_cast<float*>(base + L.xmax);
  float* xsum = reinterpret_cast<float*>(base + L.xsum);
  float* redm = reinterpret_cast<float*>(base + L.red);
  float* reds = redm + NW * GR;
  float* xout = reinterpret_cast<float*>(base + L.xout);
  const uint32_t full0 = smem_u32(base + L.bar), empty0 = full0 + 8 * ring,
                 xbar = empty0 + 8 * ring;  // max, sum, out

  const int h = blockIdx.x, a = blockIdx.y, tid = threadIdx.x;
  const int rank = n_split > 1 ? static_cast<int>(cluster_rank()) : 0;
  const int g0 = (blockIdx.z / n_split) * GR, gn = min(GR, G - g0);
  const int st0 = rank * per_split;
  const int ns = min(per_split, (Ta_pad + CHUNK - 1) / CHUNK - st0);
  const int p_begin = st0 * CHUNK, n_valid = min(ns * CHUNK, Ta_pad - p_begin);
  const int warp = tid >> 5, lane = tid & 31;
  const size_t qrow0 = (size_t)a * H * G + (size_t)h * G + g0;  // head-major rows

  if (tid == 0) {
    for (int st = 0; st < ring; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, NW);
    }
    for (int i = 0; i < 3; ++i) mbar_init(xbar + 8 * i, 1);
    mbar_fence_init();
    if (n_split > 1) {
      mbar_expect_tx(xbar, n_split * gn * 4);
      mbar_expect_tx(xbar + 8, n_split * gn * 4);
      if (rank == 0) mbar_expect_tx(xbar + 16, (n_split - 1) * gn * DH * 4);
    }
  }
  if constexpr (TC) {  // pw rows past G stay 0
    uint32_t* pwz = reinterpret_cast<uint32_t*>(base + L.pw);
    for (int i = tid; i < NW * GR * PW / 2; i += THREADS) pwz[i] = 0u;
  } else {
    float* qs = reinterpret_cast<float*>(base + L.qs);
    for (int i = tid; i < gn * DH; i += THREADS) qs[i] = __bfloat162float(q[qrow0 * DH + i]);
  }
  __syncthreads();
  if (n_split > 1) cluster_arrive();  // the barriers exist before any block writes here

  if (warp == NW) {  // the producer: the run's K stages, then its V stages
    if (lane == 0) {
      const float* ksr = ks + ((size_t)a * H + h) * Ta_pad;
      const float* vsr = vs + ((size_t)a * H + h) * Ta_pad;
      for (int j = 0; j < 2 * ns; ++j) {
        const bool is_k = j < ns;
        const int st = j & (ring - 1), p0 = p_begin + (is_k ? j : j - ns) * CHUNK;
        const uint32_t stage = smem_u32(base) + st * S::STRIDE, full = full0 + 8 * st;
        // stage st's previous use (j - ring) released by every consumer warp
        if (j >= ring) mbar_wait(empty0 + 8 * st, ((j >> ring_log2) & 1) ^ 1);
        const uint32_t scale_bytes = 4 * min(CHUNK, Ta_pad - p0);
        mbar_expect_tx(full, S::CODES + (is_k ? 2 : 1) * scale_bytes);
        tma_load(stage, is_k ? &kmap : &vmap, h * S::CODE, p0, a, full);
        bulk_load(stage + S::SC_OFF, (is_k ? ksr : vsr) + p0, scale_bytes, full);
        if (is_k) bulk_load(stage + S::B_OFF, bias + p0, scale_bytes, full);
      }
    }
    return;
  }

  const int gq = lane >> 2, c = lane & 3;  // mma fragment coordinates
  // ---- K phase: logits of the run, and each thread's running max ---------- //
  float mx[2] = {-INFINITY, -INFINITY};  // tensor cores: rows gq and gq + 8
  uint32_t qa[TC ? 4 : 1][4];  // tensor cores: q as the A operand, in k_feature order
  if constexpr (TC) {
    const uint16_t* qb = reinterpret_cast<const uint16_t*>(q) + qrow0 * DH;
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int reg = 0; reg < 4; ++reg) {  // reg 0/2: row gq, 1/3: row gq + 8
        const int g = gq + 8 * (reg & 1), j = 2 * (reg >> 1);
        qa[s][reg] = g < gn ? qb[g * DH + k_feature<BITS>(s, c, j)] |
                                  (uint32_t(qb[g * DH + k_feature<BITS>(s, c, j + 1)]) << 16)
                            : 0u;
      }
  }
  const float* qs = reinterpret_cast<const float*>(base + L.qs);
  for (int j = 0; j < ns; ++j) {
    const int st = j & (ring - 1);
    const unsigned char* stage = base + st * S::STRIDE;
    const float* ksc = reinterpret_cast<const float*>(stage + S::SC_OFF);
    const float* bc = reinterpret_cast<const float*>(stage + S::B_OFF);
    warp_wait(full0 + 8 * st, (j >> ring_log2) & 1);
    const int t0 = j * CHUNK;  // the run's position of the stage's row 0
    if constexpr (TC) {
#pragma unroll
      for (int tile = 0; tile < PW / 8; ++tile) {
        const int row = warp * PW + tile * 8 + gq;  // the position whose codes this thread widens
        uint32_t b[4][2];
        if constexpr (BITS == 8) {
          const uint4 w = *reinterpret_cast<const uint4*>(stage + row * 64 +
                                                          16 * (c ^ ((row >> 1) & 3)));
          const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int s = 0; s < 4; ++s) b[s][0] = pair8(ws[s]), b[s][1] = pair8(ws[s] >> 8);
        } else {
          const uint2 w = *reinterpret_cast<const uint2*>(
              stage + row * 32 + 16 * ((c >> 1) ^ ((row >> 2) & 1)) + 8 * (c & 1));
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const uint32_t ws = s < 2 ? w.x : w.y;
            b[s][0] = pair4(ws >> (8 * (s & 1))), b[s][1] = pair4(ws >> (8 * (s & 1) + 4));
          }
        }
        float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int s = 0; s < 4; ++s) mma_bf16_16816(d, qa[s], b[s]);
        // d[0], d[1]: row gq at the tile's positions 2c, 2c + 1; d[2], d[3]: row gq + 8
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = warp * PW + tile * 8 + 2 * c + e, t = t0 + r;
          if (t < n_valid) {
            const float sc = ksc[r], bb = bc[r];
            if (gq < gn) {
              const float x = __fadd_rn(__fmul_rn(d[e], sc), bb);
              lg[gq * npos + t] = x;
              mx[0] = fmaxf(mx[0], x);
            }
            if (GR > 8 && gq + 8 < gn) {
              const float x = __fadd_rn(__fmul_rn(d[2 + e], sc), bb);
              lg[(gq + 8) * npos + t] = x;
              mx[1] = fmaxf(mx[1], x);
            }
          }
        }
      }
    } else {  // one query row, PW / 32 positions a lane
#pragma unroll
      for (int m = 0; m < PW / 32; ++m) {
        const int r = warp * PW + 32 * m + lane, t = t0 + r;
        float dot = 0.f;
#pragma unroll
        for (int u = 0; u < S::CODE / 16; ++u) {
          // 16-byte unit u of row r, in the 64-byte (int8) or 32-byte (int4) swizzle
          const int phys = BITS == 8 ? u ^ ((r >> 1) & 3) : u ^ ((r >> 2) & 1);
          const uint4 kw = *reinterpret_cast<const uint4*>(stage + r * S::CODE + 16 * phys);
          constexpr int N = 128 / BITS;  // codes in 16 bytes
          float kf[N];
          if constexpr (BITS == 8) {
            widen8(kw.x, kf), widen8(kw.y, kf + 4), widen8(kw.z, kf + 8), widen8(kw.w, kf + 12);
          } else {
            widen4(kw.x, kf), widen4(kw.y, kf + 8), widen4(kw.z, kf + 16), widen4(kw.w, kf + 24);
          }
          const float4* qg = reinterpret_cast<const float4*>(qs + u * N);
#pragma unroll
          for (int i = 0; i < N / 4; ++i) {
            const float4 qv = qg[i];
            dot = fmaf(qv.x, kf[4 * i], dot);
            dot = fmaf(qv.y, kf[4 * i + 1], dot);
            dot = fmaf(qv.z, kf[4 * i + 2], dot);
            dot = fmaf(qv.w, kf[4 * i + 3], dot);
          }
        }
        if (t < n_valid) {
          const float x = __fadd_rn(__fmul_rn(dot, ksc[r]), bc[r]);
          lg[t] = x;
          mx[0] = fmaxf(mx[0], x);
        }
      }
    }
    __syncwarp();  // every lane is done with the stage
    if (lane == 0) mbar_arrive(empty0 + 8 * st);
  }

  // ---- the softmax's maximum and sum over every position ------------------ //
  if constexpr (TC) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    if (c == 0 && gq < gn) redm[warp * GR + gq] = mx[0];
    if (GR > 8 && c == 0 && gq + 8 < gn) redm[warp * GR + gq + 8] = mx[1];
  } else {
    const float m = warp_max(mx[0]);
    if (lane == 0) redm[warp * GR] = m;
  }
  consumers_sync();
  if (n_split > 1) cluster_wait();
  if (tid < gn) {
    float m = redm[tid];
#pragma unroll
    for (int w = 1; w < NW; ++w) m = fmaxf(m, redm[w * GR + tid]);
    share(xmax + rank * GR + tid, m, xbar, n_split);
  }
  shared_wait(xbar, n_split);
  float sum[GR];
#pragma unroll
  for (int g = 0; g < GR; ++g) {
    sum[g] = 0.f;
    if (g < gn) {
      float m = xmax[g];
      for (int r = 1; r < n_split; ++r) m = fmaxf(m, xmax[r * GR + g]);
      float* row = lg + g * npos;
      for (int t = tid; t < n_valid; t += CONSUMERS) {
        const float e = expf(row[t] - m);
        row[t] = e;
        sum[g] += e;
      }
      sum[g] = warp_sum(sum[g]);
      if (lane == 0) reds[warp * GR + g] = sum[g];
    }
  }
  consumers_sync();
  if (tid < gn) {
    float s = reds[tid];
#pragma unroll
    for (int w = 1; w < NW; ++w) s += reds[w * GR + tid];
    share(xsum + rank * GR + tid, s, xbar + 8, n_split);
  }
  shared_wait(xbar + 8, n_split);
#pragma unroll
  for (int g = 0; g < GR; ++g) {  // S, the runs' sums added in rank order
    if (g < gn) {
      sum[g] = xsum[g];
      for (int r = 1; r < n_split; ++r) sum[g] += xsum[r * GR + g];
    }
  }

  // ---- V phase: out += pw . v over the run ---------------------------------- //
  float acc[TC ? 4 * NT : 1][4];  // tensor cores: [m-tile][n-tile]; else 4 columns
#pragma unroll
  for (int i = 0; i < (TC ? 4 * NT : 1); ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  for (int j = ns; j < 2 * ns; ++j) {
    const int st = j & (ring - 1);
    const unsigned char* stage = base + st * S::STRIDE;
    const float* vsc = reinterpret_cast<const float*>(stage + S::SC_OFF);
    warp_wait(full0 + 8 * st, (j >> ring_log2) & 1);
    if constexpr (TC) {
      // pw of the warp's PW positions, PW / 32 a lane: position 16 k + 4 i + c
      // of the warp at slot 16 k + 4 c + i, so that a thread's four positions
      // of a k-step (c, c + 4, c + 8, c + 12) are contiguous
      bf16* pw = reinterpret_cast<bf16*>(base + L.pw) + warp * GR * PW;
#pragma unroll
      for (int m = 0; m < PW / 32; ++m) {
        const int wp = 32 * m + lane, r = warp * PW + wp, t = (j - ns) * CHUNK + r;
        const bool valid = t < n_valid;
        const float v_scale = valid ? vsc[r] : 0.f;
        const int slot = (wp & ~15) | ((wp & 3) << 2) | ((wp >> 2) & 3);
#pragma unroll
        for (int g = 0; g < GR; ++g) {
          if (g < gn) {
            const float p = valid ? __fdiv_rn(lg[g * npos + t], sum[g]) : 0.f;
            pw[g * PW + slot] = __float2bfloat16_rn(__fmul_rn(p, v_scale));
          }
        }
      }
      __syncwarp();
#pragma unroll
      for (int kstep = 0; kstep < PW / 16; ++kstep) {
        const int p0 = warp * PW + kstep * 16 + c;  // stage rows p0 + 4 i, i = 0..3
        uint32_t bfr[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint2 pv =
              *reinterpret_cast<const uint2*>(pw + (8 * nt + gq) * PW + kstep * 16 + 4 * c);
          bfr[nt][0] = pv.x, bfr[nt][1] = pv.y;
        }
        // m-tile i: rows (features) 8 gq + 2 i and 8 gq + 2 i + 1
        if constexpr (BITS == 8) {
          uint2 w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            w[i] = *reinterpret_cast<const uint2*>(stage + (p0 + 4 * i) * 64 + 8 * gq);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t sel = (i & 1) ? 0x7632u : 0x5410u;
            const uint32_t u01 = __byte_perm(i < 2 ? w[0].x : w[0].y, i < 2 ? w[1].x : w[1].y, sel);
            const uint32_t u23 = __byte_perm(i < 2 ? w[2].x : w[2].y, i < 2 ? w[3].x : w[3].y, sel);
            const uint32_t af[4] = {pair8(u01), pair8(u01 >> 8), pair8(u23), pair8(u23 >> 8)};
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) mma_bf16_16816(acc[i * NT + nt], af, bfr[nt]);
          }
        } else {
          uint32_t w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            w[i] = *reinterpret_cast<const uint32_t*>(stage + (p0 + 4 * i) * 32 + 4 * gq);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t sel = i < 2 ? 0x5410u : 0x7632u;
            const uint32_t u01 = __byte_perm(w[0], w[1], sel), u23 = __byte_perm(w[2], w[3], sel);
            const int sh = 8 * (i & 1);
            const uint32_t af[4] = {pair4(u01 >> sh), pair4(u01 >> (sh + 4)), pair4(u23 >> sh),
                                    pair4(u23 >> (sh + 4))};
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) mma_bf16_16816(acc[i * NT + nt], af, bfr[nt]);
          }
        }
      }
    } else {
      float* pws = reinterpret_cast<float*>(base + L.pw) + warp * PW;
#pragma unroll
      for (int m = 0; m < PW / 32; ++m) {
        const int wp = 32 * m + lane, r = warp * PW + wp, t = (j - ns) * CHUNK + r;
        const float p = t < n_valid ? __fmul_rn(__fdiv_rn(lg[t], sum[0]), vsc[r]) : 0.f;
        pws[wp] = __bfloat162float(__float2bfloat16_rn(p));
      }
      __syncwarp();
      const int dq = (lane & 15) * 4, sub = lane >> 4;
      const unsigned char* vrow = stage + warp * PW * S::CODE;
#pragma unroll 4
      for (int i = 0; i < PW / 2; ++i) {
        const int t2 = 2 * i + sub;
        float v[4];
        if constexpr (BITS == 8) {
          widen8(*reinterpret_cast<const uint32_t*>(vrow + t2 * S::CODE + dq), v);
        } else {
          const uint32_t w = *reinterpret_cast<const uint16_t*>(vrow + t2 * S::CODE + dq / 2);
          const uint32_t u = w ^ 0x8888u;
          const uint32_t lo = u & 0x0F0Fu, hi = (u >> 4) & 0x0F0Fu;
          v[0] = biased(lo, 0x7650) - 8388616.f, v[1] = biased(hi, 0x7650) - 8388616.f;
          v[2] = biased(lo, 0x7651) - 8388616.f, v[3] = biased(hi, 0x7651) - 8388616.f;
        }
        const float p = pws[t2];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[0][e] = fmaf(p, v[e], acc[0][e]);
      }
    }
    __syncwarp();  // every lane is done with the stage and with pw
    if (lane == 0) mbar_arrive(empty0 + 8 * st);
  }

  // ---- the warps' partial outputs in order, then the runs' in rank order --- //
  consumers_sync();  // every warp is done with the logits, which comb overwrites
  float* comb = lg;  // [NW][gn][64]
  if constexpr (TC) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // row 8 nt + 2 c + (e & 1), feature 8 gq + 2 i + (e >> 1)
          const int g = 8 * nt + 2 * c + (e & 1);
          if (g < gn) comb[(warp * gn + g) * DH + 8 * gq + 2 * i + (e >> 1)] = acc[i * NT + nt][e];
        }
  } else {  // lanes l and l + 16 hold the warp's two halves of the positions
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[0][e] += __shfl_xor_sync(0xffffffffu, acc[0][e], 16);
      if (lane < 16) comb[warp * DH + (lane & 15) * 4 + e] = acc[0][e];
    }
  }
  consumers_sync();
  if (n_split > 1 && rank == 0) mbar_wait_cluster(xbar + 16, 0);
  for (int i = tid; i < gn * DH; i += CONSUMERS) {
    float o = comb[i];
#pragma unroll
    for (int w = 1; w < NW; ++w) o += comb[w * gn * DH + i];
    if (rank == 0) {
      for (int r = 1; r < n_split; ++r) o += xout[(r - 1) * gn * DH + i];
      out[qrow0 * DH + i] = o;
    } else {
      st_async(map_rank(smem_u32(xout + (rank - 1) * gn * DH + i), 0), o, map_rank(xbar + 16, 0));
    }
  }
}

// a launch's dynamic shared memory, with the ring of four stages or, where
// four would leave room for fewer than four blocks an SM, two
template <int BITS, bool TC, int GR, int PW>
int smem_bytes(int G, int n_split, int per_split, int* ring_log2) {
  using S = Stage<BITS, NW * PW>;
  for (*ring_log2 = 2;; *ring_log2 = 1) {
    const int bytes = layout(S::STRIDE, 1 << *ring_log2, GR, PW, min(GR, G),
                             per_split * NW * PW, n_split, TC).bytes;
    if (bytes <= SMEM_4 || *ring_log2 == 1) return bytes;
  }
}

struct Args {
  const void *q, *ks, *vs, *bias;
  void* out;
  int A, H, G, Ta_pad, n_split, per_split;
  cudaStream_t stream;
};

template <int BITS, bool TC, int GR, int PW>
int run(const CUtensorMap& km, const CUtensorMap& vm, const Args& x) {
  auto kernel = cross_decode_kernel<BITS, TC, GR, PW>;
  int ring_log2;
  const int smem = smem_bytes<BITS, TC, GR, PW>(x.G, x.n_split, x.per_split, &ring_log2);
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  static int configured = 0;
  if (smem > configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(x.H, x.A, x.n_split * ((x.G + GR - 1) / GR));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = x.stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1, attr.val.clusterDim.y = 1, attr.val.clusterDim.z = x.n_split;
  cfg.attrs = &attr;
  cfg.numAttrs = x.n_split > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, km, vm, static_cast<const bf16*>(x.q), static_cast<const float*>(x.ks),
      static_cast<const float*>(x.vs), static_cast<const float*>(x.bias),
      static_cast<float*>(x.out), x.H, x.G, x.Ta_pad, x.n_split, x.per_split, ring_log2);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// the kernels `plan` (ops/cross_decode.py) chooses: one query row on the
// CUDA cores in stages of 256 positions; more rows on the tensor cores in
// slices of 8 (G <= 8) or 16, in stages of 128 positions or, for int4 up to
// G = 8, of 256. With `smem` the launch's shared memory goes there and
// nothing runs. Any other (tc, chunk, G) is refused.
template <int BITS, bool TC, int GR, int PW>
int run_or_size(const CUtensorMap* km, const CUtensorMap* vm, const Args& x, int* smem) {
  int ring_log2;
  return smem ? *smem = smem_bytes<BITS, TC, GR, PW>(x.G, x.n_split, x.per_split, &ring_log2)
              : run<BITS, TC, GR, PW>(*km, *vm, x);
}

template <int BITS>
int select(const CUtensorMap* km, const CUtensorMap* vm, const Args& x, int tc, int chunk,
           int* smem) {
  if (!tc && chunk == 256 && x.G == 1) return run_or_size<BITS, false, 1, 64>(km, vm, x, smem);
  if (tc && chunk == 128)
    return x.G > 8 ? run_or_size<BITS, true, 16, 32>(km, vm, x, smem)
                   : run_or_size<BITS, true, 8, 32>(km, vm, x, smem);
  if constexpr (BITS == 4)
    if (tc && chunk == 256 && x.G <= 8) return run_or_size<BITS, true, 8, 64>(km, vm, x, smem);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int BITS>
int launch(const void* q, const void* kq, const void* ks, const void* vq, const void* vs,
           const void* bias, void* out, int A, int H, int G, int Ta_pad, int n_split,
           int per_split, int tc, int chunk, void* stream) {
  constexpr int CODE = DH * BITS / 8;
  const int n_stages = (Ta_pad + chunk - 1) / chunk;
  if (Ta_pad < 1 || Ta_pad % 4 || G < 1 || (chunk != 128 && chunk != 256) ||
      n_split < 1 || n_split > MAX_SPLIT || per_split < 1 ||
      (n_split - 1) * per_split >= n_stages || n_split * per_split < n_stages)
    return static_cast<int>(cudaErrorInvalidValue);
  EncodeTiled fn;
  const cudaError_t e = encode_function(&fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  // codes [A, Ta_pad, H * CODE] bytes, box {CODE, chunk, 1}
  const CUtensorMapSwizzle kswz =
      BITS == 8 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap km, vm;
  int rc = encode_3d(fn, &km, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, kq, H * CODE, Ta_pad, A, CODE,
                     chunk, kswz, CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
  if (rc == 0)
    rc = encode_3d(fn, &vm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, vq, H * CODE, Ta_pad, A, CODE,
                   chunk, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
  if (rc != 0) return rc;
  const Args x{q, ks, vs, bias, out, A, H, G, Ta_pad, n_split, per_split,
               static_cast<cudaStream_t>(stream)};
  return select<BITS>(&km, &vm, x, tc, chunk, nullptr);
}

}  // namespace

// Dynamic shared memory of a launch (the wrapper refuses what exceeds 227 KB).
extern "C" int cross_decode_smem_bytes(int bits, int G, int n_split, int per_split, int tc,
                                       int chunk) {
  Args x{};
  x.G = G, x.n_split = n_split, x.per_split = per_split;
  int smem = 0;
  if (bits == 4)
    select<4>(nullptr, nullptr, x, tc, chunk, &smem);
  else
    select<8>(nullptr, nullptr, x, tc, chunk, &smem);
  return smem;
}

// q [A, H*G, 64] bf16 (head-major rows, pre-scaled by 64^-0.5);
// kq, vq [A, Ta_pad, H*64] int8; ks, vs [A, H, Ta_pad] fp32; bias [Ta_pad];
// out [A, H*G, 64] fp32. Ta_pad a multiple of 4 (the scales' rows are
// copied in 16-byte units); the positions split into n_split <= 8 runs of
// per_split stages of `chunk` (128 or 256) positions, none empty, the
// blocks of one cluster; tc puts the products on the tensor cores (without
// it, G must be 1).
extern "C" int cross_decode_bf16(const void* q, const void* kq, const void* ks,
                                 const void* vq, const void* vs, const void* bias, void* out,
                                 int A, int H, int G, int Ta_pad, int n_split, int per_split,
                                 int tc, int chunk, void* stream) {
  return launch<8>(q, kq, ks, vq, vs, bias, out, A, H, G, Ta_pad, n_split, per_split, tc, chunk,
                   stream);
}

// The int4 entry: the same arguments, kq and vq packed int8 [A, Ta_pad, H*32].
extern "C" int cross_decode4_bf16(const void* q, const void* kq, const void* ks,
                                  const void* vq, const void* vs, const void* bias, void* out,
                                  int A, int H, int G, int Ta_pad, int n_split, int per_split,
                                  int tc, int chunk, void* stream) {
  return launch<4>(q, kq, ks, vq, vs, bias, out, A, H, G, Ta_pad, n_split, per_split, tc, chunk,
                   stream);
}
