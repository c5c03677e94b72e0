// K4: decode-step cross-attention over int8 K/V with per-(head, position)
// fp32 scales, an additive pad bias and an fp32 softmax.
//
// Replaces whisper_at_tpu/ops/cross_decode.py::cross_attention_int8 (Pallas,
// TPU). The TPU kernel folds all heads into one block-diagonal matmul to
// dodge the MXU's M = 1 issue cost; that has no reason on Hopper. Here one
// block of 256 threads serves one (head, audio row) (480 blocks at large-v1
// batch 24) and the G <= 12 query rows of that head:
//   1. each thread takes key positions t = tid, tid + 256, ...: it reads the
//      64 int8 codes of K[a, t, head] as four 16-byte loads, dequantizes in
//      registers and forms the G dot products with the fp32 queries in
//      shared memory; logit = dot * ks + bias goes to shared memory
//      (G x Ta_pad fp32: 6 KB per query row);
//   2. a two-pass fp32 softmax per row over the logits in shared memory;
//      the V scale is folded into P, which is rounded to bf16 as in the
//      reference (pw = bf16(p * vs));
//   3. P V: 16 threads cover the 64 codes of one V row (4 bytes each), 16 key
//      rows at a time, with the per-thread partial sums reduced through
//      shared memory, up to 4 query rows per pass.
// What bounds it on the H100: the bytes. Per call at large-v1 batch 24 the
// int8 K and V (94 MB) plus the scales (5.9 MB) need ~0.03 ms at 3.35 TB/s
// while the arithmetic is ~1.9e8 FLOP; one layer's K/V (94 MB) does not fit
// the 50 MB L2, so every step streams it from HBM. The design reads each
// code once, as int8, with 16-byte loads, and never materialises a
// dequantized copy.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int DH = 64;
constexpr int ROW_GROUPS = THREADS / 16;  // key rows in flight in the P V phase
constexpr int GC = 4;                     // query rows per P V pass

__device__ float block_reduce(float v, float* scratch, bool is_max) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = is_max ? warp_max(v) : warp_sum(v);
  __syncthreads();  // scratch may still be read by a previous reduction
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float r = scratch[0];
#pragma unroll
  for (int w = 1; w < THREADS / 32; ++w) r = is_max ? fmaxf(r, scratch[w]) : r + scratch[w];
  return r;
}

template <int BITS>
__global__ void __launch_bounds__(THREADS)
    cross_decode_kernel(const bf16* __restrict__ q, const int8_t* __restrict__ kq,
                        const float* __restrict__ ks, const int8_t* __restrict__ vq,
                        const float* __restrict__ vs, const float* __restrict__ bias,
                        float* __restrict__ out, int H, int G, int Ta_pad) {
  extern __shared__ __align__(16) float sm[];
  float* lg = sm;                        // [G][Ta_pad] logits, then weights
  float* qs = lg + (size_t)G * Ta_pad;   // [G][64]
  float* red = qs + G * DH;              // [ROW_GROUPS][GC][64]
  __shared__ float scratch[THREADS / 32];

  const int h = blockIdx.x, a = blockIdx.y, tid = threadIdx.x;
  const int D = H * DH;
  const size_t qrow0 = (size_t)a * H * G + (size_t)h * G;  // head-major rows
  for (int i = tid; i < G * DH; i += THREADS) qs[i] = __bfloat162float(q[qrow0 * DH + i]);
  __syncthreads();

  const int row_bytes = D * BITS / 8;  // bytes of one key / value row
  const int8_t* kbase = kq + (size_t)a * Ta_pad * row_bytes + h * (DH * BITS / 8);
  const float* ksr = ks + ((size_t)a * H + h) * Ta_pad;
  for (int t = tid; t < Ta_pad; t += THREADS) {
    const int4* kp = reinterpret_cast<const int4*>(kbase + (size_t)t * row_bytes);
    float kf[DH];
#pragma unroll
    for (int i = 0; i < DH * BITS / 128; ++i) {
      const int4 w = kp[i];
      const int8_t* e = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if constexpr (BITS == 8) {
          kf[i * 16 + j] = static_cast<float>(e[j]);
        } else {
          const int byte = e[j];
          kf[i * 32 + 2 * j] = static_cast<float>(low_nibble(byte));
          kf[i * 32 + 2 * j + 1] = static_cast<float>(byte >> 4);
        }
      }
    }
    const float sc = ksr[t], bb = bias[t];
    for (int gi = 0; gi < G; ++gi) {
      const float* qg = qs + gi * DH;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc = fmaf(qg[d], kf[d], acc);
      lg[(size_t)gi * Ta_pad + t] = __fadd_rn(__fmul_rn(acc, sc), bb);
    }
  }
  __syncthreads();

  const float* vsr = vs + ((size_t)a * H + h) * Ta_pad;
  for (int gi = 0; gi < G; ++gi) {
    float* row = lg + (size_t)gi * Ta_pad;
    float mx = -INFINITY;
    for (int t = tid; t < Ta_pad; t += THREADS) mx = fmaxf(mx, row[t]);
    mx = block_reduce(mx, scratch, true);
    float sum = 0.f;
    for (int t = tid; t < Ta_pad; t += THREADS) {
      const float e = expf(row[t] - mx);
      row[t] = e;
      sum += e;
    }
    sum = block_reduce(sum, scratch, false);
    for (int t = tid; t < Ta_pad; t += THREADS)
      row[t] = __bfloat162float(__float2bfloat16_rn(__fmul_rn(__fdiv_rn(row[t], sum), vsr[t])));
  }
  __syncthreads();

  const int8_t* vbase = vq + (size_t)a * Ta_pad * row_bytes + h * (DH * BITS / 8);
  const int dq = (tid & 15) * 4;  // this thread's 4 columns of the head
  const int rg = tid >> 4;        // its key-row group
  for (int g0 = 0; g0 < G; g0 += GC) {
    const int gn = min(GC, G - g0);
    float acc[GC][4];
#pragma unroll
    for (int i = 0; i < GC; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    for (int t = rg; t < Ta_pad; t += ROW_GROUPS) {
      float v0, v1, v2, v3;
      if constexpr (BITS == 8) {
        const char4 c = *reinterpret_cast<const char4*>(vbase + (size_t)t * row_bytes + dq);
        v0 = c.x, v1 = c.y, v2 = c.z, v3 = c.w;
      } else {
        const char2 c = *reinterpret_cast<const char2*>(vbase + (size_t)t * row_bytes + dq / 2);
        const int lo = c.x, hi = c.y;
        v0 = static_cast<float>(low_nibble(lo)), v1 = static_cast<float>(lo >> 4);
        v2 = static_cast<float>(low_nibble(hi)), v3 = static_cast<float>(hi >> 4);
      }
#pragma unroll
      for (int i = 0; i < GC; ++i) {
        if (i < gn) {
          const float p = lg[(size_t)(g0 + i) * Ta_pad + t];
          acc[i][0] = fmaf(p, v0, acc[i][0]);
          acc[i][1] = fmaf(p, v1, acc[i][1]);
          acc[i][2] = fmaf(p, v2, acc[i][2]);
          acc[i][3] = fmaf(p, v3, acc[i][3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < GC; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) red[(rg * GC + i) * DH + dq + j] = acc[i][j];
    __syncthreads();
    for (int i = tid; i < gn * DH; i += THREADS) {
      const int gi = i / DH, d = i % DH;
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < ROW_GROUPS; ++r) s += red[(r * GC + gi) * DH + d];
      out[(qrow0 + g0 + gi) * DH + d] = s;
    }
    __syncthreads();
  }
}

}  // namespace

// Dynamic shared memory the kernel needs for G query rows.
extern "C" int cross_decode_smem_bytes(int G, int Ta_pad) {
  return static_cast<int>(sizeof(float) *
                          ((size_t)G * Ta_pad + (size_t)G * DH + ROW_GROUPS * GC * DH));
}

namespace {

template <int BITS>
int launch(const void* q, const void* kq, const void* ks, const void* vq, const void* vs,
           const void* bias, void* out, int A, int H, int G, int Ta_pad, void* stream) {
  static int configured = 0;
  const int smem = cross_decode_smem_bytes(G, Ta_pad);
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        cross_decode_kernel<BITS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = smem;
  }
  cross_decode_kernel<BITS><<<dim3(H, A), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const int8_t*>(kq),
      static_cast<const float*>(ks), static_cast<const int8_t*>(vq),
      static_cast<const float*>(vs), static_cast<const float*>(bias),
      static_cast<float*>(out), H, G, Ta_pad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [A, H*G, 64] bf16 (head-major rows, pre-scaled by 64^-0.5);
// kq, vq [A, Ta_pad, H*64] int8; ks, vs [A, H, Ta_pad] fp32; bias [Ta_pad];
// out [A, H*G, 64] fp32.
extern "C" int cross_decode_bf16(const void* q, const void* kq, const void* ks,
                                 const void* vq, const void* vs, const void* bias,
                                 void* out, int A, int H, int G, int Ta_pad,
                                 void* stream) {
  return launch<8>(q, kq, ks, vq, vs, bias, out, A, H, G, Ta_pad, stream);
}

// The int4 entry: the same arguments, kq and vq packed int8 [A, Ta_pad, H*32].
extern "C" int cross_decode4_bf16(const void* q, const void* kq, const void* ks,
                                  const void* vq, const void* vs, const void* bias,
                                  void* out, int A, int H, int G, int Ta_pad,
                                  void* stream) {
  return launch<4>(q, kq, ks, vq, vs, bias, out, A, H, G, Ta_pad, stream);
}
