// K2: the encoder MLP half-block  out = x + fc2(gelu(fc1(LN(x)))),  bf16.
//
// Replaces whisper_at_tpu/ops/mlp_enc.py::mlp_block_fused (Pallas, TPU).
// The TPU kernel keeps an fp32 [block_m, D] accumulator of the whole
// output row in VMEM so that the [M, 4D] gelu intermediate never reaches
// HBM. At D = 1280 that accumulator is 327 KB for 64 rows, more than a
// block's 227 KB of shared memory and far more than its registers, so one
// call here is three launches:
//   1. ln_rows:  xn = LN(x) in fp32, stored bf16 [M, D]           (one warp a row)
//   2. fc1:      h  = gelu(xn W1^T + b1), exact erf, bf16 [M, 4D]
//   3. fc2:      out = x + (h W2^T + b2), bf16 [M, D]
// The two products run on gemm_sm90.cuh: persistent blocks, a TMA ring of
// four 64-deep stages, wgmma from shared memory in two consumer
// warpgroups, the sums started from the bias (fc1) or the bias plus x
// (fc2), GELU applied in registers, the tile stored by TMA. Each product's
// block width (256 or 128 columns) is ops/enc_mlp.py's plan: 256 where
// that still gives one tile a block on every SM, else 128.
// What bounds it on the H100: 4*M*D*4D = 9.44e11 FLOP a call at large-v1
// batch 24 (M = 36000, D = 1280), 0.954 ms at 989 TFLOP/s bf16, while its
// bytes (x, W1, W2, out: ~0.2 GB, 0.06 ms; 0.94 GB with h through HBM,
// 0.28 ms) stay far below: operations. h's round trip through HBM is
// affordable because both products are compute-bound; the LN pass moves
// 184 MB (~0.06 ms). GELU is the exact erf form (CUDA's erff), not the TPU
// kernel's A&S approximation. Measured at that shape (NVIDIA H100 80GB
// HBM3, 700 W; chip_smoke.py's k2_points, PERF.md): 1.59-1.61 ms,
// 60% of the bound, 0.38x the mma.sync kernel it replaced. What it leaves
// is each tile's epilogue, which the tensor cores wait out (erff over
// fc1's 184 M values above all), and fc2's loads of x at each tile's
// start.
#include "gemm_sm90.cuh"

namespace {

constexpr float kLnEps = 1e-5f;

// one warp per row; two-pass mean/variance in fp32 (jnp.var semantics)
__global__ void __launch_bounds__(256) ln_rows(const bf16* __restrict__ x,
                                               const float* __restrict__ gamma,
                                               const float* __restrict__ beta,
                                               bf16* __restrict__ y, int M, int D) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const __nv_bfloat162* xr = reinterpret_cast<const __nv_bfloat162*>(x + (size_t)row * D);
  const int n2 = D / 2;
  float s = 0.f;
  for (int i = lane; i < n2; i += 32) {
    float2 v = __bfloat1622float2(xr[i]);
    s += v.x + v.y;
  }
  const float mean = warp_sum(s) / (float)D;
  float ss = 0.f;
  for (int i = lane; i < n2; i += 32) {
    float2 v = __bfloat1622float2(xr[i]);
    const float a = v.x - mean, b = v.y - mean;
    ss += a * a + b * b;
  }
  const float rstd = rsqrtf(warp_sum(ss) / (float)D + kLnEps);
  __nv_bfloat162* yr = reinterpret_cast<__nv_bfloat162*>(y + (size_t)row * D);
  for (int i = lane; i < n2; i += 32) {
    float2 v = __bfloat1622float2(xr[i]);
    const float a = (v.x - mean) * rstd * gamma[2 * i] + beta[2 * i];
    const float b = (v.y - mean) * rstd * gamma[2 * i + 1] + beta[2 * i + 1];
    yr[i] = __floats2bfloat162_rn(a, b);
  }
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// fc1: gelu(b1 + sum)
struct BiasGelu {
  const float* bias;
  __device__ __forceinline__ float2 init(int, int col) const {
    return __ldg(reinterpret_cast<const float2*>(bias + col));
  }
  __device__ __forceinline__ float operator()(float s) const { return gelu_erf(s); }
};

// fc2: (x + b2) + sum; rows past M (which the store clips) read no x
struct BiasResidual {
  const float* bias;
  const bf16* res;
  int M, ld;
  __device__ __forceinline__ float2 init(int row, int col) const {
    float2 v = __ldg(reinterpret_cast<const float2*>(bias + col));
    if (row < M) {
      const float2 x = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(res + (size_t)row * ld + col));
      v.x += x.x;
      v.y += x.y;
    }
    return v;
  }
  __device__ __forceinline__ float operator()(float s) const { return s; }
};

// fc2 of a tensor-parallel rank (K2-partial): its share of the sum alone,
// from zero; the residual and b2 enter once, after the sum over the ranks
struct PartialSum {
  __device__ __forceinline__ float2 init(int, int) const { return make_float2(0.f, 0.f); }
  __device__ __forceinline__ float operator()(float s) const { return s; }
};

template <class Epi>
int gemm(int bn, const void* a, const void* b, void* c, const Epi& epi, int M, int N, int K,
         int blocks, cudaStream_t s) {
  if (bn == 256) return gemm_sm90::run<256>(a, b, c, epi, M, N, K, blocks, s);
  if (bn == 128) return gemm_sm90::run<128>(a, b, c, epi, M, N, K, blocks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x [M, D]; w1 [F, D]; w2 [D, F] (torch Linear layout); LN and biases fp32;
// xn [M, D] and h [M, F] are caller-allocated scratch; out [M, D]. D and F
// are multiples of 128 and of the block widths bn1 (fc1, over F) and bn2
// (fc2, over D); blocks1 and blocks2 are the products' persistent grids.
extern "C" int enc_mlp_bf16(const void* x, const void* ln_w, const void* ln_b,
                            const void* w1, const void* b1, const void* w2,
                            const void* b2, void* xn, void* h, void* out, int M,
                            int D, int F, int bn1, int blocks1, int bn2, int blocks2,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ln_rows<<<(M + 7) / 8, 256, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), static_cast<bf16*>(xn), M, D);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc == 0)
    rc = gemm(bn1, xn, w1, h, BiasGelu{static_cast<const float*>(b1)}, M, F, D, blocks1, s);
  if (rc == 0)
    rc = gemm(bn2, h, w2, out,
              BiasResidual{static_cast<const float*>(b2), static_cast<const bf16*>(x), M, D},
              M, D, F, blocks2, s);
  return rc;
}

// K2-partial, a tensor-parallel rank's MLP: out = h W2^T with h = gelu(LN(x)
// W1^T + b1) over this rank's F hidden units (w1 [F, D], b1 [F], w2 [D, F]:
// its rows of fc1 and columns of fc2), with no residual and no b2; the
// caller sums `out` over the ranks and then adds x + b2. The same launches
// as enc_mlp_bf16 but fc2's epilogue (PartialSum).
extern "C" int enc_mlp_partial_bf16(const void* x, const void* ln_w, const void* ln_b,
                                    const void* w1, const void* b1, const void* w2, void* xn,
                                    void* h, void* out, int M, int D, int F, int bn1,
                                    int blocks1, int bn2, int blocks2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ln_rows<<<(M + 7) / 8, 256, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), static_cast<bf16*>(xn), M, D);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc == 0)
    rc = gemm(bn1, xn, w1, h, BiasGelu{static_cast<const float*>(b1)}, M, F, D, blocks1, s);
  if (rc == 0) rc = gemm(bn2, h, w2, out, PartialSum{}, M, D, F, blocks2, s);
  return rc;
}
