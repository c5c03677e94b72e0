// K2: the encoder MLP half-block  out = x + fc2(gelu(fc1(LN(x)))),  bf16.
//
// Replaces whisper_at_tpu/ops/mlp_enc.py::mlp_block_fused (Pallas, TPU).
// The TPU kernel keeps an fp32 [block_m, D] accumulator of the whole
// output row in VMEM so that the [M, 4D] gelu intermediate never reaches
// HBM. At D = 1280 that accumulator is 327 KB for 64 rows, more than a
// block's 227 KB of shared memory and far more than its registers, so this
// port takes design (a): three launches in one call,
//   1. ln_rows:    xn = LN(x) in fp32, stored bf16 [M, D]          (one warp per row)
//   2. gemm gelu:  h  = gelu(xn @ W1^T + b1), fp32 epilogue, bf16 [M, 4D]
//   3. gemm resid: out = x + h @ W2^T + b2, fp32 epilogue, bf16 [M, D]
// The bf16 intermediate (369 MB at large-v1 batch 24) goes through HBM.
// What bounds it on the H100: 4*M*D*4D = 9.4e11 FLOP per call at large-v1
// batch 24 against 989 TFLOP/s bf16 (0.95 ms), while the bytes (x, W1, W2,
// out: ~0.2 GB; 1 GB with the intermediate) need 0.06-0.3 ms, so it is
// compute-bound; the two GEMMs run on the tensor cores (gemm.cuh). GELU is
// the exact erf form (CUDA's erff), not the TPU kernel's A&S approximation.
#include "gemm.cuh"

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

// RESIDUAL == false: out = gelu(A @ B^T + bias)
// RESIDUAL == true:  out = res + A @ B^T + bias
template <bool RESIDUAL>
__global__ void __launch_bounds__(gemm::THREADS)
    gemm_epilogue(const bf16* __restrict__ A, const bf16* __restrict__ B,
                  const float* __restrict__ bias, const bf16* __restrict__ res,
                  bf16* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) bf16 smem[gemm::SMEM_BF16];
  const int n0 = blockIdx.x * gemm::BN;
  const int m0 = blockIdx.y * gemm::BM;
  gemm::Frag f;
  gemm::mainloop(
      f,
      [&](int r) -> const bf16* {
        const int gr = m0 + r;
        return gr < M ? A + (size_t)gr * K : nullptr;
      },
      B, K, n0, smem);

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int wr = gemm::warp_row0(), wc = gemm::warp_col0();
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wc + ni * 8 + tg * 2;
      const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wr + mi * 16 + g + half * 8;
        if (row >= M) continue;
        float v0 = f.acc[mi][ni][2 * half] + b0;
        float v1 = f.acc[mi][ni][2 * half + 1] + b1;
        const size_t off = (size_t)row * N + col;
        if (RESIDUAL) {
          const float2 r = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(res + off));
          v0 += r.x;
          v1 += r.y;
        } else {
          v0 = gelu_erf(v0);
          v1 = gelu_erf(v1);
        }
        *reinterpret_cast<__nv_bfloat162*>(out + off) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

}  // namespace

// x [M, D]; w1 [F, D]; w2 [D, F] (torch Linear layout); LN and biases fp32;
// xn [M, D] and h [M, F] are caller-allocated scratch; out [M, D].
// Requires D % 128 == 0, F % 128 == 0 (and both % 32 == 0 for the K loop).
extern "C" int enc_mlp_bf16(const void* x, const void* ln_w, const void* ln_b,
                            const void* w1, const void* b1, const void* w2,
                            const void* b2, void* xn, void* h, void* out, int M,
                            int D, int F, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ln_rows<<<(M + 7) / 8, 256, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), static_cast<bf16*>(xn), M, D);
  const int mt = (M + gemm::BM - 1) / gemm::BM;
  gemm_epilogue<false><<<dim3(F / gemm::BN, mt), gemm::THREADS, 0, s>>>(
      static_cast<const bf16*>(xn), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), nullptr, static_cast<bf16*>(h), M, F, D);
  gemm_epilogue<true><<<dim3(D / gemm::BN, mt), gemm::THREADS, 0, s>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<const bf16*>(x),
      static_cast<bf16*>(out), M, D, F);
  return static_cast<int>(cudaGetLastError());
}
