// K8: the decode step's MLP in one call,
//   out [M, D] = fc2(gelu(fc1(x))),  x [M, D] bf16, hidden F = 4D,
// with bf16 weights or int8 weights and per-output-channel fp32 scales
// (the port's Linear / QuantLinear, [out, in]), in the TPU kernel's
// rounding: h = x W1^T (* s1) + b1 in fp32, exact GELU in fp32 (erff),
// rounded to bf16; the fc2 partials (* s2) summed in fp32; b2 added last.
//
// Replaces whisper_at_tpu/ops/fused_mlp.py::fused_mlp (Pallas, TPU; bf16
// and int8 entries), whose grid walks the hidden axis in order on one core
// and accumulates the output in VMEM. Its Abramowitz-Stegun erf exists
// because Mosaic has no erf and is not carried over. Blocks on Hopper run in
// no order, so the hidden axis is split instead: a block owns FS = 64
// hidden units and MB = 32 rows (grid y covers more rows). It computes its
// slice of h (fc1 over all of D, the GELU epilogue in registers, h kept in
// shared memory, never in HBM), then its slice's contribution to all D
// outputs, which it writes to an fp32 scratch [F/FS, M, D]; a second
// kernel sums the F/FS partials of each output in a fixed order and adds b2
// (deterministic: no atomics, so the same tokens every run).
//
// The weights stream through one 4-stage cp.async ring of 64-wide chunks:
// first W1's slice (with x) over D in chunks of 64, then W2's columns of
// the slice in chunks of 64 outputs, so W2's first chunks load while fc1
// finishes. Products run on mma.sync m16n8k16 (bf16 in, fp32 accumulate);
// int8 weights are widened to bf16 pairs in registers (exact), so no bf16
// copy of a quantized weight is ever written.
//
// What bounds it on the H100: the bytes. At large-v1 (D 1280, F 5120) and
// M = 24 the int8 weights are 13.1 MB (~0.0039 ms at 3.35 TB/s; bf16
// weights 26.2 MB, ~0.0078 ms) for 0.63 GFLOP (~0.0006 ms at 989 TFLOP/s).
// The design reads each weight once. Its known cost is the scratch:
// 80 slices x M x D fp32 (9.8 MB at M = 24), written and read once; a
// cluster reduction through distributed shared memory would remove most
// of it.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;  // 4 warps
constexpr int MB = 32;        // rows per block (2 m-tiles)
constexpr int FS = 64;        // hidden units per block
constexpr int KC = 64;        // chunk: fc1 depth, fc2 output columns
constexpr int NST = 4;        // ring stages
constexpr int LDA = KC + 8;   // bf16 row stride of x and h tiles (144 bytes)

template <bool Q>
struct Layout {
  static constexpr int WROW = Q ? KC + 16 : (KC + 8) * 2;  // bytes of a weight chunk row
  static constexpr int X_BYTES = MB * LDA * 2;
  static constexpr int STAGE = X_BYTES + 64 * WROW;
  static constexpr int SMEM = NST * STAGE + MB * LDA * 2;  // ring, then h
};

// two weights of a chunk row (k, k + 1) as a bf16 pair
template <bool Q>
__device__ __forceinline__ uint32_t w_pair(const unsigned char* row, int k) {
  if constexpr (Q) {
    const char2 c = *reinterpret_cast<const char2*>(row + k);
    return pack_bf16(static_cast<float>(c.x), static_cast<float>(c.y));
  } else {
    return ld_pair(reinterpret_cast<const bf16*>(row) + k);
  }
}

template <bool Q>
__global__ void __launch_bounds__(THREADS)
    fused_mlp_kernel(const bf16* __restrict__ x, const void* __restrict__ w1,
                     const float* __restrict__ s1, const bf16* __restrict__ b1,
                     const void* __restrict__ w2, const float* __restrict__ s2,
                     float* __restrict__ part, int M, int D, int F) {
  using L = Layout<Q>;
  constexpr int ESZ = Q ? 1 : 2;  // bytes of a weight
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* hs = reinterpret_cast<bf16*>(smem_raw + NST * L::STAGE);  // [MB][LDA]

  const int slice = blockIdx.x, f0 = slice * FS, m0 = blockIdx.y * MB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nk = D / KC, total = 2 * nk;  // fc1 chunks over D, then fc2 chunks over D
  const unsigned char* w1b = static_cast<const unsigned char*>(w1);
  const unsigned char* w2b = static_cast<const unsigned char*>(w2);

  auto load_stage = [&](int c) {
    unsigned char* st = smem_raw + (c % NST) * L::STAGE;
    unsigned char* ws = st + L::X_BYTES;
    constexpr int PIECES = KC * ESZ / 16;  // 16-byte copies per weight chunk row
    if (c < nk) {
      bf16* xs = reinterpret_cast<bf16*>(st);
      for (int i = tid; i < MB * KC / 8; i += THREADS) {
        const int r = i >> 3, col = (i & 7) * 8;
        const bool ok = m0 + r < M;
        cp_async16(xs + r * LDA + col, x + (size_t)(ok ? m0 + r : 0) * D + c * KC + col, ok);
      }
      for (int i = tid; i < 64 * PIECES; i += THREADS) {
        const int r = i / PIECES, p = (i % PIECES) * 16;
        cp_async16(ws + r * L::WROW + p, w1b + ((size_t)(f0 + r) * D + c * KC) * ESZ + p, true);
      }
    } else {
      const int n0 = (c - nk) * KC;
      for (int i = tid; i < 64 * PIECES; i += THREADS) {
        const int r = i / PIECES, p = (i % PIECES) * 16;
        cp_async16(ws + r * L::WROW + p, w2b + ((size_t)(n0 + r) * F + f0) * ESZ + p, true);
      }
    }
  };

  float acc[2][2][4];
  auto zero = [&]() {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        acc[mi][nj][0] = acc[mi][nj][1] = acc[mi][nj][2] = acc[mi][nj][3] = 0.f;
  };
  zero();

#pragma unroll
  for (int c = 0; c < NST - 1; ++c) {
    if (c < total) load_stage(c);
    cp_async_commit();
  }
  for (int c = 0; c < total; ++c) {
    cp_async_wait<NST - 2>();
    // chunk c has landed for every thread, every thread is done with chunk
    // c - 1 (whose stage the next load refills), and h is complete
    __syncthreads();
    if (c + NST - 1 < total) load_stage(c + NST - 1);
    cp_async_commit();
    const unsigned char* st = smem_raw + (c % NST) * L::STAGE;
    const bf16* as = c < nk ? reinterpret_cast<const bf16*>(st) : hs;  // A: x chunk or h
    const unsigned char* ws = st + L::X_BYTES;

#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const bf16* p = as + (mi * 16 + g) * LDA + ks * 16 + t * 2;
        af[mi][0] = ld_pair(p);
        af[mi][1] = ld_pair(p + 8 * LDA);
        af[mi][2] = ld_pair(p + 8);
        af[mi][3] = ld_pair(p + 8 * LDA + 8);
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        const unsigned char* row = ws + ((warp * 2 + nj) * 8 + g) * L::WROW;
        const uint32_t bb[2] = {w_pair<Q>(row, ks * 16 + t * 2),
                                w_pair<Q>(row, ks * 16 + t * 2 + 8)};
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_bf16_16816(acc[mi][nj], af[mi], bb);
      }
    }

    if (c == nk - 1) {
      // fc1 epilogue: h = gelu(acc (* s1) + b1) in fp32, rounded to bf16
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        const int col = (warp * 2 + nj) * 8 + t * 2;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int f = f0 + col + e;
          const float sc = Q ? s1[f] : 1.f, bias = __bfloat162float(b1[f]);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              float h = acc[mi][nj][2 * half + e];
              h = (Q ? h * sc : h) + bias;
              h = 0.5f * h * (1.f + erff(h * 0.70710678118654752f));
              hs[(mi * 16 + g + half * 8) * LDA + col + e] = __float2bfloat16_rn(h);
            }
        }
      }
      zero();
    } else if (c >= nk) {
      // fc2 partial of 64 output columns: (* s2), to this slice's scratch
      const int n0 = (c - nk) * KC;
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        const int col = n0 + (warp * 2 + nj) * 8 + t * 2;
        const float sc0 = Q ? s2[col] : 1.f, sc1 = Q ? s2[col + 1] : 1.f;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = m0 + mi * 16 + g + half * 8;
            if (row < M)
              *reinterpret_cast<float2*>(part + ((size_t)slice * M + row) * D + col) =
                  make_float2(acc[mi][nj][2 * half] * sc0, acc[mi][nj][2 * half + 1] * sc1);
          }
      }
      zero();
    }
  }
  cp_async_wait<0>();
}

// out = bf16(sum over slices, in order, + b2)
__global__ void __launch_bounds__(256)
    fused_mlp_combine(const float* __restrict__ part, const bf16* __restrict__ b2,
                      bf16* __restrict__ out, int M, int D, int n_slices) {
  const size_t i = (size_t)blockIdx.x * 256 + threadIdx.x, n = (size_t)M * D;
  if (i >= n) return;
  float s = 0.f;
  for (int j = 0; j < n_slices; ++j) s += part[j * n + i];
  out[i] = __float2bfloat16_rn(s + __bfloat162float(b2[i % D]));
}

template <bool Q>
int launch(const void* x, const void* w1, const void* s1, const void* b1, const void* w2,
           const void* s2, const void* b2, void* out, void* part, int M, int D, int F,
           cudaStream_t stream) {
  if (M < 1 || D % KC || F % FS) return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(fused_mlp_kernel<Q>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Layout<Q>::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int n_slices = F / FS;
  fused_mlp_kernel<Q><<<dim3(n_slices, (M + MB - 1) / MB), THREADS, Layout<Q>::SMEM, stream>>>(
      static_cast<const bf16*>(x), w1, static_cast<const float*>(s1),
      static_cast<const bf16*>(b1), w2, static_cast<const float*>(s2),
      static_cast<float*>(part), M, D, F);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t n = (size_t)M * D;
  fused_mlp_combine<<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const bf16*>(b2), static_cast<bf16*>(out),
      M, D, n_slices);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [M, D] bf16; w1 [F, D], w2 [D, F] bf16; b1 [F], b2 [D] bf16;
// out [M, D] bf16; part [F / 64, M, D] fp32 scratch. D and F multiples of 64.
extern "C" int fused_mlp_bf16(const void* x, const void* w1, const void* b1, const void* w2,
                              const void* b2, void* out, void* part, int M, int D, int F,
                              void* stream) {
  return launch<false>(x, w1, nullptr, b1, w2, nullptr, b2, out, part, M, D, F,
                       static_cast<cudaStream_t>(stream));
}

// The int8 entry: w1, w2 int8 with per-output-channel scales s1 [F], s2 [D] fp32.
extern "C" int fused_mlp_int8(const void* x, const void* w1, const void* s1, const void* b1,
                              const void* w2, const void* s2, const void* b2, void* out,
                              void* part, int M, int D, int F, void* stream) {
  return launch<true>(x, w1, s1, b1, w2, s2, b2, out, part, M, D, F,
                      static_cast<cudaStream_t>(stream));
}
