// K9: split-S flash decode, single-query attention over int8 K/V with
// per-(row, position) fp32 scales:
//   out [BH, 64] = softmax((q * 64^-0.5) . k * ks) (p * vs) . v
// over the first S positions, fp32 throughout, the output in q's type.
//
// Replaces whisper_at_tpu/ops/flash_decode.py::flash_decode_cross (Pallas,
// TPU), whose grid walks the key axis in order on one core, carrying the
// running max, sum and accumulator of a tile of rows in VMEM scratch. Blocks
// on Hopper run in no order, so the key axis is split instead
// (flash-decoding): a partial kernel over (split, head tile, audio row) runs
// every split in parallel and writes its (m, l, acc) to scratch the wrapper
// allocates; a combine kernel merges the splits of each row in a fixed
// order (deterministic: no atomics).
//
// The K/V are in K3's row-major layout [A, S_pad, H*64] (one position's
// heads side by side), so the wrapper feeds it the decode path's own
// cross-K/V at one query row per head; row bh of q is (audio row bh / H,
// head bh % H).
//
// Partial kernel: a block of 4 warps serves 4 heads of one audio row over
// SPLIT = 256 positions; each warp one head. Per tile of 32 positions a
// lane owns one position: it reads that position's 64 codes (four 16-byte
// loads), forms the fp32 logit with q from shared memory, and the warp
// updates the online softmax; then the warp sums p * vs * v over the 32
// positions, each lane owning 2 of the 64 columns (coalesced 64-byte rows).
// What bounds it on the H100: the bytes, as K4. At large-v1 batch 24 the
// 1500 valid positions' int8 K and V (92 MB) and scales (5.8 MB) need
// ~0.029 ms at 3.35 TB/s; the scratch (6 splits x 480 rows x 66 floats,
// 0.8 MB) is small beside them. Each code is read once.
#include "common.cuh"

namespace {

constexpr int DH = 64;
constexpr int HT = 4;        // heads per block, one warp each
constexpr int SPLIT = 256;   // positions per split
constexpr float NEG_BIG = -1e30f;

__global__ void __launch_bounds__(HT * 32)
    flash_decode_partial(const bf16* __restrict__ q, const int8_t* __restrict__ kq,
                         const float* __restrict__ ks, const int8_t* __restrict__ vq,
                         const float* __restrict__ vs, float* __restrict__ part_ml,
                         float* __restrict__ part_acc, int H, int S_pad, int S, int n_split) {
  __shared__ float qs[HT][DH];
  const int j = blockIdx.x, a = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.y * HT + warp;
  if (h >= H) return;  // no block barrier below
  const int bh = a * H + h;
  const float scale = 0.125f;  // 64^-0.5
  for (int d = lane; d < DH; d += 32)
    qs[warp][d] = __bfloat162float(
        __float2bfloat16_rn(__bfloat162float(q[(size_t)bh * DH + d]) * scale));
  __syncwarp();

  const int row_bytes = H * DH;
  const int8_t* kbase = kq + (size_t)a * S_pad * row_bytes + h * DH;
  const int8_t* vbase = vq + (size_t)a * S_pad * row_bytes + h * DH;
  const float* ksr = ks + (size_t)bh * S_pad;
  const float* vsr = vs + (size_t)bh * S_pad;
  const int begin = j * SPLIT, end = min(begin + SPLIT, S);

  float m = NEG_BIG, l = 0.f, acc0 = 0.f, acc1 = 0.f;
  for (int base = begin; base < end; base += 32) {
    const int t = base + lane;
    float logit = NEG_BIG;
    if (t < end) {
      const int4* kp = reinterpret_cast<const int4*>(kbase + (size_t)t * row_bytes);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < DH / 16; ++i) {
        const int4 w = kp[i];
        const int8_t* e = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
        for (int c = 0; c < 16; ++c)
          dot = fmaf(qs[warp][i * 16 + c], static_cast<float>(e[c]), dot);
      }
      logit = dot * ksr[t];
    }
    const float m_new = fmaxf(m, warp_max(logit));
    const float corr = expf(m - m_new);
    const float p = expf(logit - m_new);
    l = l * corr + warp_sum(p);
    m = m_new;
    const float pv = t < end ? p * vsr[t] : 0.f;
    acc0 *= corr;
    acc1 *= corr;
    const int n = min(32, end - base);
#pragma unroll 8
    for (int i = 0; i < n; ++i) {
      const float w = __shfl_sync(0xffffffffu, pv, i);
      const char2 c =
          *reinterpret_cast<const char2*>(vbase + (size_t)(base + i) * row_bytes + 2 * lane);
      acc0 = fmaf(w, static_cast<float>(c.x), acc0);
      acc1 = fmaf(w, static_cast<float>(c.y), acc1);
    }
  }
  const size_t slot = (size_t)bh * n_split + j;
  if (lane == 0) {
    part_ml[2 * slot] = m;
    part_ml[2 * slot + 1] = l;
  }
  *reinterpret_cast<float2*>(part_acc + slot * DH + 2 * lane) = make_float2(acc0, acc1);
}

// one warp per row: merge its splits in order j = 0, 1, ...
__global__ void __launch_bounds__(128)
    flash_decode_combine(const float* __restrict__ part_ml, const float* __restrict__ part_acc,
                         bf16* __restrict__ out, int BH, int n_split) {
  const int bh = blockIdx.x * 4 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (bh >= BH) return;
  const float* ml = part_ml + (size_t)bh * n_split * 2;
  float mx = NEG_BIG;
  for (int j = 0; j < n_split; ++j) mx = fmaxf(mx, ml[2 * j]);
  float l = 0.f, o0 = 0.f, o1 = 0.f;
  for (int j = 0; j < n_split; ++j) {
    const float w = expf(ml[2 * j] - mx);
    const float2 acc = *reinterpret_cast<const float2*>(
        part_acc + ((size_t)bh * n_split + j) * DH + 2 * lane);
    l = fmaf(ml[2 * j + 1], w, l);
    o0 = fmaf(acc.x, w, o0);
    o1 = fmaf(acc.y, w, o1);
  }
  *reinterpret_cast<__nv_bfloat162*>(out + (size_t)bh * DH + 2 * lane) =
      __floats2bfloat162_rn(o0 / l, o1 / l);
}

}  // namespace

// Splits of S positions the partial kernel uses (the wrapper sizes the
// scratch with it).
extern "C" int flash_decode_splits(int S) { return (S + SPLIT - 1) / SPLIT; }

// q [A*H, 64] bf16 (not pre-scaled); kq, vq [A, S_pad, H*64] int8;
// ks, vs [A, H, S_pad] fp32; positions >= S are masked; out [A*H, 64] bf16;
// part_ml [A*H, n_split, 2] and part_acc [A*H, n_split, 64] fp32 scratch.
extern "C" int flash_decode_bf16(const void* q, const void* kq, const void* ks, const void* vq,
                                 const void* vs, void* out, void* part_ml, void* part_acc,
                                 int A, int H, int S_pad, int S, void* stream) {
  if (S < 1 || S > S_pad) return static_cast<int>(cudaErrorInvalidValue);
  const int n_split = flash_decode_splits(S);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  flash_decode_partial<<<dim3(n_split, (H + HT - 1) / HT, A), HT * 32, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const int8_t*>(kq),
      static_cast<const float*>(ks), static_cast<const int8_t*>(vq),
      static_cast<const float*>(vs), static_cast<float*>(part_ml),
      static_cast<float*>(part_acc), H, S_pad, S, n_split);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int bh = A * H;
  flash_decode_combine<<<(bh + 3) / 4, 128, 0, st>>>(
      static_cast<const float*>(part_ml), static_cast<const float*>(part_acc),
      static_cast<bf16*>(out), bh, n_split);
  return static_cast<int>(cudaGetLastError());
}
