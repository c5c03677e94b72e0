// K9: split-S flash decode, single-query attention over int8 K/V with
// per-(row, position) fp32 scales:
//   out [BH, 64] = softmax((q * 64^-0.5) . k * ks) (p * vs) . v
// over the first S positions, fp32 throughout, the output in q's type.
//
// Replaces whisper_at_tpu/ops/flash_decode.py::flash_decode_cross (Pallas,
// TPU), whose grid walks the key axis in order on one core, carrying the
// running max, sum and accumulator of a tile of rows in VMEM scratch. Blocks
// on Hopper run in no order, so the key axis is split instead
// (flash-decoding): each run of the positions keeps its own online (m, l,
// acc) and the runs are merged in a fixed order (deterministic: no atomics).
//
// The K/V are in K3's row-major layout [A, S_pad, H*64] (one position's
// heads side by side), so the decode path's own cross-K/V feed it at one
// query row per head; row bh of q is (audio row bh / H, head bh % H).
//
// What bounds it on the H100: the bytes, as K4. At large-v1 batch 24 the
// 1500 valid positions' int8 K and V (92 MB) and scales (5.8 MB) need
// ~0.029 ms at 3.35 TB/s; each code is read once. The arithmetic (~1.8e8
// FLOP) is small beside them.
//
// Design (hopper.cuh's copy engine, as K4 and K10):
//  - A block serves one (head, audio row, run of the positions); the runs
//    (`n_split` of `per_split` stages of CHUNK = 128 positions) are the
//    blocks of one cluster (grid z, launch attribute), chosen by the wrapper
//    so that the grid fills the card (ops/flash_decode.py: `plan`): one run
//    at batch 24 (480 blocks, four an SM), six at one audio row.
//  - One producer lane streams the run's stages through a ring of RING
//    stages, each the K codes (TMA, box {64, 128} in the 64-byte swizzle),
//    the V codes (box {64, 128}) and both scale rows (boxes {128} of a map
//    of [A, H, S_pad]), with a `full` and an `empty` barrier a stage, so
//    the copies run up to RING stages ahead of the consumers.
//  - Four consumer warps take 32 positions of each stage, one a lane, and
//    each keeps its own online (m, l, acc): the lane's logit from its
//    position's 64 codes in shared memory and q in fp32; the warp's max,
//    the correction, p and its sum by shuffles; then out += (p * vs) . v
//    over the warp's 32 staged rows, 16 lanes x 4 columns, two positions at
//    a time (whole rows from shared memory, no dependent global loads).
//  - The warps' states merge in warp order in the block, the runs' in rank
//    order in rank 0 of the cluster, which the other ranks reach by st.async
//    into its shared memory: one launch, no scratch, no atomics.
#include "codes.cuh"
#include "hopper.cuh"

namespace {

constexpr int DH = 64;
constexpr int NW = 4;                    // consumer warps
constexpr int CONSUMERS = 32 * NW;
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int CHUNK = 128;               // positions of a stage
constexpr int PW = CHUNK / NW;           // positions of a stage a consumer warp
constexpr int RING = 3;                  // stages in flight
constexpr int MAX_SPLIT = 8;             // blocks of a cluster
constexpr int BLOCKS_PER_SM = 4;         // ops/flash_decode.py's plan counts on it
constexpr int STATE = 2 + DH;            // m, l, acc[64]
constexpr float NEG_BIG = -1e30f;

// a stage: K codes [CHUNK][64] (64-byte swizzle), V codes [CHUNK][64], ks
// and vs [CHUNK] fp32
constexpr int K_OFF = 0, V_OFF = CHUNK * DH, KS_OFF = 2 * CHUNK * DH, VS_OFF = KS_OFF + 4 * CHUNK;
constexpr int STRIDE = VS_OFF + 4 * CHUNK;  // 17 KB, a multiple of 1024
// after the ring: q [64] fp32, p * vs [NW][PW] fp32, the other runs' states
// [MAX_SPLIT - 1][STATE] (rank 0), the barriers full[RING], empty[RING] and
// the runs' one; the warps' states [NW][STATE] reuse the ring at the end
constexpr int QS_OFF = RING * STRIDE;
constexpr int PW_OFF = QS_OFF + 4 * DH;
constexpr int XST_OFF = PW_OFF + 4 * NW * PW;
constexpr int BAR_OFF = (XST_OFF + 4 * (MAX_SPLIT - 1) * STATE + 7) / 8 * 8;
constexpr int SMEM = 1024 + BAR_OFF + 8 * (2 * RING + 1);  // 1024: alignment of the base
static_assert(STRIDE % 1024 == 0, "stages keep the swizzle's alignment");
static_assert(BLOCKS_PER_SM * (SMEM + 1024) <= 228 * 1024, "BLOCKS_PER_SM blocks an SM");

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    flash_decode_kernel(const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const __grid_constant__ CUtensorMap ksmap,
                        const __grid_constant__ CUtensorMap vsmap, const bf16* __restrict__ q,
                        bf16* __restrict__ out, int H, int S, int n_split, int per_split) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* qs = reinterpret_cast<float*>(base + QS_OFF);
  float* pws = reinterpret_cast<float*>(base + PW_OFF);
  float* xst = reinterpret_cast<float*>(base + XST_OFF);
  const uint32_t full0 = smem_u32(base + BAR_OFF), empty0 = full0 + 8 * RING,
                 xbar = empty0 + 8 * RING;

  const int h = blockIdx.x, a = blockIdx.y, tid = threadIdx.x;
  const int rank = n_split > 1 ? static_cast<int>(cluster_rank()) : 0;
  const int n_stages = (S + CHUNK - 1) / CHUNK;
  const int st0 = rank * per_split, ns = min(per_split, n_stages - st0);
  const int p_begin = st0 * CHUNK;
  const int warp = tid >> 5, lane = tid & 31;
  const size_t bh = (size_t)a * H + h;

  if (tid == 0) {
    for (int st = 0; st < RING; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, NW);
    }
    mbar_init(xbar, 1);
    mbar_fence_init();
    if (n_split > 1 && rank == 0) mbar_expect_tx(xbar, (n_split - 1) * STATE * 4);
  }
  if (tid < DH)  // q * 64^-0.5 rounded to q's type, as the JAX function
    qs[tid] = __bfloat162float(__float2bfloat16_rn(__bfloat162float(q[bh * DH + tid]) * 0.125f));
  __syncthreads();
  if (n_split > 1) cluster_arrive();  // the barriers exist before any block writes here

  if (warp == NW) {  // the producer
    if (lane == 0) {
      for (int j = 0; j < ns; ++j) {
        const int st = j % RING, use = j / RING, p0 = p_begin + j * CHUNK;
        const uint32_t stage = smem_u32(base) + st * STRIDE, full = full0 + 8 * st;
        if (j >= RING) mbar_wait(empty0 + 8 * st, (use & 1) ^ 1);
        mbar_expect_tx(full, STRIDE);
        tma_load(stage + K_OFF, &kmap, h * DH, p0, a, full);
        tma_load(stage + V_OFF, &vmap, h * DH, p0, a, full);
        tma_load(stage + KS_OFF, &ksmap, p0, h, a, full);
        tma_load(stage + VS_OFF, &vsmap, p0, h, a, full);
      }
    }
    return;
  }

  const int r = warp * PW + lane;                  // the lane's row of a stage
  const int dq = (lane & 15) * 4, sub = lane >> 4;  // V: 4 columns, even or odd positions
  float* pw = pws + warp * PW;
  float m = NEG_BIG, l = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int j = 0; j < ns; ++j) {
    const int st = j % RING;
    const unsigned char* stage = base + st * STRIDE;
    const float* ksc = reinterpret_cast<const float*>(stage + KS_OFF);
    const float* vsc = reinterpret_cast<const float*>(stage + VS_OFF);
    warp_wait(full0 + 8 * st, (j / RING) & 1);
    const bool valid = p_begin + j * CHUNK + r < S;
    float dot = 0.f;
#pragma unroll
    for (int u = 0; u < DH / 16; ++u) {  // 16-byte unit u of row r in the 64-byte swizzle
      const uint4 kw =
          *reinterpret_cast<const uint4*>(stage + K_OFF + r * DH + 16 * (u ^ ((r >> 1) & 3)));
      float kf[16];
      widen8(kw.x, kf), widen8(kw.y, kf + 4), widen8(kw.z, kf + 8), widen8(kw.w, kf + 12);
      const float4* qg = reinterpret_cast<const float4*>(qs + 16 * u);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 qv = qg[e];
        dot = fmaf(qv.x, kf[4 * e], dot);
        dot = fmaf(qv.y, kf[4 * e + 1], dot);
        dot = fmaf(qv.z, kf[4 * e + 2], dot);
        dot = fmaf(qv.w, kf[4 * e + 3], dot);
      }
    }
    const float logit = valid ? dot * ksc[r] : NEG_BIG;
    const float m_new = fmaxf(m, warp_max(logit));
    const float corr = expf(m - m_new);
    const float p = valid ? expf(logit - m_new) : 0.f;
    l = l * corr + warp_sum(p);
    m = m_new;
    pw[lane] = p * vsc[r];
    __syncwarp();
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] *= corr;
    const unsigned char* vrow = stage + V_OFF + warp * PW * DH;
#pragma unroll 4
    for (int i = 0; i < PW / 2; ++i) {
      const int t2 = 2 * i + sub;
      float v[4];
      widen8(*reinterpret_cast<const uint32_t*>(vrow + t2 * DH + dq), v);
      const float pp = pw[t2];
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] = fmaf(pp, v[e], acc[e]);
    }
    __syncwarp();  // every lane is done with the stage and with pw
    if (lane == 0) mbar_arrive(empty0 + 8 * st);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], 16);

  // ---- the warps' states in warp order, then the runs' in rank order ------ //
  consumers_sync();  // every warp is done with the ring, which the states reuse
  float* wst = reinterpret_cast<float*>(base);  // [NW][STATE]
  if (lane == 0) wst[warp * STATE] = m, wst[warp * STATE + 1] = l;
  if (lane < 16) {
#pragma unroll
    for (int e = 0; e < 4; ++e) wst[warp * STATE + 2 + dq + e] = acc[e];
  }
  consumers_sync();
  if (n_split > 1) cluster_wait();
  if (tid >= DH) return;
  float mb = wst[0];
#pragma unroll
  for (int w = 1; w < NW; ++w) mb = fmaxf(mb, wst[w * STATE]);
  float lb = 0.f, ob = 0.f;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const float c = expf(wst[w * STATE] - mb);
    lb = fmaf(wst[w * STATE + 1], c, lb);
    ob = fmaf(wst[w * STATE + 2 + tid], c, ob);
  }
  if (rank > 0) {
    float* slot = xst + (rank - 1) * STATE;
    const uint32_t bar0 = map_rank(xbar, 0);
    if (tid == 0) st_async2(map_rank(smem_u32(slot), 0), mb, lb, bar0);
    st_async(map_rank(smem_u32(slot + 2 + tid), 0), ob, bar0);
    return;
  }
  if (n_split > 1) {
    mbar_wait_cluster(xbar, 0);
    float mt = mb;
    for (int s = 1; s < n_split; ++s) mt = fmaxf(mt, xst[(s - 1) * STATE]);
    const float c0 = expf(mb - mt);
    lb *= c0, ob *= c0;
    for (int s = 1; s < n_split; ++s) {
      const float* x = xst + (s - 1) * STATE;
      const float c = expf(x[0] - mt);
      lb = fmaf(x[1], c, lb);
      ob = fmaf(x[2 + tid], c, ob);
    }
  }
  out[bh * DH + tid] = __float2bfloat16_rn(__fdiv_rn(ob, lb));
}

}  // namespace

// q [A*H, 64] bf16 (not pre-scaled); kq, vq [A, S_pad, H*64] int8;
// ks, vs [A, H, S_pad] fp32 (S_pad a multiple of 4: the scale rows' stride
// is a whole 16-byte unit for the copy engine); positions >= S are masked;
// out [A*H, 64] bf16. The first S positions split into n_split <= 8 runs
// of per_split stages of 128 positions, none empty, the blocks of one
// cluster.
extern "C" int flash_decode_bf16(const void* q, const void* kq, const void* ks, const void* vq,
                                 const void* vs, void* out, int A, int H, int S_pad, int S,
                                 int n_split, int per_split, void* stream) {
  const int n_stages = (S + CHUNK - 1) / CHUNK;
  if (A < 1 || H < 1 || S < 1 || S > S_pad || S_pad % 4 || n_split < 1 ||
      n_split > MAX_SPLIT || per_split < 1 || (n_split - 1) * per_split >= n_stages ||
      n_split * per_split < n_stages)
    return static_cast<int>(cudaErrorInvalidValue);
  EncodeTiled fn;
  const cudaError_t e = encode_function(&fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap km, vm, ksm, vsm;
  const auto promo = CU_TENSOR_MAP_L2_PROMOTION_L2_256B;
  int rc = encode_3d(fn, &km, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, kq, H * DH, S_pad, A, DH, CHUNK,
                     CU_TENSOR_MAP_SWIZZLE_64B, promo);
  if (rc == 0)
    rc = encode_3d(fn, &vm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, vq, H * DH, S_pad, A, DH, CHUNK,
                   CU_TENSOR_MAP_SWIZZLE_NONE, promo);
  if (rc == 0)
    rc = encode_3d(fn, &ksm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ks, S_pad, H, A, CHUNK, 1,
                   CU_TENSOR_MAP_SWIZZLE_NONE, promo);
  if (rc == 0)
    rc = encode_3d(fn, &vsm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, vs, S_pad, H, A, CHUNK, 1,
                   CU_TENSOR_MAP_SWIZZLE_NONE, promo);
  if (rc != 0) return rc;
  static bool configured = false;
  if (!configured) {
    const cudaError_t a = cudaFuncSetAttribute(
        flash_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (a != cudaSuccess) return static_cast<int>(a);
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H, A, n_split);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1, attr.val.clusterDim.y = 1, attr.val.clusterDim.z = n_split;
  cfg.attrs = &attr;
  cfg.numAttrs = n_split > 1 ? 1 : 0;
  const cudaError_t le = cudaLaunchKernelEx(&cfg, flash_decode_kernel, km, vm, ksm, vsm,
                                            static_cast<const bf16*>(q), static_cast<bf16*>(out),
                                            H, S, n_split, per_split);
  return static_cast<int>(le != cudaSuccess ? le : cudaGetLastError());
}
