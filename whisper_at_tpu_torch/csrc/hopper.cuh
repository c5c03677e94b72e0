// Hopper's copy engine and tensor cores for the kernels of this package:
// mbarriers, TMA box loads and stores through tensor maps, 1-D bulk
// copies, the host's encoding of a tensor map, the cluster's barrier and
// distributed shared memory, and the wgmma descriptors, fences and the
// m64n128k16 product with both operands in shared memory, and programmatic
// dependent launch. Used by attn_sm90.cuh (K1, K7), gemm_sm90.cuh (K2, K3),
// cross_decode_stream.cu (K10), cross_decode.cu (K4), fused_mlp.cu (K8),
// dtw.cu (K6) and flash_decode.cu (K9).
//
// Shared memory is addressed by 32-bit shared-window addresses (smem_u32).
// The tensor maps are encoded on the host per call, by the driver's
// cuTensorMapEncodeTiled. The shared build flags do not link -lcuda, so the
// function is taken from the runtime: cudaGetDriverEntryPointByVersion on
// CUDA >= 12.5, else cudaGetDriverEntryPoint with its query-result argument
// (CUDA 12.0-12.4). A toolkit with neither signature fails at build time.
// A map that does not encode returns ENCODE_ERROR + the CUresult.
//
// Everything here has internal linkage: each kernel library holds its own
// copy, and a static of one (encode_function's `cached`) is never bound to
// another library's.
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace {

constexpr int ENCODE_ERROR = 10000;

// ---- device: shared memory, mbarriers, copies ----------------------------- //
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// makes the barriers' initialisation visible to the copy engine
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects `bytes` of copies to complete on bar
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait for the completion of the barrier's phase of this parity; a wait of
// over 2^31 clocks (~1 s) traps, so a lost copy fails the launch instead of
// hanging the card (a 32-bit clock keeps one register, not two, live)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const uint32_t start = static_cast<uint32_t>(clock());
  uint32_t done = 0;
  while (!done) {
    if (static_cast<uint32_t>(clock()) - start > (1u << 31)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// mbar_wait by a whole warp, converged again before what follows (.aligned
// instructions, warp shuffles)
__device__ __forceinline__ void warp_wait(uint32_t bar, uint32_t parity) {
  mbar_wait(bar, parity);
  __syncwarp();
}

// mbar_wait for a phase completed by other blocks of the cluster (st_async),
// acquiring at cluster scope what they wrote; the same trap
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  const uint32_t start = static_cast<uint32_t>(clock());
  uint32_t done = 0;
  while (!done) {
    if (static_cast<uint32_t>(clock()) - start > (1u << 31)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// ---- device: programmatic dependent launch -------------------------------- //
// lets the next kernel of the stream, launched with the programmatic stream
// serialization attribute, start once every block of this grid has issued it
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// waits until the grids this one depends on have completed and their writes
// are visible (returns at once in a kernel launched without the attribute)
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// ---- device: thread block clusters ------------------------------------------ //
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// the cluster barrier in two halves: arrive (releasing this thread's writes,
// barrier initialisations included), then wait for every thread of the
// cluster that has not exited to have arrived
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// the address in block `rank`'s shared memory of a shared address of this block
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// 4 bytes into another block's shared memory at `remote`, completing on its
// barrier `remote_bar` (both addresses from map_rank)
__device__ __forceinline__ void st_async(uint32_t remote, float v, uint32_t remote_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(remote),
      "r"(__float_as_uint(v)), "r"(remote_bar)
      : "memory");
}

// 8 bytes {a, b} into another block's shared memory at `remote` (8-byte
// aligned), completing on its barrier `remote_bar`
__device__ __forceinline__ void st_async2(uint32_t remote, float a, float b,
                                          uint32_t remote_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], {%1, %2}, [%3];\n" ::
          "r"(remote),
      "r"(__float_as_uint(a)), "r"(__float_as_uint(b)), "r"(remote_bar)
      : "memory");
}

// fetches a tensor map (a __grid_constant__ kernel parameter) ahead of its
// first copy
__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// the box of `map` at coordinates {c0, c1, c2} into shared memory at dst;
// its bytes (the whole box, parts outside the tensor zero-filled) complete
// on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from src into
// shared memory at dst; they complete on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ---- TMA stores and shared stores ------------------------------------------ //
// shared memory at src into the box of `map` at {c0, c1, c2} (elements
// outside the tensor are not written), committed as one bulk group of the
// calling thread
__device__ __forceinline__ void tma_store_async(const CUtensorMap* map, uint32_t src, int c0,
                                                int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until at most N of the calling thread's bulk groups have yet to
// finish reading shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// wait until every bulk group of the calling thread has completed
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// tma_store_async that returns once the copy has read shared memory
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2) {
  tma_store_async(map, src, c0, c1, c2);
  bulk_wait_read<0>();
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t value) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(value) : "memory");
}

// orders this thread's shared-memory writes before later copies by the
// async proxy (a TMA store of them, a wgmma reading them)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the named barrier `id` (1-15; 0 is __syncthreads) over `count` threads
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---- wgmma ---------------------------------------------------------------- //
// Descriptor of a tile of 128-byte rows in 128-byte swizzle, 1024-byte
// aligned at its 8-row groups: start address >> 4 (bits 0-13), leading
// byte offset 16 (bits 16-29; no tile here spans two swizzle columns, so it
// is not read), stride byte offset 1024 between 8-row groups (bits 32-45),
// layout 128B swizzle (bits 62-63). The same fields serve K-major tiles
// (8-row groups along M or N; a 16-wide k-step is +32 bytes: attention's Q
// and K, the GEMM's A and B) and MN-major ones (8-row groups along K; a
// 16-row k-step is +2048: attention's V).
// Only the low word depends on the tile; the wgmma wrappers below take it
// and add the constant high word, so a descriptor costs one register.
constexpr uint64_t DESC_HI = (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);

__device__ __forceinline__ uint32_t desc_lo(uint32_t tile) {
  return ((tile & 0x3FFFF) >> 4) | (1u << 16);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the wait that returns them
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]));
}

static_assert(DESC_HI == 0x4000004000000000ull, "the wgmma wrappers below inline DESC_HI");

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B K-major in shared memory
// (descriptor low words a_lo, b_lo); D is overwritten when accumulate is 0
__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64], uint32_t a_lo, uint32_t b_lo,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "cvt.u64.u32 da, %64; or.b64 da, da, 0x4000004000000000;\n"
      "cvt.u64.u32 db, %65; or.b64 db, db, 0x4000004000000000;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "da, db, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a_lo), "r"(b_lo), "r"(accumulate));
}

// ---- host: tensor maps -------------------------------------------------------- //
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline cudaError_t encode_function(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// the 3-D map of a contiguous tensor [d2, d1, d0] (innermost d0 elements of
// `elem` bytes) whose box is {b0, b1, 1}; 0, or ENCODE_ERROR + the CUresult
inline int encode_3d(EncodeTiled fn, CUtensorMap* map, CUtensorMapDataType type, int elem,
                     const void* base, int d0, int d1, int d2, int b0, int b1,
                     CUtensorMapSwizzle swizzle, CUtensorMapL2promotion promotion) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0), static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d0) * elem,
                                 static_cast<cuuint64_t>(d1) * d0 * elem};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(b0), static_cast<cuuint32_t>(b1), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult res = fn(map, type, 3, const_cast<void*>(base), dims, strides, box, step,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, promotion,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : ENCODE_ERROR + static_cast<int>(res);
}

}  // namespace
