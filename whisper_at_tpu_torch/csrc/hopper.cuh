// Hopper's copy engine for the kernels of this package: mbarriers, TMA box
// copies through tensor maps, 1-D bulk copies, and the host's encoding of
// a tensor map, and the cluster's barrier and distributed shared memory.
// Used by attn_sm90.cuh (K1, K7), cross_decode_stream.cu (K10) and
// cross_decode.cu (K4).
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
