// K1: non-causal encoder self-attention over [B, T, H*64] bf16, T = 1500.
//
// Replaces whisper_at_tpu/ops/flash_enc.py::encoder_attention (Pallas, TPU).
// The TPU kernel holds the whole fp32 [1536, 1536] score tile of one
// (batch, head) in VMEM (9.4 MB) and uses a constant softmax shift, exp2
// and a ones column of V to save VPU passes. None of that fits or pays on
// Hopper (227 KB of shared memory per block): this is a tiled online
// softmax with a real running max on the template of attn_sm90.cuh (Q, K
// and V by TMA through 3-D tensor maps into an mbarrier-guarded ring, both
// products on wgmma with P from registers and V as the transposed B
// operand, one producer and three consumer warpgroups). Numerics: QK^T on
// the tensor cores (bf16 in, fp32 accumulate), scores scaled and soft-maxed
// in fp32, P rounded to bf16 for the P V product (fp32 accumulate), output
// normalized in fp32. Keys at t >= T are masked (-inf); query rows at
// t >= T are not stored.
// What bounds it on the H100: 4*B*H*T*T*64 FLOP = 2.8e11 at large-v1 batch
// 24 (0.28 ms at 989 TFLOP/s) against ~0.37 GB of q/k/v/out (0.11 ms), so
// it is compute-bound; one ex2 a score is a second floor of about the same
// size (attn_sm90.cuh). Its three consumer warpgroups keep 128 registers
// a thread, too few to hold S, P and O at once, so each runs its softmax
// between its products and the three overlap one another. At
// [24, 1500, 1280] on an H100 80GB HBM3 at 700 W chip_smoke.py timed it at
// 0.6537-0.6594 ms beside SDPA's 0.7304-0.7404 ms in the same process; the
// earlier design (mma.sync from plain shared-memory loads, 64 query rows a
// block) took 2.3927 ms.
#include "attn_sm90.cuh"

// q, k, v, out: contiguous [B, T, H*64] bf16.
extern "C" int enc_attention_bf16(const void* q, const void* k, const void* v, void* out, int B,
                                  int T, int H, float scale, void* stream) {
  return attn_sm90::run(q, k, v, out, B, T, H, scale, stream);
}
