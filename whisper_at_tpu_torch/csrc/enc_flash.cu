// K7: non-causal encoder self-attention over [B, T, H*64] bf16 (T = 1500),
// the generic flash kernel's formulation: keys past T masked, the
// 64^-0.5 scale applied to the fp32 scores, P rounded to bf16 for P V,
// the output normalized in fp32, query rows past T not stored.
//
// Replaces whisper_at_tpu/ops/flash.py::encoder_flash_attention, which
// calls JAX's library flash-attention kernel for the TPU
// (WHISPER_AT_TPU_ENC_ATTN=flash) over T padded to a multiple of 512 with
// segment ids masking the padding. It computes K1's function and is its own
// entry beside K1 (csrc/enc_attention.cu), on the same template
// (attn_sm90.cuh: TMA ring of K/V tiles under mbarriers, wgmma for Q K^T
// from shared memory and for P V with P from registers, a producer
// warpgroup and consumer warpgroups). Keys at T .. T_pad contribute
// exp(-inf) = 0, so the kernel visits only the tiles that hold keys below T.
// What bounds it on the H100: 4*B*H*T*T*64 FLOP = 2.8e11 at large-v1 batch
// 24 (0.28 ms at 989 TFLOP/s) against ~0.37 GB of q/k/v/out (0.11 ms):
// operations, with one ex2 a score as a second floor of about the same
// size. At [24, 1500, 1280] on an H100 80GB HBM3 at 700 W chip_smoke.py
// timed it at 0.6538-0.6561 ms beside SDPA's 0.7251-0.7388 ms in the same
// process; the earlier design (mma.sync, a 3-stage cp.async ring, 128
// query rows a block) took 1.2558 ms.
#include "attn_sm90.cuh"

// q, k, v, out: contiguous [B, T, H*64] bf16.
extern "C" int enc_flash_bf16(const void* q, const void* k, const void* v, void* out, int B,
                              int T, int H, float scale, void* stream) {
  return attn_sm90::run(q, k, v, out, B, T, H, scale, stream);
}
