"""K4: decode-step cross-attention over the int8 or int4 cross-KV of K3.

Replaces `whisper_at_tpu/ops/cross_decode.py::cross_attention_int8`
(Pallas), bits = 8 (`KERNEL`) and bits = 4 (`KERNEL4`, its own entry, over
codes packed by `models/layers.pack4`). The CUDA source is
`csrc/cross_decode.cu`: one block per (head, audio row), the K/V codes
streamed once and dequantized in registers, a two-pass fp32 softmax over
logits held in shared memory, the V scales folded into P. Its header gives
the bound.

Query rows are head-major: row h*G + g is head h, group row g (a prefill
token or a beam). The queries arrive pre-scaled by 64^-0.5.
"""

import ctypes

import torch

from ..models.layers import unpack4
from .cuda import CudaKernel, ptr, require_cuda, stream_handle

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
KERNEL = CudaKernel("cross_decode", "cross_decode.cu", "cross_decode_bf16", _ARGTYPES,
                    replaces="whisper_at_tpu/ops/cross_decode.py:175")
KERNEL4 = CudaKernel("cross_decode4", "cross_decode.cu", "cross_decode4_bf16", _ARGTYPES,
                     replaces="whisper_at_tpu/ops/cross_decode.py:175")
HEAD_DIM = 64
MAX_SMEM = 227 * 1024
NEG_BIG = -1e30


def pad_bias(ta: int, ta_pad: int, device) -> torch.Tensor:
    """Additive column mask [Ta_pad]: 0 on valid positions, -1e30 on padding."""
    bias = torch.zeros(ta_pad, device=device, dtype=torch.float32)
    bias[ta:] = NEG_BIG
    return bias


def cross_attention_int8_plain(q, kq, ks, vq, vs, bias, n_head: int) -> torch.Tensor:
    """The same function in plain PyTorch, in the reference's arithmetic:
    bf16 (or fp32) operands, fp32 products and softmax, pw = (p * vs) rounded
    to q.dtype before the value product."""
    a, hg, dh = q.shape
    g = hg // n_head
    ta_pad = kq.shape[1]
    qh = q.reshape(a, n_head, g, dh).float()
    k = kq.reshape(a, ta_pad, n_head, dh).permute(0, 2, 3, 1).to(q.dtype).float()
    logits = torch.matmul(qh, k) * ks[:, :, None, :] + bias
    p = torch.softmax(logits, dim=-1)
    pw = (p * vs[:, :, None, :]).to(q.dtype).float()
    v = vq.reshape(a, ta_pad, n_head, dh).permute(0, 2, 1, 3).to(q.dtype).float()
    return torch.matmul(pw, v).reshape(a, hg, dh)


def smem_bytes(groups: int, ta_pad: int) -> int:
    fn = KERNEL.c_function("cross_decode_smem_bytes", [ctypes.c_int, ctypes.c_int])
    return fn(groups, ta_pad)


def cross_attention_int4_plain(q, kp, ks, vp, vs, bias, n_head: int) -> torch.Tensor:
    """`cross_attention_int8_plain` over packed int4 codes."""
    return cross_attention_int8_plain(q, unpack4(kp), ks, unpack4(vp), vs, bias, n_head)


def cross_attention_int8(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                         vq: torch.Tensor, vs: torch.Tensor, bias: torch.Tensor,
                         n_head: int) -> torch.Tensor:
    """out [A, H*G, 64] fp32 = softmax(q k^T * ks + bias) (vs-weighted) v.

    q [A, H*G, 64]; kq, vq int8 [A, Ta_pad, H*64]; ks, vs fp32 [A, H, Ta_pad];
    bias fp32 [Ta_pad]."""
    if not q.is_cuda:
        return cross_attention_int8_plain(q, kq, ks, vq, vs, bias, n_head)
    return _launch(KERNEL, q, kq, ks, vq, vs, bias, n_head, 8)


def cross_attention_int4(q: torch.Tensor, kp: torch.Tensor, ks: torch.Tensor,
                         vp: torch.Tensor, vs: torch.Tensor, bias: torch.Tensor,
                         n_head: int) -> torch.Tensor:
    """`cross_attention_int8` over K3-int4's codes: kp, vp int8
    [A, Ta_pad, H*32], packed by `pack4`."""
    if not q.is_cuda:
        return cross_attention_int4_plain(q, kp, ks, vp, vs, bias, n_head)
    return _launch(KERNEL4, q, kp, ks, vp, vs, bias, n_head, 4)


def _launch(kernel, q, kq, ks, vq, vs, bias, n_head: int, bits: int) -> torch.Tensor:
    a, hg, dh = q.shape
    ta_pad = kq.shape[1]
    if dh != HEAD_DIM or hg % n_head:
        raise ValueError(f"bad query shape {tuple(q.shape)} for {n_head} heads")
    require_cuda(q, torch.bfloat16, "q", 3)
    row = n_head * HEAD_DIM * bits // 8
    for name, t in (("kq", kq), ("vq", vq)):
        require_cuda(t, torch.int8, name, 3)
        if tuple(t.shape) != (a, ta_pad, row):
            raise ValueError(f"{name} must be [{a}, {ta_pad}, {row}]")
    for name, t in (("ks", ks), ("vs", vs)):
        require_cuda(t, torch.float32, name, 3)
        if tuple(t.shape) != (a, n_head, ta_pad):
            raise ValueError(f"{name} must be [{a}, {n_head}, {ta_pad}]")
    require_cuda(bias, torch.float32, "bias", 1)
    groups = hg // n_head
    if smem_bytes(groups, ta_pad) > MAX_SMEM:
        raise ValueError(f"{groups} query rows per head exceed the kernel's shared memory")
    out = torch.empty((a, hg, dh), device=q.device, dtype=torch.float32)
    kernel.launch(ptr(q), ptr(kq), ptr(ks), ptr(vq), ptr(vs), ptr(bias), ptr(out),
                  a, n_head, groups, ta_pad, stream_handle(q.device))
    return out
