"""K10: K4's function with an online softmax over streamed chunks of Ta.

Replaces `whisper_at_tpu/ops/cross_decode_stream.py::
cross_attention_int8_stream` (Pallas), bits = 8 (`KERNEL`) and bits = 4
(`KERNEL4`). It takes K4's contract (`ops/cross_decode.py`): q [A, H*G, 64]
pre-scaled by 64^-0.5 with head-major rows, codes in K3's row-major layout
[A, Ta_pad, H*64] int8 (or packed by `models/layers.pack4`, [A, Ta_pad,
H*32]), scales [A, H, Ta_pad] fp32, pad bias [Ta_pad]. It differs from K4
in its softmax: K and V are read together, chunk by chunk, with the running
max and sum rescaled per chunk (the TPU kernel's recurrence), so no Ta-sized
logits buffer exists. The CUDA source is `csrc/cross_decode_stream.cu` (a
4-stage cp.async ring of 64-position chunks); its header gives the bound.

`models/decoder.py` selects it in place of K4 with
WHISPER_AT_TPU_CROSS_DECODE=stream.
"""

import ctypes

import torch

from ..models.layers import unpack4
from .cross_decode import HEAD_DIM, NEG_BIG
from .cuda import CudaKernel, ptr, require_cuda, stream_handle

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_REPLACES = "whisper_at_tpu/ops/cross_decode_stream.py:218"
KERNEL = CudaKernel("cross_decode_stream", "cross_decode_stream.cu", "cross_decode_stream_bf16",
                    _ARGTYPES, replaces=_REPLACES)
KERNEL4 = CudaKernel("cross_decode_stream4", "cross_decode_stream.cu",
                     "cross_decode_stream4_bf16", _ARGTYPES, replaces=_REPLACES)
CHUNK = 64  # positions per ring stage of the kernel


def cross_attention_stream_plain(q, kq, ks, vq, vs, bias, n_head: int) -> torch.Tensor:
    """The same function in plain PyTorch, in the kernel's arithmetic: per
    chunk of CHUNK positions, logits = (q . k) * ks + bias in fp32, the
    running max m and sum l rescaled by alpha = exp(m_old - m), pw =
    bf16(exp(logits - m) * vs) (q.dtype), acc = acc * alpha + pw v in fp32;
    out = acc / l."""
    a, hg, dh = q.shape
    g = hg // n_head
    ta_pad = kq.shape[1]
    qh = q.reshape(a, n_head, g, dh).float()
    m = torch.full((a, n_head, g, 1), NEG_BIG, device=q.device)
    l = torch.zeros((a, n_head, g, 1), device=q.device)
    acc = torch.zeros((a, n_head, g, dh), device=q.device)
    for t0 in range(0, ta_pad, CHUNK):
        sl = slice(t0, t0 + CHUNK)
        k = kq[:, sl].reshape(a, -1, n_head, dh).permute(0, 2, 3, 1).to(q.dtype).float()
        logits = torch.matmul(qh, k) * ks[:, :, None, sl] + bias[sl]
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        pw = (p * vs[:, :, None, sl]).to(q.dtype).float()
        v = vq[:, sl].reshape(a, -1, n_head, dh).permute(0, 2, 1, 3).to(q.dtype).float()
        acc = acc * alpha + torch.matmul(pw, v)
        m = m_new
    return (acc / l).reshape(a, hg, dh)


def cross_attention_stream4_plain(q, kp, ks, vp, vs, bias, n_head: int) -> torch.Tensor:
    """`cross_attention_stream_plain` over packed int4 codes."""
    return cross_attention_stream_plain(q, unpack4(kp), ks, unpack4(vp), vs, bias, n_head)


def cross_attention_stream(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                           vq: torch.Tensor, vs: torch.Tensor, bias: torch.Tensor,
                           n_head: int) -> torch.Tensor:
    """out [A, H*G, 64] fp32, K4's contract (`cross_decode.cross_attention_int8`)."""
    if not q.is_cuda:
        return cross_attention_stream_plain(q, kq, ks, vq, vs, bias, n_head)
    return _launch(KERNEL, q, kq, ks, vq, vs, bias, n_head, 8)


def cross_attention_stream4(q: torch.Tensor, kp: torch.Tensor, ks: torch.Tensor,
                            vp: torch.Tensor, vs: torch.Tensor, bias: torch.Tensor,
                            n_head: int) -> torch.Tensor:
    """`cross_attention_stream` over K3-int4's codes: kp, vp int8
    [A, Ta_pad, H*32], packed by `pack4`."""
    if not q.is_cuda:
        return cross_attention_stream4_plain(q, kp, ks, vp, vs, bias, n_head)
    return _launch(KERNEL4, q, kp, ks, vp, vs, bias, n_head, 4)


def _launch(kernel, q, kq, ks, vq, vs, bias, n_head: int, bits: int) -> torch.Tensor:
    a, hg, dh = q.shape
    ta_pad = kq.shape[1]
    if dh != HEAD_DIM or hg % n_head:
        raise ValueError(f"bad query shape {tuple(q.shape)} for {n_head} heads")
    if ta_pad % CHUNK:
        raise ValueError(f"Ta_pad {ta_pad} is not a multiple of the kernel's chunk {CHUNK}")
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
    if bias.shape[0] != ta_pad:
        raise ValueError(f"bias must be [{ta_pad}]")
    out = torch.empty((a, hg, dh), device=q.device, dtype=torch.float32)
    kernel.launch(ptr(q), ptr(kq), ptr(ks), ptr(vq), ptr(vs), ptr(bias), ptr(out),
                  a, n_head, hg // n_head, ta_pad, stream_handle(q.device))
    return out
