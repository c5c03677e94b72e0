"""K9: split-S flash decode, single-query attention over int8 K/V.

Replaces `whisper_at_tpu/ops/flash_decode.py::flash_decode_cross` (Pallas),
an experiment that nothing in the JAX package calls; nothing in the port
calls this one either. It computes the JAX function exactly: q is scaled by
64^-0.5 in fp32 and rounded to q's dtype, logits = (q . k) * ks in fp32
with positions >= S masked, the softmax in fp32, p * vs and the value
product in fp32, the output in q's dtype.

The K/V come in K3's row-major layout (`ops/kv_quant.py`): codes [A, S_pad,
H*64] int8, scales [A, H, S_pad] fp32, so the decode path's own cross-K/V
feed it at one query row per head. The wrapper maps q's rows to heads: row
bh is (audio row bh // H, head bh % H). The JAX function's layout (codes
[BH, 64, S] for K, [BH, S, 64] for V) differs only in where the numbers lie.

The CUDA source is `csrc/flash_decode.cu`: a partial kernel over (split of
S, head tile, audio row) writes (m, l, acc) per split to scratch allocated
here, and a combine kernel merges the splits in a fixed order; one launch
count per call.
"""

import ctypes
from typing import Optional

import torch

from .cuda import CudaKernel, ptr, require_cuda, stream_handle

KERNEL = CudaKernel(
    "flash_decode", "flash_decode.cu", "flash_decode_bf16",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    replaces="whisper_at_tpu/ops/flash_decode.py:89",
)
HEAD_DIM = 64


def flash_decode_cross_plain(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                             vq: torch.Tensor, vs: torch.Tensor, n_head: int,
                             s: Optional[int] = None) -> torch.Tensor:
    """The same function in plain PyTorch (a one-pass softmax over the first
    s positions)."""
    a, s_pad = kq.shape[:2]
    s = s_pad if s is None else s
    dh = q.shape[1]
    qs = (q.float() * dh ** -0.5).to(q.dtype).float().reshape(a, n_head, 1, dh)
    k = kq[:, :s].reshape(a, s, n_head, dh).permute(0, 2, 3, 1).float()
    logits = torch.matmul(qs, k) * ks[:, :, None, :s]
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    v = vq[:, :s].reshape(a, s, n_head, dh).permute(0, 2, 1, 3).float()
    out = torch.matmul(p * vs[:, :, None, :s], v) / p.sum(dim=-1, keepdim=True)
    return out.reshape(a * n_head, dh).to(q.dtype)


def flash_decode_cross(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                       vq: torch.Tensor, vs: torch.Tensor, n_head: int,
                       s: Optional[int] = None) -> torch.Tensor:
    """out [A*H, 64] (q's dtype) = softmax((q * 64^-0.5) . k * ks)(p * vs) . v
    over positions < s (default S_pad). q [A*H, 64]; kq, vq int8
    [A, S_pad, H*64]; ks, vs fp32 [A, H, S_pad]."""
    if not q.is_cuda:
        return flash_decode_cross_plain(q, kq, ks, vq, vs, n_head, s)
    a, s_pad = kq.shape[:2]
    s = s_pad if s is None else s
    if not 0 < s <= s_pad:
        raise ValueError(f"s must be in [1, {s_pad}], got {s}")
    require_cuda(q, torch.bfloat16, "q", 2)
    if tuple(q.shape) != (a * n_head, HEAD_DIM):
        raise ValueError(f"q must be [{a * n_head}, {HEAD_DIM}], got {tuple(q.shape)}")
    for name, t in (("kq", kq), ("vq", vq)):
        require_cuda(t, torch.int8, name, 3)
        if tuple(t.shape) != (a, s_pad, n_head * HEAD_DIM):
            raise ValueError(f"{name} must be [{a}, {s_pad}, {n_head * HEAD_DIM}]")
    for name, t in (("ks", ks), ("vs", vs)):
        require_cuda(t, torch.float32, name, 3)
        if tuple(t.shape) != (a, n_head, s_pad):
            raise ValueError(f"{name} must be [{a}, {n_head}, {s_pad}]")
    n_split = KERNEL.c_function("flash_decode_splits", [ctypes.c_int])(s)
    part_ml = torch.empty((a * n_head, n_split, 2), device=q.device, dtype=torch.float32)
    part_acc = torch.empty((a * n_head, n_split, HEAD_DIM), device=q.device,
                           dtype=torch.float32)
    out = torch.empty_like(q)
    KERNEL.launch(ptr(q), ptr(kq), ptr(ks), ptr(vq), ptr(vs), ptr(out), ptr(part_ml),
                  ptr(part_acc), a, n_head, s_pad, s, stream_handle(q.device))
    return out
