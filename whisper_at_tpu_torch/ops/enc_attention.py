"""K1: encoder self-attention, non-causal, over [B, T, H*64].

Replaces `whisper_at_tpu/ops/flash_enc.py::encoder_attention` (Pallas). The
CUDA kernel is `csrc/enc_attention.cu`, an instance of the Hopper template
`csrc/attn_sm90.cuh` (TMA ring, wgmma for both products, warp-specialised;
the headers say what bounds it and why it is shaped so). `enc_attention`
launches it for CUDA tensors and runs the plain version for CPU tensors.
"""

import ctypes

import torch

from ..models.layers import attention
from .cuda import CudaKernel, ptr, require_cuda, stream_handle

KERNEL = CudaKernel(
    "enc_attention", "enc_attention.cu", "enc_attention_bf16",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p],
    replaces="whisper_at_tpu/ops/flash_enc.py:102",
)
HEAD_DIM = 64


def enc_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        n_head: int) -> torch.Tensor:
    """The same function in plain PyTorch: fp32 logits and softmax, the
    weights cast to q.dtype for the value product."""
    return attention(q, k, v, n_head)


def enc_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  n_head: int) -> torch.Tensor:
    """softmax(q k^T / sqrt(64)) v per head; q, k, v [B, T, H*64] -> [B, T, H*64]."""
    if not q.is_cuda:
        return enc_attention_plain(q, k, v, n_head)
    b, t, d = q.shape
    if d != n_head * HEAD_DIM:
        raise ValueError(f"the kernel takes heads of {HEAD_DIM}, got D={d}, H={n_head}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        require_cuda(x, torch.bfloat16, name, 3)
        if x.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(x.shape)} != q shape {tuple(q.shape)}")
    out = torch.empty_like(q)
    KERNEL.launch(ptr(q), ptr(k), ptr(v), ptr(out), b, t, n_head,
                  ctypes.c_float(HEAD_DIM ** -0.5), stream_handle(q.device))
    return out
