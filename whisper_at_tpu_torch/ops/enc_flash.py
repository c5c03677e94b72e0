"""K7: encoder self-attention in the generic flash kernel's formulation.

Replaces `whisper_at_tpu/ops/flash.py::encoder_flash_attention`, which
calls JAX's library flash-attention kernel for the TPU. It computes K1's
function (`ops/enc_attention.py`) with that kernel's arithmetic: T padded
to a multiple of 512 with the padded keys masked, the 64^-0.5 scale applied
to the fp32 scores, P = exp(S - max) rounded to q's dtype for the value
product, the output normalized in fp32, padded query rows dropped. The
CUDA source is `csrc/enc_flash.cu`, on K1's template `csrc/attn_sm90.cuh`
(TMA ring, wgmma, warp-specialised) with the shape that won for both;
its header gives the bound.

`models/encoder.py` runs it for attn_impl="flash"
(WHISPER_AT_TPU_ENC_ATTN=flash).
"""

import ctypes

import torch

from .cuda import CudaKernel, ptr, require_cuda, stream_handle

KERNEL = CudaKernel(
    "enc_flash", "enc_flash.cu", "enc_flash_bf16",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p],
    replaces="whisper_at_tpu/ops/flash.py:63",
)
HEAD_DIM = 64
BLOCK = 512  # the JAX kernel's block: T is padded to a multiple of it


def enc_flash_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    n_head: int) -> torch.Tensor:
    """The same function in plain PyTorch, in the flash kernel's rounding."""
    b, t, d = q.shape
    dh = d // n_head
    t_pad = -(-t // BLOCK) * BLOCK

    def split(x):
        x = x.reshape(b, t, n_head, dh).transpose(1, 2)
        return torch.nn.functional.pad(x, (0, 0, 0, t_pad - t))

    qh, kh, vh = split(q), split(k), split(v)
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * dh ** -0.5
    s[..., t:] = float("-inf")
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.matmul(p.to(q.dtype).float(), vh.float()) / p.sum(dim=-1, keepdim=True)
    return o[:, :, :t].transpose(1, 2).reshape(b, t, d).to(q.dtype)


def enc_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              n_head: int) -> torch.Tensor:
    """softmax(q k^T / sqrt(64)) v per head; q, k, v [B, T, H*64] -> [B, T, H*64]."""
    if not q.is_cuda:
        return enc_flash_plain(q, k, v, n_head)
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
