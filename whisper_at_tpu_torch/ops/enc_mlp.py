"""K2: the encoder MLP half-block  x + fc2(gelu(fc1(LN(x)))).

Replaces `whisper_at_tpu/ops/mlp_enc.py::mlp_block_fused` (Pallas). The CUDA
source is `csrc/enc_mlp.cu`: one call launches an LN kernel and two GEMMs on
`csrc/gemm_sm90.cuh` (persistent blocks, TMA, wgmma) with fused epilogues
(bias + erf-GELU, then bias + residual); its header says why the TPU's
single fused kernel was not carried over. `plan` picks each GEMM's block
width and grid.

K2-partial (`enc_mlp_partial`, its own entry `KERNEL_PARTIAL`) is a
tensor-parallel rank's share: its F = 4D / tp hidden units (fc1's rows,
fc2's columns), fc2's epilogue writing the partial sum alone, with no
residual and no b2, which the caller adds once after summing the ranks.
"""

import ctypes
import functools

import torch

from ..models.layers import gelu, layer_norm
from .cuda import CudaKernel, ptr, require_cuda, stream_handle

KERNEL = CudaKernel(
    "enc_mlp", "enc_mlp.cu", "enc_mlp_bf16",
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    replaces="whisper_at_tpu/ops/mlp_enc.py:93",
)

KERNEL_PARTIAL = CudaKernel(
    "enc_mlp_partial", "enc_mlp.cu", "enc_mlp_partial_bf16",
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    replaces="whisper_at_tpu/ops/mlp_enc.py:93",
)

BM = 128             # rows of a GEMM block tile (csrc/gemm_sm90.cuh)
WIDTHS = (256, 128)  # the block widths built, widest first


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def plan(m: int, n: int, sms: int, parts: int = 1):
    """(block width, blocks) of a GEMM on `csrc/gemm_sm90.cuh`, C[m, parts *
    n] = A[m, k] B[parts * n, k]^T, whose columns come in `parts` runs of n
    that no tile straddles (K3's K and V: parts = 2, n = D; m counts the
    rows of whole 128-row panels), on a card with `sms` SMs: 256-wide tiles
    where n allows and they still give every SM a tile, else 128 (n is a
    multiple of 128); one persistent block an SM, fewer where there are
    fewer tiles. At large-v1 (fc1 n = 5120, fc2 n = 1280) batch 24 takes
    256 for both; one audio row (m = 1500) takes 256 for fc1 (240 tiles)
    and 128 for fc2 (120 tiles, not 60), and K3 at one audio row (m = 1536,
    2 x 1280 columns) 128 (240 tiles, not 120)."""
    panels = -(-m // BM) * parts
    bn = next((w for w in WIDTHS if n % w == 0 and panels * (n // w) >= sms), WIDTHS[-1])
    return bn, min(sms, panels * -(-n // bn))


def enc_mlp_plain(x, ln_w, ln_b, w1, b1, w2, b2) -> torch.Tensor:
    """The same function in plain PyTorch: fp32 products and epilogues, the
    LN output and the gelu intermediate rounded to x.dtype as in the kernel."""
    xn = layer_norm(x, ln_w, ln_b)
    h = gelu(torch.matmul(xn.float(), w1.float().t()) + b1.float()).to(x.dtype)
    y = x.float() + (torch.matmul(h.float(), w2.float().t()) + b2.float())
    return y.to(x.dtype)


def enc_mlp_partial_plain(x, ln_w, ln_b, w1, b1, w2) -> torch.Tensor:
    """K2-partial in plain PyTorch: `enc_mlp_plain`'s h over this rank's
    hidden units, then h @ w2^T in fp32, rounded to x.dtype, with no
    residual and no b2."""
    xn = layer_norm(x, ln_w, ln_b)
    h = gelu(torch.matmul(xn.float(), w1.float().t()) + b1.float()).to(x.dtype)
    return torch.matmul(h.float(), w2.float().t()).to(x.dtype)


def enc_mlp(x, ln_w, ln_b, w1, b1, w2, b2) -> torch.Tensor:
    """x [B, T, D]; ln_w, ln_b [D]; w1 [4D, D], b1 [4D]; w2 [D, 4D], b2 [D]
    (torch Linear layout). Returns x + fc2(gelu(fc1(LN(x))))."""
    if not x.is_cuda:
        return enc_mlp_plain(x, ln_w, ln_b, w1, b1, w2, b2)
    return _launch(KERNEL, x, ln_w, ln_b, w1, b1, w2, b2)


def enc_mlp_partial(x, ln_w, ln_b, w1, b1, w2) -> torch.Tensor:
    """A tensor-parallel rank's share of the MLP (K2-partial): x [B, T, D];
    w1 [F, D], b1 [F], w2 [D, F] with F = 4D / tp (multiple of 128).
    Returns fc2(gelu(fc1(LN(x)))) over these F units, without residual or
    b2: the sum over the ranks plus x + b2 is `enc_mlp`'s output."""
    if not x.is_cuda:
        return enc_mlp_partial_plain(x, ln_w, ln_b, w1, b1, w2)
    return _launch(KERNEL_PARTIAL, x, ln_w, ln_b, w1, b1, w2, None)


def _launch(kernel, x, ln_w, ln_b, w1, b1, w2, b2) -> torch.Tensor:
    b, t, d = x.shape
    f = w1.shape[0]
    if d % 128 or f % 128:
        raise ValueError(f"the kernel takes D and F multiples of 128, got {d}, {f}")
    if w1.shape != (f, d) or w2.shape != (d, f):
        raise ValueError(f"bad weight shapes {tuple(w1.shape)}, {tuple(w2.shape)}")
    x2 = x.reshape(b * t, d)
    require_cuda(x2, torch.bfloat16, "x", 2)
    w1 = w1.to(torch.bfloat16).contiguous()
    w2 = w2.to(torch.bfloat16).contiguous()
    require_cuda(w1, torch.bfloat16, "w1", 2)
    require_cuda(w2, torch.bfloat16, "w2", 2)
    named = [("ln_w", ln_w, d), ("ln_b", ln_b, d), ("b1", b1, f)]
    if b2 is not None:
        named.append(("b2", b2, d))
    vecs = [p.float().contiguous() for _, p, _ in named]
    for (name, _, n), p in zip(named, vecs):
        require_cuda(p, torch.float32, name, 1)
        if p.shape[0] != n:
            raise ValueError(f"{name} must have {n} entries")
    m = b * t
    sms = sm_count(x.device.index or 0)
    xn = torch.empty_like(x2)
    h = torch.empty((m, f), device=x.device, dtype=torch.bfloat16)
    out = torch.empty_like(x2)
    tail = [ptr(vecs[3])] if b2 is not None else []
    kernel.launch(ptr(x2), ptr(vecs[0]), ptr(vecs[1]), ptr(w1), ptr(vecs[2]),
                  ptr(w2), *tail, ptr(xn), ptr(h), ptr(out), m, d, f,
                  *plan(m, f, sms), *plan(m, d, sms), stream_handle(x.device))
    return out.reshape(b, t, d)
