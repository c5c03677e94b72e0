"""K3: one decoder layer's cross-attention K/V projection + int8 or int4
quantization.

Replaces `whisper_at_tpu/ops/kv_quant.py::project_quantize_kv` (Pallas),
bits = 8 (`KERNEL`) and bits = 4 (`KERNEL4`, its own entry so that its
launch count shows the int4 path ran it), and carries `_quantize_sym`
(`whisper_at_tpu/models/decoder.py:241`). The CUDA source is
`csrc/kv_quant.cu`; its header gives the bound and the design: the
products on K2's persistent TMA + wgmma template (`csrc/gemm_sm90.cuh`),
quantized in its epilogue. The block width and grid are K2's rule
(`enc_mlp.plan`, with K and V as two runs of D columns).

Layout, chosen together with K4 (`ops/cross_decode.py`): codes are row-major
int8 [B, Ta_pad, H*64], so the 64 codes of one (position, head) are
contiguous, and scales are fp32 [B, H, Ta_pad]. The int4 codes are the same
rows packed by `models/layers.pack4`: [B, Ta_pad, H*32] bytes. Positions
t >= Ta carry zero codes and zero scales.

The weights may be a tensor-parallel rank's rows, Wk and Wv [N, D] with
N = D / tp: the call then writes that rank's N / 64 heads (N = 640 and 320
at tp 2 and 4 of large-v1). N need not divide by the block width; each of
K and V then takes one more, partly empty, tile (`plan`).
"""

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ..models.layers import QMAX, linear, pack4
from .cuda import CudaKernel, ptr, require_cuda, stream_handle
from .enc_mlp import plan as gemm_plan, sm_count

# xa, wk, wv, bv, kq, ks, vq, vs; B, Ta, Ta_pad, D, N, block width, blocks; the stream
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
KERNEL = CudaKernel("kv_quant", "kv_quant.cu", "kv_quant_bf16", _ARGTYPES,
                    replaces="whisper_at_tpu/ops/kv_quant.py:102")
KERNEL4 = CudaKernel("kv_quant4", "kv_quant.cu", "kv_quant4_bf16", _ARGTYPES,
                     replaces="whisper_at_tpu/ops/kv_quant.py:102")
HEAD_DIM = 64
LANE = 128


def pad_ta(ta: int) -> int:
    """Audio positions padded to a multiple of 128."""
    return -(-ta // LANE) * LANE


def quantize_sym(x: torch.Tensor, dim: int = -1,
                 bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric quantization with one scale per slice along `dim`:
    scale = amax / qmax + 1e-12, q = clip(round(x / scale), -qmax, qmax),
    qmax 127 (bits=8) or 7 (bits=4). Returns (int8 codes, unpacked, and fp32
    scales with `dim` kept as size 1)."""
    qmax = QMAX[bits]
    x32 = x.float()
    scale = x32.abs().amax(dim=dim, keepdim=True) / _divisor(qmax, x.device) + 1e-12
    q = torch.clamp(torch.round(x32 / scale), -qmax, qmax).to(torch.int8)
    return q, scale


@functools.lru_cache(maxsize=None)
def _divisor(qmax: float, device) -> torch.Tensor:
    """qmax as a 0-dim tensor on `device`. PyTorch on CUDA divides by a
    Python number as a multiply by its reciprocal, one fp32 ulp off the
    quotient about half the time; with bf16 inputs the codes then flip on
    exact ties (0.2% of int4 codes). A divisor tensor on the card gives the
    true quotient, as the CPU and K3's kernel compute it."""
    return torch.tensor(qmax, dtype=torch.float32, device=device)


def _allocate(b: int, ta_pad: int, n: int, device, bits: int = 8):
    codes = lambda: torch.empty((b, ta_pad, n * bits // 8), device=device, dtype=torch.int8)
    scales = lambda: torch.empty((b, n // HEAD_DIM, ta_pad), device=device,
                                 dtype=torch.float32)
    return codes(), scales(), codes(), scales()


def plan(b: int, ta: int, n: int, sms: int):
    """(block width, blocks) of K3's GEMM over b audio rows of ta positions
    (each padded to whole 128-row panels) and the 2 x n columns of K and V
    on a card with `sms` SMs: at large-v1 batch 24, 256-wide tiles on 132
    blocks; at one audio row, 128-wide (240 tiles, where 256 gives 120); at
    a tensor-parallel n of 640 or 320, 128-wide (5 or 3 tiles for each of K
    and V)."""
    return gemm_plan(b * pad_ta(ta), n, sms, parts=2)


def project_quantize_kv_plain(xa, wk, wv, bv, out: Optional[tuple] = None, bits: int = 8):
    """The same function in plain PyTorch (see `project_quantize_kv`; with
    bits=4, `project_quantize_kv4`). One scale per (position, head): the
    heads are 64 wide (the kernel's only width), or as many as `out`'s
    scales have rows (the CPU tests' narrow heads)."""
    b, ta, _ = xa.shape
    n = wk.shape[0]
    ta_pad = pad_ta(ta)
    h = out[1].shape[1] if out is not None else n // HEAD_DIM
    if out is None:
        out = _allocate(b, ta_pad, n, xa.device, bits)
    kq, ks, vq, vs = out
    for y, q_out, s_out in ((linear(xa, wk), kq, ks), (linear(xa, wv, bv), vq, vs)):
        q, s = quantize_sym(y.reshape(b, ta, h, n // h), dim=-1, bits=bits)
        q = q.reshape(b, ta, n)
        q_out[:, :ta] = pack4(q) if bits == 4 else q
        q_out[:, ta:] = 0
        s_out[:, :, :ta] = s[..., 0].transpose(1, 2)
        s_out[:, :, ta:] = 0
    return kq, ks, vq, vs


def project_quantize_kv(xa: torch.Tensor, wk: torch.Tensor, wv: torch.Tensor,
                        bv: torch.Tensor, out: Optional[tuple] = None):
    """k = xa @ wk^T and v = xa @ wv^T + bv, each rounded to xa.dtype, then
    int8 per (position, head). xa [B, Ta, D]; wk, wv [N, D] ([out, in]; N =
    D, or a tensor-parallel rank's N = D / tp); bv [N]. Returns (k codes,
    k scales, v codes, v scales) as int8 [B, Ta_pad, N], fp32
    [B, N/64, Ta_pad], int8, fp32 — written into `out` when given (views of
    a preallocated stack)."""
    return _project_quantize(xa, wk, wv, bv, out, 8)


def project_quantize_kv4(xa: torch.Tensor, wk: torch.Tensor, wv: torch.Tensor,
                         bv: torch.Tensor, out: Optional[tuple] = None):
    """`project_quantize_kv` at 4 bits (qmax 7): the codes come back packed
    by `pack4`, int8 [B, Ta_pad, N/2]; the scales as before."""
    return _project_quantize(xa, wk, wv, bv, out, 4)


def _project_quantize(xa, wk, wv, bv, out, bits: int):
    if not xa.is_cuda:
        return project_quantize_kv_plain(xa, wk, wv, bv, out, bits)
    b, ta, d = xa.shape
    n = wk.shape[0]
    ta_pad = pad_ta(ta)
    if d % LANE:
        raise ValueError(f"the kernel takes D a multiple of {LANE}, got {d}")
    if n % HEAD_DIM or not HEAD_DIM <= n <= d:
        raise ValueError(f"the kernel takes N a multiple of {HEAD_DIM} up to D={d}, got {n}")
    require_cuda(xa, torch.bfloat16, "xa", 3)
    wk = wk.to(torch.bfloat16).contiguous()
    wv = wv.to(torch.bfloat16).contiguous()
    bv = bv.to(torch.bfloat16).contiguous()
    for name, w in (("wk", wk), ("wv", wv)):
        require_cuda(w, torch.bfloat16, name, 2)
        if w.shape != (n, d):
            raise ValueError(f"{name} must be [{n}, {d}]")
    require_cuda(bv, torch.bfloat16, "bv", 1)
    if bv.shape[0] != n:
        raise ValueError(f"bv must have {n} entries")
    if out is None:
        out = _allocate(b, ta_pad, n, xa.device, bits)
    kq, ks, vq, vs = out
    codes = (b, ta_pad, n * bits // 8)
    for name, t, dtype, shape in (("kq", kq, torch.int8, codes),
                                  ("ks", ks, torch.float32, (b, n // HEAD_DIM, ta_pad)),
                                  ("vq", vq, torch.int8, codes),
                                  ("vs", vs, torch.float32, (b, n // HEAD_DIM, ta_pad))):
        require_cuda(t, dtype, name, 3)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    kernel = KERNEL4 if bits == 4 else KERNEL
    kernel.launch(ptr(xa), ptr(wk), ptr(wv), ptr(bv), ptr(kq), ptr(ks), ptr(vq), ptr(vs),
                  b, ta, ta_pad, d, n, *plan(b, ta, n, sm_count(xa.device.index or 0)),
                  stream_handle(xa.device))
    return kq, ks, vq, vs
