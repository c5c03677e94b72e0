"""K8: the decode step's MLP, fc1 -> exact GELU -> fc2, in one call.

Replaces `whisper_at_tpu/ops/fused_mlp.py::fused_mlp` (Pallas), with a
bf16-weight entry (`KERNEL`) and an int8-weight entry (`KERNEL_INT8`). The
weights are the port's own modules as they are: `layers.Linear` ([out, in]
weight, bias) or `layers.QuantLinear` (int8 `w_q` [out, in], fp32
per-output-channel `w_s`, bias). The arithmetic is the JAX kernel's:
h = x W1^T (* s1) + b1 in fp32, exact GELU in fp32, h rounded to x's
dtype, the fc2 products (* s2) summed in fp32, b2 added last, the output in
x's dtype. The JAX kernel's rational erf (a Mosaic workaround) is not
ported: the GELU is the exact one (`erff` in the kernel).

The CUDA source is `csrc/fused_mlp.cu`: blocks over 64-unit slices of the
hidden axis, each writing its share of the output to an fp32 scratch
allocated here, summed in a fixed order by a second kernel; one launch
count per call. Its header gives the bound.

`models/decoder.py` routes the decode MLP through it when its module
constant `FUSED_MLP` is True, over all B*S rows.
"""

import ctypes

import torch

from ..models.layers import QuantLinear, QuantLinear4, gelu
from .cuda import CudaKernel, ptr, require_cuda, stream_handle

_REPLACES = "whisper_at_tpu/ops/fused_mlp.py:101"
KERNEL = CudaKernel("fused_mlp", "fused_mlp.cu", "fused_mlp_bf16",
                    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
                    replaces=_REPLACES)
KERNEL_INT8 = CudaKernel("fused_mlp_int8", "fused_mlp.cu", "fused_mlp_int8",
                         [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
                         replaces=_REPLACES)
CHUNK = 64  # D and F must be multiples of the kernel's chunk and slice


def linear_weights(fc):
    """(weight [out, in], per-output-channel scale or None, bias)."""
    if isinstance(fc, QuantLinear4):
        raise ValueError("the fused MLP takes bf16 or int8 weights, not int4 "
                         "(the JAX kernel has no int4 entry)")
    if isinstance(fc, QuantLinear):
        return fc.w_q, fc.w_s, fc.bias
    return fc.weight, None, fc.bias


def fused_mlp_plain(x: torch.Tensor, w1, s1, b1, w2, s2, b2) -> torch.Tensor:
    """The same function in plain PyTorch, in the kernel's rounding."""
    h = torch.matmul(x.float(), w1.to(x.dtype).float().t())
    if s1 is not None:
        h = h * s1
    h = gelu(h + b1.float()).to(x.dtype)
    out = torch.matmul(h.float(), w2.to(x.dtype).float().t())
    if s2 is not None:
        out = out * s2
    return (out + b2.float()).to(x.dtype)


def fused_mlp(x: torch.Tensor, fc1, fc2) -> torch.Tensor:
    """fc2(gelu(fc1(x))) for x [M, D], in one kernel call on the card.
    fc1, fc2: both `Linear` (bf16 entry) or both `QuantLinear` (int8 entry);
    int4 weights raise ValueError."""
    w1, s1, b1 = linear_weights(fc1)
    w2, s2, b2 = linear_weights(fc2)
    if (s1 is None) != (s2 is None):
        raise ValueError("fc1 and fc2 must both be int8 or both full precision")
    if not x.is_cuda:
        return fused_mlp_plain(x, w1, s1, b1, w2, s2, b2)
    require_cuda(x, torch.bfloat16, "x", 2)
    m, d = x.shape
    f = w1.shape[0]
    if d % CHUNK or f % CHUNK:
        raise ValueError(f"the kernel takes D and F multiples of {CHUNK}, got D={d}, F={f}")
    wdtype = torch.bfloat16 if s1 is None else torch.int8
    for name, t, shape in (("w1", w1, (f, d)), ("w2", w2, (d, f))):
        require_cuda(t, wdtype, name, 2)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got {tuple(t.shape)}")
    for name, t, n in (("b1", b1, f), ("b2", b2, d)):
        if t is None:
            raise ValueError(f"the kernel needs {name}")
        require_cuda(t, torch.bfloat16, name, 1)
        if t.shape[0] != n:
            raise ValueError(f"{name} must be [{n}]")
    part = torch.empty((f // CHUNK, m, d), device=x.device, dtype=torch.float32)
    out = torch.empty_like(x)
    if s1 is None:
        KERNEL.launch(ptr(x), ptr(w1), ptr(b1), ptr(w2), ptr(b2), ptr(out), ptr(part),
                      m, d, f, stream_handle(x.device))
        return out
    for name, t, n in (("s1", s1, f), ("s2", s2, d)):
        require_cuda(t, torch.float32, name, 1)
        if t.shape[0] != n:
            raise ValueError(f"{name} must be [{n}]")
    KERNEL_INT8.launch(ptr(x), ptr(w1), ptr(s1), ptr(b1), ptr(w2), ptr(s2), ptr(b2), ptr(out),
                       ptr(part), m, d, f, stream_handle(x.device))
    return out
