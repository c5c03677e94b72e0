"""K8: the decode step's MLP, fc1 -> exact GELU -> fc2, in one call.

Replaces `whisper_at_tpu/ops/fused_mlp.py::fused_mlp` (Pallas), with a
bf16-weight entry (`KERNEL`) and an int8-weight entry (`KERNEL_INT8`). The
weights are the port's own modules as they are: `layers.Linear` ([out, in]
weight, bias) or `layers.QuantLinear` (int8 `w_q` [out, in], fp32
per-output-channel `w_s`, bias). The arithmetic is the JAX kernel's:
h = x W1^T (* s1) + b1 in fp32, exact GELU in fp32, h rounded to x's
dtype, the fc2 products summed in fp32, (* s2), b2 added last, the output
in x's dtype. The JAX kernel's rational erf (a Mosaic workaround) is not
ported: the GELU is the exact one (`erff` in the kernel).

The CUDA source is `csrc/fused_mlp.cu`; its header gives the bound and the
design. The call is byte-bound (at large-v1 and 24 rows: 13.1 MB of int8 or
26.2 MB of bf16 weight, met cold by the decode loop). One C call launches
two products of one template, fc1 (its epilogue writes h [M, F] bf16, the
only intermediate) and fc2 (launched with programmatic dependent launch,
so its weight streams in while fc1 runs); each fills the card's wave with
blocks of `bn` weight rows, K split over a thread-block cluster whose
partials add in rank order through distributed shared memory, and streams
its weight once through a TMA ring. `plan` picks the tilings; one launch
count per call.

`models/decoder.py` routes the decode MLP through it when its module
constant `FUSED_MLP` is True, over all B*S rows of a call that has at most
MAX_ROWS of them; a larger prefill takes the unfused MLP there.
"""

import ctypes
import functools
from typing import NamedTuple

import torch

from ..models.layers import QuantLinear, QuantLinear4, gelu
from .cuda import CudaKernel, ptr, require_cuda, stream_handle

_REPLACES = "whisper_at_tpu/ops/fused_mlp.py:101"
# M, D, F, then pointers to the four ints of fc1's and of fc2's Tiling, and the stream
_SHAPES = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
KERNEL = CudaKernel("fused_mlp", "fused_mlp.cu", "fused_mlp_bf16",
                    [ctypes.c_void_p] * 7 + _SHAPES, replaces=_REPLACES)
KERNEL_INT8 = CudaKernel("fused_mlp_int8", "fused_mlp.cu", "fused_mlp_int8",
                         [ctypes.c_void_p] * 9 + _SHAPES, replaces=_REPLACES)

# the kernel's shape (csrc/fused_mlp.cu)
CHUNK = 64           # K of a ring stage; D and F must be multiples of it
STRIP = 16           # a block's weight rows are 1-5 strips (one wgmma m64n{bn}k16)
WIDTHS = tuple(STRIP * n for n in range(1, 6))
WARPGROUPS = 2       # consumer warpgroups of a block
MAX_ROWS = 256       # rows of one call: the decode steps and the smaller prefills
MAX_STAGES = 16
SMEM_MAX = 227 * 1024
# a block of fc1 and one of fc2 side by side on an SM, so that fc2's first
# stages stream in under fc1 (228 KB an SM, 1 KB of it reserved a block)
SMEM_SHARED = 113 * 1024
MIN_SHARED_STAGES = 4  # ring stages below which a block takes the whole SM instead


class Tiling(NamedTuple):
    bn: int       # weight rows (output columns) of a block
    split: int    # blocks of a cluster splitting K
    stages: int   # ring stages of CHUNK columns of K
    kgroups: int  # 2: the two consumer warpgroups take the stages in turn (M <= 64)


class Plan(NamedTuple):
    fc1: Tiling
    fc2: Tiling
    smem: tuple          # dynamic shared memory of a block of fc1, of fc2 (bytes)
    scratch_bytes: int   # h [M, F] bf16, the only intermediate


def _round(x: int, to: int) -> int:
    return -(-x // to) * to


def smem_bytes(m: int, t: Tiling, weight_bytes: int) -> int:
    """A block's dynamic shared memory (csrc/fused_mlp.cu `layout`): the ring
    of weight and A boxes, padded to whole 64-row A tiles (later the warp
    groups' partial tiles); int8: a bf16 copy of a weight box a warpgroup;
    the cluster's partials [M, bn] fp32 when K is split; the scales and
    biases; the barriers; 1 KB of alignment."""
    stage = t.bn * CHUNK * weight_bytes + _round(m, 8) * CHUNK * 2
    ring = t.stages * stage + (_round(m, 64) - _round(m, 8)) * CHUNK * 2
    conv = WARPGROUPS * t.bn * CHUNK * 2 if weight_bytes == 1 else 0
    recv = m * t.bn * 4 if t.split > 1 else 0
    front = _round(max(ring, t.kgroups * m * (t.bn + 4) * 4), 1024) + conv + recv
    return 1024 + _round(front + 6 * t.bn, 8) + 8 * (2 * t.stages + 1)


def tiling(m: int, n: int, k: int, weight_bytes: int, sms: int) -> Tiling:
    """The tiling of out[m, n] = A[m, k] W[n, k]^T: of the block widths
    WIDTHS dividing n and splits of K (1, 2, 4, 8, none leaving a block
    without a chunk) whose grid fits one wave of `sms` blocks, the one whose
    blocks each stream the fewest weight bytes; ties go to the smaller split
    (less to add across the cluster). Up to 64 rows (one 64-row A tile) the
    two consumer warpgroups take the stages in turn (kgroups 2) where every
    block has two chunks, else each its own A tiles. The ring takes as many
    stages as the block has chunks, up to MAX_STAGES (a multiple of kgroups
    where the ring is reused), within half an SM (SMEM_SHARED) while that
    still holds MIN_SHARED_STAGES, else within a whole one."""
    chunks = k // CHUNK
    best = None
    for kgroups in ((2, 1) if m <= 64 else (1,)):
        for bn in WIDTHS:
            if n % bn:
                continue
            for split in (1, 2, 4, 8):
                per = -(-chunks // split)
                if (split > chunks or chunks - (split - 1) * per < kgroups
                        or n // bn * split > sms):
                    continue
                key = (bn * per, split, bn)
                if best is None or key < best[0]:
                    best = (key, bn, split, per)
        if best is not None:
            break
    if best is None:
        raise ValueError(f"no tiling of the fused MLP fits m={m}, n={n}, k={k} on {sms} SMs")
    _, bn, split, per = best
    most = min(per, MAX_STAGES)
    for budget in (SMEM_SHARED, SMEM_MAX):
        stages = most
        while stages > 1 and (smem_bytes(m, Tiling(bn, split, stages, kgroups),
                                         weight_bytes) > budget
                              or stages < per and stages % kgroups):
            stages -= 1
        if budget == SMEM_MAX or stages >= min(most, MIN_SHARED_STAGES):
            break
    t = Tiling(bn, split, stages, kgroups)
    if smem_bytes(m, t, weight_bytes) > SMEM_MAX or stages < per and stages % kgroups:
        raise ValueError(f"the fused MLP's ring does not fit an SM at m={m}, n={n}")
    return t


def plan(m: int, d: int, f: int, sms: int, weight_bytes: int = 1) -> Plan:
    """The tilings of fc1 (N = f, K = d) and fc2 (N = d, K = f) for m rows
    (1 to MAX_ROWS) on a card with `sms` SMs, int8 (weight_bytes 1) or bf16
    (2) weights. At large-v1 (d 1280, f 5120), 24 rows, 132 SMs: fc1 blocks
    of 80 hidden units with K split over clusters of 2, fc2 blocks of 80
    outputs with K split over clusters of 8, 128 blocks each."""
    if not 0 < m <= MAX_ROWS:
        raise ValueError(f"the fused MLP takes 1 to {MAX_ROWS} rows, got {m}")
    if not d or d % CHUNK or not f or f % CHUNK:
        raise ValueError(f"the kernel takes D and F multiples of {CHUNK}, got D={d}, F={f}")
    fc1 = tiling(m, f, d, weight_bytes, sms)
    fc2 = tiling(m, d, f, weight_bytes, sms)
    return Plan(fc1, fc2, (smem_bytes(m, fc1, weight_bytes), smem_bytes(m, fc2, weight_bytes)),
                2 * m * f)


@functools.lru_cache(maxsize=None)
def wave_slots(device_index: int) -> int:
    """Blocks of one product in one wave on the card: one a streaming
    multiprocessor (132 on an H100 SXM)."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=256)
def _plan(m: int, d: int, f: int, sms: int, weight_bytes: int) -> Plan:
    return plan(m, d, f, sms, weight_bytes)


def _ints(t: Tiling):
    """A Tiling as the C entry's int[4]."""
    return (ctypes.c_int * 4)(*t)


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
    int4 weights raise ValueError, and so do M above MAX_ROWS and D or F not
    a multiple of CHUNK."""
    w1, s1, b1 = linear_weights(fc1)
    w2, s2, b2 = linear_weights(fc2)
    if (s1 is None) != (s2 is None):
        raise ValueError("fc1 and fc2 must both be int8 or both full precision")
    if not x.is_cuda:
        return fused_mlp_plain(x, w1, s1, b1, w2, s2, b2)
    require_cuda(x, torch.bfloat16, "x", 2)
    m, d = x.shape
    f = w1.shape[0]
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
    p = _plan(m, d, f, wave_slots(x.device.index), 2 if s1 is None else 1)
    h = torch.empty((m, f), device=x.device, dtype=x.dtype)
    out = torch.empty_like(x)
    if s1 is None:
        KERNEL.launch(ptr(x), ptr(w1), ptr(b1), ptr(w2), ptr(b2), ptr(h), ptr(out),
                      m, d, f, _ints(p.fc1), _ints(p.fc2), stream_handle(x.device))
        return out
    for name, t, n in (("s1", s1, f), ("s2", s2, d)):
        require_cuda(t, torch.float32, name, 1)
        if t.shape[0] != n:
            raise ValueError(f"{name} must be [{n}]")
    KERNEL_INT8.launch(ptr(x), ptr(w1), ptr(s1), ptr(b1), ptr(w2), ptr(s2), ptr(b2), ptr(h),
                       ptr(out), m, d, f, _ints(p.fc1), _ints(p.fc2), stream_handle(x.device))
    return out
