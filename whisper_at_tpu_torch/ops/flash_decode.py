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

The CUDA source is `csrc/flash_decode.cu`: a block per (head, audio row,
run of the positions), one TMA ring of K and V stages, four consumer warps
each with its own online (m, l, acc), the warps merged in order and the runs
merged in rank order across a thread-block cluster, in one launch (`plan`
splits the positions so that the grid fills the card). Its header gives the
bound.
"""

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .cuda import CudaKernel, ptr, require_cuda, stream_handle

KERNEL = CudaKernel(
    "flash_decode", "flash_decode.cu", "flash_decode_bf16",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    replaces="whisper_at_tpu/ops/flash_decode.py:89",
)
HEAD_DIM = 64
CHUNK = 128    # positions of a stage (csrc/flash_decode.cu)
MAX_SPLIT = 8  # runs of the positions: blocks of a cluster
BLOCKS_PER_SM = 4  # the kernel's blocks on one streaming multiprocessor (csrc/flash_decode.cu)


@functools.lru_cache(maxsize=None)
def wave_slots(device_index: int) -> int:
    """Blocks of K9 in one wave on the card: BLOCKS_PER_SM on each of its
    streaming multiprocessors (528 on an H100 SXM)."""
    return BLOCKS_PER_SM * torch.cuda.get_device_properties(device_index).multi_processor_count


def plan(a: int, n_head: int, s: int, slots: int) -> Tuple[int, int]:
    """(n_split, per_split): the stages of CHUNK positions covering s split
    into n_split runs of per_split, one a block of a cluster, as many as one
    wave of `slots` blocks allows (up to MAX_SPLIT), none empty, as
    `cross_decode.plan` does for K4. Large-v1 at batch 24 (480 blocks) takes
    one run; a single audio row, 6 runs of two stages."""
    n_stages = -(-s // CHUNK)
    want = max(1, min(n_stages, MAX_SPLIT, slots // (a * n_head)))
    per = -(-n_stages // want)
    return -(-n_stages // per), per


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
    if s_pad % 4:
        raise ValueError(f"S_pad {s_pad} is not a multiple of 4 (the scales' rows must be "
                         f"whole 16-byte units for the copy engine)")
    n_split, per = plan(a, n_head, s, wave_slots(q.device.index or 0))
    out = torch.empty_like(q)
    KERNEL.launch(ptr(q), ptr(kq), ptr(ks), ptr(vq), ptr(vs), ptr(out), a, n_head, s_pad, s,
                  n_split, per, stream_handle(q.device))
    return out
