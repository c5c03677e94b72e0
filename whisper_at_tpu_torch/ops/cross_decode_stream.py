"""K10: K4's function with an online softmax over streamed chunks of Ta.

Replaces `whisper_at_tpu/ops/cross_decode_stream.py::
cross_attention_int8_stream` (Pallas), bits = 8 (`KERNEL`) and bits = 4
(`KERNEL4`). It takes K4's contract (`ops/cross_decode.py`): q [A, H*G, 64]
pre-scaled by 64^-0.5 with head-major rows, codes in K3's row-major layout
[A, Ta_pad, H*64] int8 (or packed by `models/layers.pack4`, [A, Ta_pad,
H*32]), scales [A, H, Ta_pad] fp32, pad bias [Ta_pad]. It differs from K4
in its softmax: K and V are read together, chunk by chunk, with running
maxima and sums rescaled per chunk (the TPU kernel's recurrence), so no
Ta-sized logits buffer exists. The CUDA source is `csrc/cross_decode_stream.cu`
(a TMA ring of 128-position stages, four consumer warps that each keep their
own running max and sum, the positions split over blocks); its header gives
the bound. When the positions are split, a second kernel of the same entry
(`cross_decode_stream_combine`) combines the splits.

`models/decoder.py` selects it in place of K4 with
WHISPER_AT_TPU_CROSS_DECODE=stream.
"""

import ctypes

import torch

from ..models.layers import unpack4
from .cross_decode import HEAD_DIM, NEG_BIG
from .cuda import CudaKernel, ptr, require_cuda, stream_handle

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_REPLACES = "whisper_at_tpu/ops/cross_decode_stream.py:218"
KERNEL = CudaKernel("cross_decode_stream", "cross_decode_stream.cu", "cross_decode_stream_bf16",
                    _ARGTYPES, replaces=_REPLACES)
KERNEL4 = CudaKernel("cross_decode_stream4", "cross_decode_stream.cu",
                     "cross_decode_stream4_bf16", _ARGTYPES, replaces=_REPLACES)
WARPS = 4              # consumer warps of a block, each with its own running max and sum
LANES = 32             # positions of a stage a warp takes, one a lane
CHUNK = WARPS * LANES  # positions of a ring stage
GMAX = 8               # query rows of a block (more take further row slices)
SLOTS = 528            # blocks in one wave on an H100: 4 a streaming multiprocessor x 132
PART = HEAD_DIM + 2    # a split's partial of one row in the combine's scratch: m, l, acc


def splits(a: int, n_head: int, g: int, ta_pad: int):
    """(n_split, per_split): the positions' stages of CHUNK split into runs
    of per_split, one a block, as many as one wave of blocks allows and none
    empty. Large-v1 at batch 24 (480 blocks) takes one run of 12 stages; a
    single audio row, 12 runs of one."""
    n_stages = -(-ta_pad // CHUNK)
    blocks = a * n_head * -(-g // GMAX)
    want = max(1, min(n_stages, SLOTS // blocks))
    per = -(-n_stages // want)
    return -(-n_stages // per), per


def cross_attention_stream_plain(q, kq, ks, vq, vs, bias, n_head: int) -> torch.Tensor:
    """The same function in plain PyTorch, in the kernel's arithmetic.

    The positions fall into `splits` runs of stages of CHUNK; in each stage
    warp w takes positions LANES w .. LANES w + LANES - 1. Per warp and row:
    logits = (q . k) * ks + bias in fp32, the running max m and sum l
    rescaled by alpha = exp(m_old - m) each stage, pw = bf16(exp(logits -
    m) * vs) (q.dtype) against the warp's new m, acc = acc * alpha + pw v in
    fp32. The warps of a run combine in order (m = max, each term scaled by
    exp(m_w - m)), then the runs the same way; out = acc / l. Positions at
    or past Ta_pad (a last stage's tail) weigh 0."""
    a, hg, dh = q.shape
    g = hg // n_head
    ta_pad = kq.shape[1]
    n_split, per = splits(a, n_head, g, ta_pad)
    n_pos = n_split * per * CHUNK
    qh = q.reshape(a, n_head, g, dh).float()
    k = kq.reshape(a, ta_pad, n_head, dh).permute(0, 2, 3, 1).to(q.dtype).float()
    logits = torch.matmul(qh, k) * ks[:, :, None, :] + bias            # [a, h, g, Ta_pad]
    tail = n_pos - ta_pad
    logits = torch.nn.functional.pad(logits, (0, tail), value=NEG_BIG)
    valid = torch.arange(n_pos, device=q.device) < ta_pad
    v = vq.reshape(a, ta_pad, n_head, dh).permute(0, 2, 1, 3).to(q.dtype).float()
    v = torch.nn.functional.pad(v, (0, 0, 0, tail))                     # [a, h, n_pos, dh]
    vsp = torch.nn.functional.pad(vs, (0, tail))                        # [a, h, n_pos]

    def stages(x, lead):  # [..., n_pos, *rest] -> [..., n_split, per, WARPS, LANES, *rest]
        return x.reshape(*x.shape[:lead], n_split, per, WARPS, LANES, *x.shape[lead + 1:])

    logits, valid = stages(logits, 3), stages(valid, 0)
    v, vsp = stages(v, 2), stages(vsp, 2)
    m = torch.full((a, n_head, g, n_split, WARPS, 1), NEG_BIG, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((a, n_head, g, n_split, WARPS, dh), device=q.device)
    for j in range(per):
        x, ok = logits[:, :, :, :, j], valid[:, j]                      # [a, h, g, S, W, 32]
        m_new = torch.maximum(m, x.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(ok, torch.exp(x - m_new), torch.zeros((), device=q.device))
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        pw = (p * vsp[:, :, None, :, j]).to(q.dtype).float()
        acc = acc * alpha + torch.einsum("ahgswt,ahswtd->ahgswd", pw, v[:, :, :, j])
        m = m_new
    for dim in (-2, -3):  # the warps of each run, then the runs
        m_all = m.amax(dim=dim, keepdim=True)
        e = torch.exp(m - m_all)
        l, acc, m = (l * e).sum(dim=dim, keepdim=True), (acc * e).sum(dim=dim, keepdim=True), m_all
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
    if not ta_pad or ta_pad % 64:
        raise ValueError(f"Ta_pad {ta_pad} is not a multiple of 64 (the scales' rows must be "
                         f"whole 16-byte units for the copy engine)")
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
    g = hg // n_head
    n_split, per = splits(a, n_head, g, ta_pad)
    out = torch.empty((a, hg, dh), device=q.device, dtype=torch.float32)
    part = (torch.empty((a * hg, n_split, PART), device=q.device, dtype=torch.float32)
            if n_split > 1 else None)
    kernel.launch(ptr(q), ptr(kq), ptr(ks), ptr(vq), ptr(vs), ptr(bias), ptr(out),
                  ctypes.c_void_p(None if part is None else part.data_ptr()),
                  a, n_head, g, ta_pad, n_split, per, stream_handle(q.device))
    return out
