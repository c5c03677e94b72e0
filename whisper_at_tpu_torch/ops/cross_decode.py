"""K4: decode-step cross-attention over the int8 or int4 cross-KV of K3.

Replaces `whisper_at_tpu/ops/cross_decode.py::cross_attention_int8`
(Pallas), bits = 8 (`KERNEL`) and bits = 4 (`KERNEL4`, its own entry, over
codes packed by `models/layers.pack4`). The CUDA source is
`csrc/cross_decode.cu`: a block per (head, audio row, run of the
positions) with every query row of the head, one TMA ring through the K
codes and then the V codes, the logits held in shared memory for an exact
fp32 softmax (the maximum and sum over all positions), the V scales folded
into P; the products on the tensor cores or the CUDA cores (`plan`). Where
the (head, audio row) blocks would not fill the card, the positions split
over a thread-block cluster in one launch. Its header gives the bound.

Query rows are head-major: row h*G + g is head h, group row g (a prefill
token or a beam). The queries arrive pre-scaled by 64^-0.5.
"""

import ctypes
import functools

import torch

from ..models.layers import unpack4
from .cuda import CudaKernel, ptr, require_cuda, stream_handle

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
KERNEL = CudaKernel("cross_decode", "cross_decode.cu", "cross_decode_bf16", _ARGTYPES,
                    replaces="whisper_at_tpu/ops/cross_decode.py:175")
KERNEL4 = CudaKernel("cross_decode4", "cross_decode.cu", "cross_decode4_bf16", _ARGTYPES,
                     replaces="whisper_at_tpu/ops/cross_decode.py:175")
HEAD_DIM = 64
MAX_SMEM = 227 * 1024
NEG_BIG = -1e30
MAX_SPLIT = 8      # blocks of a cluster: runs of the positions
BLOCKS_PER_SM = 4  # the kernel's blocks on one streaming multiprocessor
# stages of 256 positions (64 a consumer warp) up to this G, by bits; 128
# above, where two such stages and the logits would leave room for fewer
# than BLOCKS_PER_SM blocks (measured on an H100, PERF.md section 6)
WIDE_STAGES_TO = {8: 1, 4: 5}


def block_rows(g: int) -> int:
    """Query rows of a block: one on the CUDA cores (G = 1), else slices of
    8 or 16 rows on the tensor cores (more rows take further slices)."""
    if g == 1:
        return 1
    return 16 if g > 8 else 8


@functools.lru_cache(maxsize=None)
def wave_slots(device_index: int) -> int:
    """Blocks in one wave on the card: BLOCKS_PER_SM on each of its
    streaming multiprocessors (528 on an H100 SXM)."""
    return BLOCKS_PER_SM * torch.cuda.get_device_properties(device_index).multi_processor_count


def plan(a: int, n_head: int, g: int, ta_pad: int, bits: int, slots: int):
    """(n_split, per_split, tensor_cores, chunk): the products on the tensor
    cores above one query row; the positions' stages of `chunk` split into
    n_split runs of per_split, one a block of a cluster, as many as one wave
    of `slots` blocks allows (up to MAX_SPLIT), none empty. Large-v1 at
    batch 24 (480 blocks) takes one run; a single audio row at G = 1, 6 runs
    of one 256-position stage."""
    chunk = 256 if g <= WIDE_STAGES_TO[bits] else 128
    n_stages = -(-ta_pad // chunk)
    blocks = a * n_head * -(-g // block_rows(g))
    want = max(1, min(n_stages, MAX_SPLIT, slots // blocks))
    per = -(-n_stages // want)
    return -(-n_stages // per), per, g > 1, chunk


def pad_bias(ta: int, ta_pad: int, device) -> torch.Tensor:
    """Additive column mask [Ta_pad]: 0 on valid positions, -1e30 on padding."""
    bias = torch.zeros(ta_pad, device=device, dtype=torch.float32)
    bias[ta:] = NEG_BIG
    return bias


def cross_attention_int8_plain(q, kq, ks, vq, vs, bias, n_head: int) -> torch.Tensor:
    """The same function in plain PyTorch, in the reference's arithmetic:
    bf16 (or fp32) operands, fp32 products and softmax, pw = (p * vs) rounded
    to q.dtype before the value product."""
    a, hg, dh = q.shape
    g = hg // n_head
    ta_pad = kq.shape[1]
    qh = q.reshape(a, n_head, g, dh).float()
    k = kq.reshape(a, ta_pad, n_head, dh).permute(0, 2, 3, 1).to(q.dtype).float()
    logits = torch.matmul(qh, k) * ks[:, :, None, :] + bias
    p = torch.softmax(logits, dim=-1)
    pw = (p * vs[:, :, None, :]).to(q.dtype).float()
    v = vq.reshape(a, ta_pad, n_head, dh).permute(0, 2, 1, 3).to(q.dtype).float()
    return torch.matmul(pw, v).reshape(a, hg, dh)


def smem_bytes(kernel, bits: int, groups: int, n_split: int, per_split: int,
               tensor_cores: bool, chunk: int) -> int:
    """Dynamic shared memory of a launch of `kernel` (KERNEL or KERNEL4)."""
    fn = kernel.c_function("cross_decode_smem_bytes", [ctypes.c_int] * 6)
    return fn(bits, groups, n_split, per_split, int(tensor_cores), chunk)


@functools.lru_cache(maxsize=None)
def _geometry(kernel, bits: int, a: int, n_head: int, groups: int, ta_pad: int, slots: int):
    """`plan` and its launch's shared memory, worked out once a shape: the
    decode loop calls the kernel thousands of times on a few shapes."""
    n_split, per, tensor_cores, chunk = plan(a, n_head, groups, ta_pad, bits, slots)
    return (n_split, per, tensor_cores, chunk,
            smem_bytes(kernel, bits, groups, n_split, per, tensor_cores, chunk))


def cross_attention_int4_plain(q, kp, ks, vp, vs, bias, n_head: int) -> torch.Tensor:
    """`cross_attention_int8_plain` over packed int4 codes."""
    return cross_attention_int8_plain(q, unpack4(kp), ks, unpack4(vp), vs, bias, n_head)


def cross_attention_int8(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                         vq: torch.Tensor, vs: torch.Tensor, bias: torch.Tensor,
                         n_head: int) -> torch.Tensor:
    """out [A, H*G, 64] fp32 = softmax(q k^T * ks + bias) (vs-weighted) v.

    q [A, H*G, 64]; kq, vq int8 [A, Ta_pad, H*64]; ks, vs fp32 [A, H, Ta_pad];
    bias fp32 [Ta_pad]."""
    if not q.is_cuda:
        return cross_attention_int8_plain(q, kq, ks, vq, vs, bias, n_head)
    return _launch(KERNEL, q, kq, ks, vq, vs, bias, n_head, 8)


def cross_attention_int4(q: torch.Tensor, kp: torch.Tensor, ks: torch.Tensor,
                         vp: torch.Tensor, vs: torch.Tensor, bias: torch.Tensor,
                         n_head: int) -> torch.Tensor:
    """`cross_attention_int8` over K3-int4's codes: kp, vp int8
    [A, Ta_pad, H*32], packed by `pack4`."""
    if not q.is_cuda:
        return cross_attention_int4_plain(q, kp, ks, vp, vs, bias, n_head)
    return _launch(KERNEL4, q, kp, ks, vp, vs, bias, n_head, 4)


def _launch(kernel, q, kq, ks, vq, vs, bias, n_head: int, bits: int) -> torch.Tensor:
    a, hg, dh = q.shape
    ta_pad = kq.shape[1]
    if dh != HEAD_DIM or hg % n_head:
        raise ValueError(f"bad query shape {tuple(q.shape)} for {n_head} heads")
    if not ta_pad or ta_pad % 4:
        raise ValueError(f"Ta_pad {ta_pad} is not a multiple of 4 (the scales' rows must be "
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
    groups = hg // n_head
    n_split, per, tensor_cores, chunk, smem = _geometry(
        kernel, bits, a, n_head, groups, ta_pad, wave_slots(q.device.index or 0))
    if smem > MAX_SMEM:
        raise ValueError(f"Ta_pad {ta_pad} exceeds the kernel's shared memory")
    out = torch.empty((a, hg, dh), device=q.device, dtype=torch.float32)
    kernel.launch(ptr(q), ptr(kq), ptr(ks), ptr(vq), ptr(vs), ptr(bias), ptr(out),
                  a, n_head, groups, ta_pad, n_split, per, int(tensor_cores), chunk,
                  stream_handle(q.device))
    return out
