"""Transformer building blocks shared by the encoder, decoder and TL-TR head.

PyTorch counterpart of `whisper_at_tpu/models/layers.py`. Parameters live in
`nn.Module`s whose names follow the reference Whisper checkpoints
(`attn.query.weight`, `mlp.0.weight`, `attn_ln.weight`, ...), with linear
weights in torch's [out, in] layout. The arithmetic mirrors the JAX package:
layer norm in an fp32 island, attention logits and softmax in fp32, matmul
weights cast to the activation dtype (bf16 on the card, fp32 in the CPU
tests).

int4 payloads (decode weights, the int4 self cache, the int4 cross K/V) all
use one packing, `pack4`: int8 bytes holding two signed 4-bit codes in
[-7, 7], adjacent pairs along the tensor's contiguous last axis, low nibble
first (byte j of a row = element 2j in bits 0-3, element 2j+1 in bits 4-7).
Every CUDA kernel that reads or writes int4 (K3, K4, K5) refers to this
convention. The codes and scales are those of the JAX package; only the
byte layout differs (the JAX package packs halves of an axis, a TPU layout
constraint).
"""

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-5


def sinusoids(length: int, channels: int, max_timescale: float = 10000) -> torch.Tensor:
    """Sinusoidal position embeddings [length, channels], fp32."""
    if channels % 2:
        raise ValueError("channels must be even")
    step = np.log(max_timescale) / (channels // 2 - 1)
    inv = np.exp(-step * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    table = np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1)
    return torch.from_numpy(table.astype(np.float32))


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm computed in fp32, cast back to the input dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    normed = (x32 - mean) * torch.rsqrt(var + LN_EPS)
    return (normed * weight.float() + bias.float()).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ weight^T (+ bias), weight [out, in] cast to x.dtype; the bias
    is added after the product is rounded to x.dtype, as in the JAX package."""
    y = torch.matmul(x, weight.to(x.dtype).t())
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


class LayerNorm(nn.Module):
    def __init__(self, n: int, device=None, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(n, device=device, dtype=dtype))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias)


class Linear(nn.Module):
    def __init__(self, n_in: int, n_out: int, bias: bool = True, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_out, n_in, device=device, dtype=dtype))
        self.bias = (nn.Parameter(torch.empty(n_out, device=device, dtype=dtype))
                     if bias else None)

    def forward(self, x):
        return linear(x, self.weight, self.bias)

    def reset_random(self, gen: torch.Generator) -> None:
        """U(-1/sqrt(in), 1/sqrt(in)) for weight and bias (JAX init_linear)."""
        std = 1.0 / math.sqrt(self.weight.shape[1])
        uniform_(self.weight, -std, std, gen)
        if self.bias is not None:
            uniform_(self.bias, -std, std, gen)


QMAX = {8: 127.0, 4: 7.0}  # symmetric code range at each width


def pack4(q: torch.Tensor) -> torch.Tensor:
    """Integer codes in [-8, 7], [..., N] with N even -> int8 [..., N/2]:
    adjacent pairs along the last axis, low nibble first (module docstring).
    Three tensor ops on int8 (a shift wraps within the byte): the decode
    loop packs every new self-cache slot."""
    q8 = q.to(torch.int8)
    return (q8[..., 0::2] & 0xF) | (q8[..., 1::2] << 4)


def unpack4(p: torch.Tensor) -> torch.Tensor:
    """Inverse of `pack4`: int8 [..., N/2] -> int8 codes [..., N], each
    nibble sign-extended by shifts on int32 (the high one by the byte's own
    sign)."""
    p32 = p.to(torch.int32)
    return torch.stack([(p32 << 28) >> 28, p32 >> 4], dim=-1).flatten(-2).to(torch.int8)


class QuantLinear(nn.Module):
    """int8 weights with per-output-channel fp32 scales:
    y = (x @ w_q^T.to(x.dtype)) * w_s.to(x.dtype) (+ bias)."""

    def __init__(self, w_q: torch.Tensor, w_s: torch.Tensor,
                 bias: Optional[torch.Tensor]):
        super().__init__()
        self.register_buffer("w_q", w_q)
        self.register_buffer("w_s", w_s)
        self.bias = bias

    def forward(self, x):
        y = torch.matmul(x, self.w_q.to(x.dtype).t()) * self.w_s.to(x.dtype)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y


class QuantLinear4(nn.Module):
    """int4 weights, packed by `pack4` along the input axis of the [out, in]
    weight (w_p int8 [out, in/2]), with per-output-channel fp32 scales:
    y = bf16(x @ unpack4(w_p)^T) * w_s.to(x.dtype) (+ bias), the JAX
    package's rounding order. bf16 rows on the card, at most 256 of them
    (the decode steps and prefills), go through K5 (`ops/w4_matmul.py`),
    which streams the packed bytes; anything else unpacks the weight and
    calls torch.matmul, as the JAX package leaves that case to XLA."""

    def __init__(self, w_p: torch.Tensor, w_s: torch.Tensor,
                 bias: Optional[torch.Tensor]):
        super().__init__()
        self.register_buffer("w_p", w_p)
        self.register_buffer("w_s", w_s)
        self.bias = bias

    def forward(self, x):
        lead, k = x.shape[:-1], x.shape[-1]
        m = math.prod(lead)
        from ..ops import w4_matmul as k5  # ops import this module

        if x.is_cuda and x.dtype == torch.bfloat16 and m <= k5.MAX_ROWS:
            y = k5.w4_matmul(x.reshape(m, k), self.w_p).to(x.dtype).reshape(*lead, -1)
        else:
            y = torch.matmul(x, unpack4(self.w_p).to(x.dtype).t())
        y = y * self.w_s.to(x.dtype)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y


def quantize_weight(weight: torch.Tensor, bits: int = 8,
                    amax: Optional[torch.Tensor] = None):
    """(codes, fp32 scales [out]) of a [out, in] weight: scale = amax over
    the input axis * fp32(1 / qmax) + 1e-12, codes int8 (bits 8) or packed
    by `pack4` (bits 4). `amax`, when given, replaces the weight's own (a
    tensor-parallel slice of the input axis keeps the whole weight's)."""
    qmax = QMAX[bits]
    w = weight.detach().float()
    if amax is None:
        amax = w.abs().amax(dim=1)
    scale = amax * (1.0 / qmax) + 1e-12
    q = torch.clamp(torch.round(w / scale[:, None]), -qmax, qmax).to(torch.int8)
    return (pack4(q) if bits == 4 else q), scale


def quantize_linear(lin: Linear, bits: int = 8):
    """Symmetric per-output-channel quantization of a linear layer
    (`quantize_weight`): the JAX package's `_quantize_w` as XLA compiles it
    (a multiply by the reciprocal), so the scales are its own bit for bit;
    qmax 127 for bits=8 (a QuantLinear) and 7 for bits=4 (a QuantLinear4,
    codes packed). A layer with its own `quantized` (a tensor-parallel row
    split) quantizes itself."""
    if hasattr(lin, "quantized"):
        return lin.quantized(bits)
    codes, scale = quantize_weight(lin.weight, bits)
    return (QuantLinear4 if bits == 4 else QuantLinear)(codes, scale, lin.bias)


def uniform_(t: torch.Tensor, lo: float, hi: float, gen: torch.Generator) -> None:
    """Fill t in place with U(lo, hi) drawn in fp32 from `gen` (on t's device)."""
    with torch.no_grad():
        r = torch.rand(t.shape, generator=gen, device=t.device, dtype=torch.float32)
        t.copy_(r * (hi - lo) + lo)


def normal_(t: torch.Tensor, std: float, gen: torch.Generator) -> None:
    with torch.no_grad():
        r = torch.randn(t.shape, generator=gen, device=t.device, dtype=torch.float32)
        t.copy_(r * std)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_head: int,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scaled dot-product attention [B, T, D] x [B, S, D] -> [B, T, D] with
    fp32 logits and softmax; the weights are cast to q.dtype for the value
    product. mask: additive fp32 bias broadcastable to [B, H, T, S]."""
    b, t, d = q.shape
    dh = d // n_head
    qh = q.reshape(b, t, n_head, dh).transpose(1, 2)
    kh = k.reshape(b, k.shape[1], n_head, dh).transpose(1, 2)
    vh = v.reshape(b, v.shape[1], n_head, dh).transpose(1, 2)
    qk = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * (dh ** -0.5)
    if mask is not None:
        qk = qk + mask
    w = torch.softmax(qk, dim=-1).to(q.dtype)
    out = torch.matmul(w, vh)
    return out.transpose(1, 2).reshape(b, t, d)


class MultiHeadAttention(nn.Module):
    def __init__(self, n_state: int, device=None, dtype=torch.float32):
        super().__init__()
        self.query = Linear(n_state, n_state, device=device, dtype=dtype)
        self.key = Linear(n_state, n_state, bias=False, device=device, dtype=dtype)
        self.value = Linear(n_state, n_state, device=device, dtype=dtype)
        self.out = Linear(n_state, n_state, device=device, dtype=dtype)


class ResidualAttentionBlock(nn.Module):
    """Pre-LN block: self-attention, optional cross-attention, 4x GELU MLP."""

    def __init__(self, n_state: int, cross_attention: bool = False, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.attn = MultiHeadAttention(n_state, **kw)
        self.attn_ln = LayerNorm(n_state, **kw)
        self.cross_attn = MultiHeadAttention(n_state, **kw) if cross_attention else None
        self.cross_attn_ln = LayerNorm(n_state, **kw) if cross_attention else None
        self.mlp = nn.Sequential(Linear(n_state, 4 * n_state, **kw), nn.GELU(),
                                 Linear(4 * n_state, n_state, **kw))
        self.mlp_ln = LayerNorm(n_state, **kw)

    def forward(self, x: torch.Tensor, n_head: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Plain self-attention block (the TL-TR head's transformer layers)."""
        h = self.attn_ln(x)
        q, k, v = self.attn.query(h), self.attn.key(h), self.attn.value(h)
        # a tensor-parallel split attends over its own columns
        attend = getattr(self.attn.query, "attend", None)
        a = attend(q, k, v, n_head, mask) if attend else attention(q, k, v, n_head, mask=mask)
        x = x + self.attn.out(a)
        h = self.mlp_ln(x)
        return x + self.mlp[2](gelu(self.mlp[0](h)))


def reset_random_(module: nn.Module, gen: torch.Generator) -> None:
    """Random init of every Linear (uniform); LayerNorms to ones/zeros."""
    for m in module.modules():
        if isinstance(m, Linear):
            m.reset_random(gen)
        elif isinstance(m, LayerNorm):
            with torch.no_grad():
                m.weight.fill_(1.0)
                m.bias.fill_(0.0)
