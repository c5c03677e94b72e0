"""Text decoder with a preallocated self-attention cache.

Counterpart of `whisper_at_tpu/models/decoder.py`. The cache is written in
place at `write_pos` (the JAX package threads it functionally). Prompts are
right-aligned into a fixed prefill bucket: slots [0, pad) are masked out and
the position embedding is indexed by slot - pad.

On the decode path the cross-attention K/V of every layer is precomputed
once per batch, int8- or int4-quantized by K3 (`ops/kv_quant.py`), and read
each step by K4 (`ops/cross_decode.py`) when heads x query rows <= 256, else
by an einsum over the same layout. The self cache can hold int8 or int4
codes (plain PyTorch: the JAX package has no kernel for it). int4 codes are
packed by `layers.pack4` everywhere.

Two switches of the JAX package choose its alternative kernels here:
WHISPER_AT_TPU_CROSS_DECODE=stream serves K4's calls with K10
(`ops/cross_decode_stream.py`), at both widths; `FUSED_MLP = True` runs the
decode MLP through K8 (`ops/fused_mlp.py`) over all B*S rows where they
are at most its MAX_ROWS, and a larger prefill through the unfused MLP (the
JAX code feeds its kernel the first position only, which would drop every
other prefill position; that is not carried over). The JAX package reads the
variable once, at import, because its decode traces are cached; eager
PyTorch caches nothing, so the port reads it once per `decoder_forward`
call. That is the one difference in when it is read; the port also
refuses a value other than `stream` or nothing, which the JAX package
treats as unset.

The full (non-incremental) forward, `decoder_forward_with_qk`, runs over
whole token rows on the plain decoder weights: word timing reads the
cross-attention logits of the alignment heads it keeps, `Whisper.logits`
(language detection) reads its logits alone.
"""

import os
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..ops.cross_decode import cross_attention_int4, cross_attention_int8, pad_bias
from ..ops.cross_decode_stream import cross_attention_stream, cross_attention_stream4
from ..ops import fused_mlp as k8
from ..ops.fused_mlp import fused_mlp
from ..ops.kv_quant import pad_ta, project_quantize_kv, project_quantize_kv4, quantize_sym
from .layers import (
    LayerNorm,
    Linear,
    ResidualAttentionBlock,
    attention,
    gelu,
    normal_,
    pack4,
    quantize_linear,
    reset_random_,
    unpack4,
)

NEG_INF = float("-inf")
KERNEL_MAX_ROWS = 256  # heads x query rows up to which K4 (or K10) serves a call
# the decode MLP through K8, the counterpart of `use_fused_mlp` in the JAX
# package's decoder_forward (False there too)
FUSED_MLP = False
CROSS_DECODE_ENV = "WHISPER_AT_TPU_CROSS_DECODE"


def cross_decode_streamed() -> bool:
    """WHISPER_AT_TPU_CROSS_DECODE: "stream" selects K10 in place of K4;
    unset or empty keeps K4; anything else raises."""
    impl = os.environ.get(CROSS_DECODE_ENV, "")
    if impl not in ("", "stream"):
        raise ValueError(f"{CROSS_DECODE_ENV}={impl!r}: expected 'stream' or nothing")
    return impl == "stream"


class Embedding(nn.Module):
    def __init__(self, n_vocab: int, n_state: int, device=None, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_vocab, n_state, device=device, dtype=dtype))


class TextDecoder(nn.Module):
    def __init__(self, dims, device=None, dtype=torch.float32):
        super().__init__()
        d = dims.n_text_state
        self.token_embedding = Embedding(dims.n_vocab, d, device=device, dtype=dtype)
        self.positional_embedding = nn.Parameter(
            torch.empty(dims.n_text_ctx, d, device=device, dtype=dtype))
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(d, cross_attention=True, device=device, dtype=dtype)
            for _ in range(dims.n_text_layer))
        self.ln = LayerNorm(d, device=device, dtype=dtype)

    def reset_random(self, gen: torch.Generator) -> None:
        normal_(self.token_embedding.weight, 0.02, gen)
        normal_(self.positional_embedding, 0.01, gen)
        reset_random_(self, gen)


class Parts(nn.Module):
    """A named group of (shared) submodules and tensors: the decode-form
    parameters are regroupings of the model's own, not copies."""

    def __init__(self, **parts):
        super().__init__()
        for name, value in parts.items():
            setattr(self, name, value)


def fuse_decoder_blocks(decoder: TextDecoder) -> Parts:
    """Decode-form parameters: each layer's self-attention q/k/v projections
    concatenated into one [3D, D] linear (k's missing bias as zeros)."""
    blocks = []
    for blk in decoder.blocks:
        a = blk.attn
        qkv = Linear(1, 1, device="meta")  # a shell: both tensors are replaced
        qkv.weight = nn.Parameter(torch.cat([a.query.weight, a.key.weight, a.value.weight]),
                                  requires_grad=False)
        qkv.bias = nn.Parameter(torch.cat([a.query.bias, torch.zeros_like(a.query.bias),
                                           a.value.bias]), requires_grad=False)
        blocks.append(Parts(attn=Parts(qkv=qkv, out=a.out), attn_ln=blk.attn_ln,
                            cross_attn=blk.cross_attn, cross_attn_ln=blk.cross_attn_ln,
                            mlp=blk.mlp, mlp_ln=blk.mlp_ln))
    return Parts(token_embedding=decoder.token_embedding,
                 positional_embedding=decoder.positional_embedding,
                 blocks=nn.ModuleList(blocks), ln=decoder.ln)


def quantize_decoder_blocks(fused: Parts, bits: int = 8) -> Parts:
    """int8 (bits=8) or packed int4 (bits=4) per-output-channel weights for
    the decode loop's matmuls. The cross-attention key/value projections
    stay full precision: their output is quantized separately (K3)."""
    blocks = []
    for blk in fused.blocks:
        ca = blk.cross_attn
        blocks.append(Parts(
            attn=Parts(qkv=quantize_linear(blk.attn.qkv, bits),
                       out=quantize_linear(blk.attn.out, bits)),
            attn_ln=blk.attn_ln,
            cross_attn=Parts(query=quantize_linear(ca.query, bits), key=ca.key,
                             value=ca.value, out=quantize_linear(ca.out, bits)),
            cross_attn_ln=blk.cross_attn_ln,
            mlp=nn.Sequential(quantize_linear(blk.mlp[0], bits), nn.GELU(),
                              quantize_linear(blk.mlp[2], bits)),
            mlp_ln=blk.mlp_ln))
    return Parts(token_embedding=fused.token_embedding,
                 positional_embedding=fused.positional_embedding,
                 blocks=nn.ModuleList(blocks), ln=fused.ln)


@dataclass
class SelfKV:
    """Self-attention cache [L, B, H, ctx, Dh] in the compute dtype
    (bits None), or int8 codes (bits 8) or packed int4 codes [.., Dh/2]
    (bits 4) with fp32 scales [L, B, ctx, H] (one per row, slot and head)."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None
    bits: Optional[int] = None

    def select_rows(self, index: torch.Tensor) -> None:
        """Reorder every cache tensor along its row axis (beam search):
        codes, scales and packed nibbles alike."""
        for name in ("k", "v", "k_scale", "v_scale"):
            t = getattr(self, name)
            if t is not None:
                setattr(self, name, t.index_select(1, index))


@dataclass
class CrossKV:
    """Cross-attention K/V of every layer. Quantized (bits 8 or 4): codes
    [L, A, Ta_pad, D * bits / 8] (int4 packed), scales [L, A, H, Ta_pad],
    additive pad bias [Ta_pad] (K3/K4 layout); plain (bits None):
    [L, A, Ta, D] in the compute dtype."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None
    bias: Optional[torch.Tensor] = None
    bits: Optional[int] = None


def init_cache(n_layer: int, batch: int, n_ctx: int, n_state: int, dtype,
               n_head: int, quantize: bool = False, bits: int = 8, device=None) -> SelfKV:
    shape = (n_layer, batch, n_head, n_ctx, n_state // n_head)
    if quantize:
        codes = shape[:-1] + (shape[-1] * bits // 8,)
        scales = (n_layer, batch, n_ctx, n_head)
        return SelfKV(torch.zeros(codes, dtype=torch.int8, device=device),
                      torch.zeros(codes, dtype=torch.int8, device=device),
                      torch.zeros(scales, dtype=torch.float32, device=device),
                      torch.zeros(scales, dtype=torch.float32, device=device), bits)
    return SelfKV(torch.zeros(shape, dtype=dtype, device=device),
                  torch.zeros(shape, dtype=dtype, device=device))


def _split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    """[B, S, D] -> [B, H, S, Dh]."""
    b, s, d = x.shape
    return x.reshape(b, s, n_head, d // n_head).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, S, Dh] -> [B, S, D]."""
    b, h, s, dh = x.shape
    return x.transpose(1, 2).reshape(b, s, h * dh)


def precompute_cross_kv(params: Parts, xa: torch.Tensor, n_head: int,
                        compute_dtype=torch.float32, quantize: bool = False,
                        bits: int = 8) -> CrossKV:
    """Cross-attention K/V of every layer from the encoded audio xa [A, Ta, D];
    quantized by K3 at `bits` (8 or 4) when asked."""
    xa = xa.to(compute_dtype).contiguous()
    a, ta, d = xa.shape
    n_layer = len(params.blocks)
    if not quantize:
        k = torch.empty((n_layer, a, ta, d), dtype=compute_dtype, device=xa.device)
        v = torch.empty_like(k)
        for i, blk in enumerate(params.blocks):
            k[i] = blk.cross_attn.key(xa)
            v[i] = blk.cross_attn.value(xa)
        return CrossKV(k, v)
    ta_pad = pad_ta(ta)
    k = torch.empty((n_layer, a, ta_pad, d * bits // 8), dtype=torch.int8, device=xa.device)
    v = torch.empty_like(k)
    ks = torch.empty((n_layer, a, n_head, ta_pad), dtype=torch.float32, device=xa.device)
    vs = torch.empty_like(ks)
    project = project_quantize_kv4 if bits == 4 else project_quantize_kv
    for i, blk in enumerate(params.blocks):
        ca = blk.cross_attn
        project(xa, ca.key.weight, ca.value.weight, ca.value.bias,
                out=(k[i], ks[i], v[i], vs[i]))
    return CrossKV(k, v, ks, vs, pad_bias(ta, ta_pad, xa.device), bits)


def _cross_attn_apply(blk, h: torch.Tensor, cross: CrossKV, layer: int, n_head: int,
                      compute_dtype, group: int = 1, stream: bool = False) -> torch.Tensor:
    """One layer's cross-attention with the residual added. `group` query
    rows share one audio row; they fold into the query axis so each audio
    row's K/V is read once. `stream` serves K4's calls with K10."""
    q = blk.cross_attn.query(blk.cross_attn_ln(h))
    qh = _split_heads(q, n_head)                         # [B, H, S, Dh]
    b, _, s, dh = qh.shape
    a = b // group
    if group > 1:
        qh = qh.reshape(a, group, n_head, s, dh).transpose(1, 2).reshape(
            a, n_head, group * s, dh)
    rows = qh.shape[2]
    scale = dh ** -0.5
    if cross.bits is not None:
        ck, cv = cross.k[layer], cross.v[layer]
        ks, vs = cross.k_scale[layer], cross.v_scale[layer]
        ta_pad = ck.shape[1]
        if n_head * rows <= KERNEL_MAX_ROWS:
            q_rows = (qh * scale).reshape(a, n_head * rows, dh).to(compute_dtype)
            if stream:
                kernel = cross_attention_stream4 if cross.bits == 4 else cross_attention_stream
            else:
                kernel = cross_attention_int4 if cross.bits == 4 else cross_attention_int8
            out = kernel(q_rows.contiguous(), ck, ks, cv, vs, cross.bias, n_head)
            attn = out.reshape(a, n_head, rows, dh).to(compute_dtype)
        else:
            if cross.bits == 4:
                ck, cv = unpack4(ck), unpack4(cv)
            k4 = ck.reshape(a, ta_pad, n_head, dh).permute(0, 2, 3, 1)
            qk = (torch.matmul(qh.float(), k4.to(compute_dtype).float())
                  * ks[:, :, None, :] * scale + cross.bias)
            w = (torch.softmax(qk, dim=-1) * vs[:, :, None, :]).to(compute_dtype)
            v4 = cv.reshape(a, ta_pad, n_head, dh).permute(0, 2, 1, 3)
            attn = torch.matmul(w, v4.to(compute_dtype))
    else:
        kh = _split_heads(cross.k[layer].to(compute_dtype), n_head)
        vh = _split_heads(cross.v[layer].to(compute_dtype), n_head)
        qk = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
        attn = torch.matmul(torch.softmax(qk, dim=-1).to(compute_dtype), vh)
    if group > 1:
        attn = attn.reshape(a, n_head, group, s, dh).transpose(1, 2).reshape(
            b, n_head, s, dh)
    return h + blk.cross_attn.out(_merge_heads(attn))


def decoder_forward(params: Parts, tokens: torch.Tensor, cross: CrossKV,
                    cache: SelfKV, write_pos: int, pad: int, n_head: int,
                    compute_dtype=torch.float32, group: int = 1) -> torch.Tensor:
    """One pass over tokens [B, S] written at cache slots write_pos..+S
    (prefill: S = bucket; step: S = 1). Updates `cache` in place and returns
    the hidden states [B, S, D] after the final LN."""
    stream = cross_decode_streamed()
    dev = tokens.device
    s = tokens.shape[1]
    end = write_pos + s  # slots past `end` are masked, so they are not read
    pos = torch.clamp(torch.arange(write_pos, end, device=dev) - pad, min=0)
    x = (params.token_embedding.weight[tokens]
         + params.positional_embedding[pos]).to(compute_dtype)

    # key slot j is visible to query i iff pad <= j <= write_pos + i; the
    # `slots == qpos` term keeps a pad query row from being fully masked (a
    # fully masked softmax is NaN, which would poison the cache)
    slots = torch.arange(end, device=dev)[None, :]
    qpos = torch.arange(write_pos, end, device=dev)[:, None]
    allowed = ((slots >= pad) & (slots <= qpos)) | (slots == qpos)
    mask = torch.zeros(allowed.shape, device=dev).masked_fill(~allowed, NEG_INF)

    bits = cache.bits
    # K8 takes at most MAX_ROWS rows (every decode step, the smaller
    # prefills); a larger prefill takes the unfused MLP, as QuantLinear4
    # leaves rows past K5's limit to torch.matmul
    fused = FUSED_MLP and tokens.numel() <= k8.MAX_ROWS
    for i, blk in enumerate(params.blocks):
        q, k_new, v_new = blk.attn.qkv(blk.attn_ln(x)).chunk(3, dim=-1)
        qh = _split_heads(q, n_head)
        kh, vh = _split_heads(k_new, n_head), _split_heads(v_new, n_head)
        scale = qh.shape[-1] ** -0.5
        if bits is not None:
            # quantize the new slots, write their codes in place, read the
            # live prefix back (unpacked for int4)
            live = []
            for codes, scales, new in ((cache.k, cache.k_scale, kh),
                                       (cache.v, cache.v_scale, vh)):
                nq, ns = quantize_sym(new, dim=-1, bits=bits)
                codes[i, :, :, write_pos:end] = pack4(nq) if bits == 4 else nq
                scales[i, :, write_pos:end] = ns[..., 0].transpose(1, 2)
                prefix = codes[i, :, :, :end]
                live.append((unpack4(prefix) if bits == 4 else prefix).to(compute_dtype))
            k_s = cache.k_scale[i, :, :end].transpose(1, 2)  # [B, H, end]
            v_s = cache.v_scale[i, :, :end].transpose(1, 2)
            qk = (torch.matmul(qh.float(), live[0].float().transpose(-1, -2))
                  * k_s[:, :, None, :] * scale + mask)
            w = (torch.softmax(qk, dim=-1) * v_s[:, :, None, :]).to(compute_dtype)
            attn = torch.matmul(w, live[1])
        else:
            cache.k[i, :, :, write_pos:end] = kh.to(cache.k.dtype)
            cache.v[i, :, :, write_pos:end] = vh.to(cache.v.dtype)
            k_all = cache.k[i, :, :, :end].to(compute_dtype)
            qk = torch.matmul(qh.float(), k_all.float().transpose(-1, -2)) * scale + mask
            attn = torch.matmul(torch.softmax(qk, dim=-1).to(compute_dtype),
                                cache.v[i, :, :, :end].to(compute_dtype))
        x = x + blk.attn.out(_merge_heads(attn))
        x = _cross_attn_apply(blk, x, cross, i, n_head, compute_dtype, group, stream)
        h = blk.mlp_ln(x)
        if fused:
            b, s_, d = h.shape
            x = x + fused_mlp(h.reshape(b * s_, d), blk.mlp[0], blk.mlp[2]).reshape(b, s_, d)
        else:
            x = x + blk.mlp[2](gelu(blk.mlp[0](h)))
    return params.ln(x)


def decoder_forward_rows(params: Parts, tokens: torch.Tensor, cross: CrossKV,
                         cache: SelfKV, write_pos: torch.Tensor, pad: int, n_head: int,
                         compute_dtype=torch.float32) -> torch.Tensor:
    """`decoder_forward` with a write position per row: tokens [B, S] go to
    cache slots write_pos[b]..+S of row b (write_pos a [B] tensor on the
    device). The speculative loop's passes, whose rows advance at their own
    rates. Updates the plain cache in place (the quantized self cache is
    refused, as in the JAX package) and returns the hidden states [B, S, D]
    after the final LN.

    Positions are gathered per row and clamped to the position table (a row
    past its committed region writes slots that are rewritten before they
    are read), the mask is per row [B, 1, S, ctx] over the whole cache, the
    cache writes are one indexed store per tensor over the [B, S] slots, and
    the MLP is the unfused one. The cross-attention is `decoder_forward`'s:
    K4 (or K4-int4, or K10) serves it on quantized cross K/V at S query rows
    a head."""
    if cache.bits is not None:
        raise ValueError("decoder_forward_rows takes the plain self cache only")
    stream = cross_decode_streamed()
    dev = tokens.device
    b, s = tokens.shape
    n_ctx = cache.k.shape[3]
    offs = torch.arange(s, device=dev)
    qpos = write_pos[:, None] + offs[None, :]                       # [B, S] cache slots
    pos = torch.clamp(qpos - pad, 0, params.positional_embedding.shape[0] - 1)
    x = (params.token_embedding.weight[tokens]
         + params.positional_embedding[pos]).to(compute_dtype)
    slots = torch.arange(n_ctx, device=dev)[None, None, :]
    q3 = qpos[:, :, None]
    allowed = ((slots >= pad) & (slots <= q3)) | (slots == q3)
    mask = torch.zeros(allowed.shape, device=dev).masked_fill(~allowed, NEG_INF)[:, None]
    rows = torch.arange(b, device=dev)[:, None].expand(b, s)
    for i, blk in enumerate(params.blocks):
        q, k_new, v_new = blk.attn.qkv(blk.attn_ln(x)).chunk(3, dim=-1)
        qh = _split_heads(q, n_head)
        # [B, S, H, Dh] into slots qpos of each row (the slots stay inside
        # the cache: the loop sizes it total + lookahead + 1)
        cache.k[i][rows, :, qpos] = k_new.reshape(b, s, n_head, -1).to(cache.k.dtype)
        cache.v[i][rows, :, qpos] = v_new.reshape(b, s, n_head, -1).to(cache.v.dtype)
        scale = qh.shape[-1] ** -0.5
        qk = (torch.matmul(qh.float(), cache.k[i].to(compute_dtype).float().transpose(-1, -2))
              * scale + mask)
        attn = torch.matmul(torch.softmax(qk, dim=-1).to(compute_dtype),
                            cache.v[i].to(compute_dtype))
        x = x + blk.attn.out(_merge_heads(attn))
        x = _cross_attn_apply(blk, x, cross, i, n_head, compute_dtype, 1, stream)
        x = x + blk.mlp[2](gelu(blk.mlp[0](blk.mlp_ln(x))))
    return params.ln(x)


def project_logits(params: Parts, hidden: torch.Tensor) -> torch.Tensor:
    """Tied-embedding output projection in fp32: [B, S, D] -> [B, S, V]."""
    emb = params.token_embedding.weight.to(hidden.dtype).float()
    return torch.matmul(hidden.float(), emb.t())


def decoder_forward_with_qk(decoder: TextDecoder, tokens: torch.Tensor, xa: torch.Tensor,
                            head_mask, n_head: int, compute_dtype=torch.float32):
    """Full causal forward over tokens [B, S] on the plain (unfused,
    unquantized) decoder weights, cross-attending to xa [B, F, D], that also
    keeps the pre-softmax cross-attention logits (scaled by Dh^-0.5) of the
    heads that head_mask (bool [L, H]) selects.

    Returns (logits [B, S, V] fp32, qk [B, n_sel, S, F]), qk in the forward's
    precision class (fp32 for fp32, bf16 for bf16), its rows in (layer,
    head) order. Rows are independent under the causal mask, so a
    right-padded row gives its valid positions' exact-length values."""
    head_mask = torch.as_tensor(head_mask, dtype=torch.bool)
    b, s = tokens.shape
    dev = tokens.device
    x = (decoder.token_embedding.weight[tokens]
         + decoder.positional_embedding[:s]).to(compute_dtype)
    causal = torch.full((s, s), NEG_INF, device=dev).triu(1)
    xa = xa.to(compute_dtype)
    buf_dtype = torch.float32 if compute_dtype == torch.float32 else torch.bfloat16
    qk_sel = torch.empty((b, int(head_mask.sum()), s, xa.shape[1]), dtype=buf_dtype,
                         device=dev)
    slot = 0
    for i, blk in enumerate(decoder.blocks):
        h = blk.attn_ln(x)
        x = x + blk.attn.out(attention(blk.attn.query(h), blk.attn.key(h),
                                       blk.attn.value(h), n_head, mask=causal))
        q = _split_heads(blk.cross_attn.query(blk.cross_attn_ln(x)), n_head)
        kh = _split_heads(blk.cross_attn.key(xa), n_head)
        vh = _split_heads(blk.cross_attn.value(xa), n_head)
        qk = torch.matmul(q.float(), kh.float().transpose(-1, -2)) * (q.shape[-1] ** -0.5)
        attn = torch.matmul(torch.softmax(qk, dim=-1).to(compute_dtype), vh)
        x = x + blk.cross_attn.out(_merge_heads(attn))
        heads = torch.nonzero(head_mask[i]).flatten().tolist()
        if heads:
            qk_sel[:, slot:slot + len(heads)] = qk[:, heads].to(buf_dtype)
            slot += len(heads)
        x = x + blk.mlp[2](gelu(blk.mlp[0](blk.mlp_ln(x))))
    return project_logits(decoder, decoder.ln(x)), qk_sel

