"""Audio encoder: conv stem, transformer blocks on K1/K2, pooled taps.

Counterpart of `whisper_at_tpu/models/encoder.py::encoder_apply` and
`encoder_apply_taps`. The Whisper-AT addition: after every block the hidden
states are averaged 20x along time, and the per-layer stack [B, L, 75, D]
(taken before ln_post) feeds the TL-TR head. `encoder_apply_taps` is the
feature extractor's variant (truncated mel and positional embedding, the
embedding output as tap 0, no ln_post); both share one block loop.

The attention and MLP implementations are chosen as in the JAX package
(`whisper_at_tpu/ops/flash.py:37-59`): attn_impl "single" (K1, the
default), "flash" (K7) or "xla" (the plain attention); mlp_impl "fused"
(K2, the default) or "xla" (the plain MLP). `Whisper.embed_audio` reads
them from WHISPER_AT_TPU_ENC_ATTN and WHISPER_AT_TPU_ENC_MLP per call.

Under tensor parallelism (`parallel.inference.place_model_tp`) a block
holds its rank's heads and hidden units and n_head is the rank's count: the
kernels run on the rank's shard, and the fused MLP is K2-partial, its
sum over the ranks added to the residual and fc2's bias once.
"""

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.enc_attention import enc_attention
from ..ops.enc_flash import enc_flash
from ..ops.enc_mlp import enc_mlp, enc_mlp_partial
from .layers import (
    LayerNorm,
    ResidualAttentionBlock,
    attention,
    gelu,
    reset_random_,
    sinusoids,
    uniform_,
)

POOL = 20  # time pooling of the taps
ATTN_IMPLS = ("single", "flash", "xla")
MLP_IMPLS = ("fused", "xla")


class Conv1d(nn.Module):
    """Weight [out, in, 3] and bias [out] (torch Conv1d layout)."""

    def __init__(self, n_in: int, n_out: int, device=None, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_out, n_in, 3, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(n_out, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor, stride: int) -> torch.Tensor:
        y = F.conv1d(x, self.weight.to(x.dtype), stride=stride, padding=1)
        return y + self.bias.to(x.dtype)[:, None]


class AudioEncoder(nn.Module):
    def __init__(self, dims, device=None, dtype=torch.float32):
        super().__init__()
        d = dims.n_audio_state
        self.conv1 = Conv1d(dims.n_mels, d, device=device, dtype=dtype)
        self.conv2 = Conv1d(d, d, device=device, dtype=dtype)
        self.register_buffer("positional_embedding",
                             sinusoids(dims.n_audio_ctx, d).to(device=device, dtype=dtype))
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(d, device=device, dtype=dtype)
            for _ in range(dims.n_audio_layer))
        self.ln_post = LayerNorm(d, device=device, dtype=dtype)

    def reset_random(self, gen: torch.Generator) -> None:
        """Conv weights U(+-(3 * in)^-0.5) and zero conv biases, as the JAX
        package initializes them; the blocks as `reset_random_` does."""
        for conv in (self.conv1, self.conv2):
            std = (conv.weight.shape[1] * 3) ** -0.5
            uniform_(conv.weight, -std, std, gen)
            with torch.no_grad():
                conv.bias.zero_()
        reset_random_(self.blocks, gen)


def _stem(encoder: AudioEncoder, mel: torch.Tensor, compute_dtype) -> torch.Tensor:
    """mel [B, 80, F] -> [B, F/2, D]: the conv stem and the positional
    embedding's first F/2 rows."""
    x = mel.to(compute_dtype)
    x = gelu(encoder.conv1(x, stride=1))
    x = gelu(encoder.conv2(x, stride=2))                    # [B, D, T]
    t = x.shape[2]
    return (x.transpose(1, 2) + encoder.positional_embedding[:t].to(compute_dtype)).contiguous()


def _blocks(encoder: AudioEncoder, x: torch.Tensor, n_head: int, attn_impl: str,
            mlp_impl: str):
    """Each block's output in turn (`run_blocks` over every block)."""
    return run_blocks(encoder.blocks, x, n_head, attn_impl, mlp_impl)


def run_blocks(blocks, x: torch.Tensor, n_head: int, attn_impl: str = "single",
               mlp_impl: str = "fused"):
    """Each of `blocks`' outputs in turn, the attention on K1 ("single"),
    K7 ("flash") or the plain attention ("xla"), the MLP half-block on K2
    ("fused") or the plain chain ("xla"). A pipeline stage runs its own
    slice of the blocks through it."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl {attn_impl!r} is not one of {ATTN_IMPLS}")
    if mlp_impl not in MLP_IMPLS:
        raise ValueError(f"mlp_impl {mlp_impl!r} is not one of {MLP_IMPLS}")
    attend = {"single": enc_attention, "flash": enc_flash, "xla": attention}[attn_impl]
    for block in blocks:
        h = block.attn_ln(x)
        q, k, v = block.attn.query(h), block.attn.key(h), block.attn.value(h)
        x = x + block.attn.out(attend(q, k, v, n_head))
        x = mlp_block(block, x, mlp_impl)
        yield x


def mlp_block(block, x: torch.Tensor, mlp_impl: str = "fused") -> torch.Tensor:
    """x + fc2(gelu(fc1(LN(x)))) of one block: K2 ("fused"; K2-partial and
    a sum over the tp ranks under tensor parallelism) or the plain chain."""
    fc1, fc2 = block.mlp[0], block.mlp[2]
    tp = getattr(fc2, "tp", None)  # a tensor-parallel row split
    if mlp_impl == "fused" and tp is not None:
        from ..parallel.tensor import reduce_from_tp

        part = enc_mlp_partial(x, block.mlp_ln.weight, block.mlp_ln.bias,
                               fc1.weight, fc1.bias, fc2.weight)
        s = reduce_from_tp(part, tp)
        return (x.float() + s.float() + fc2.bias.float()).to(x.dtype)
    if mlp_impl == "fused":
        return enc_mlp(x, block.mlp_ln.weight, block.mlp_ln.bias,
                       fc1.weight, fc1.bias, fc2.weight, fc2.bias)
    return x + fc2(gelu(fc1(block.mlp_ln(x))))


def encoder_apply(encoder: AudioEncoder, mel: torch.Tensor, n_head: int,
                  compute_dtype=torch.float32, attn_impl: str = "single",
                  mlp_impl: str = "fused") -> Tuple[torch.Tensor, torch.Tensor]:
    """mel [B, 80, 3000] -> (features [B, 1500, D] after ln_post,
    taps [B, L, 75, D]: each block's output pooled 20x, before ln_post)."""
    x = _stem(encoder, mel, compute_dtype)
    b, t, d = x.shape
    taps = []
    for x in _blocks(encoder, x, n_head, attn_impl, mlp_impl):
        taps.append(x.reshape(b, t // POOL, POOL, d).mean(dim=2))
    return encoder.ln_post(x), torch.stack(taps, dim=1)


TAP_MODES = ("last", "all_nopool", "all_pool")


def encoder_apply_taps(encoder: AudioEncoder, mel: torch.Tensor, n_head: int,
                       tap_mode: str = "all_nopool", compute_dtype=torch.float32,
                       attn_impl: str = "single", mlp_impl: str = "fused") -> torch.Tensor:
    """The feature-extraction encoder (`whisper_at_tpu/models/encoder.py::
    encoder_apply_taps`): mel [B, 80, F] of any F up to 3000, the positional
    embedding cut to the F/2 positions, no ln_post, the embedding output
    kept as tap 0. The blocks are `encoder_apply`'s, on the same kernels.

    tap_mode 'last' -> [B, T, D] the last block's output; 'all_nopool' ->
    [B, L+1, T, D] the embedding and every block's output; 'all_pool' ->
    [B, L+1, D] their means over time."""
    if tap_mode not in TAP_MODES:
        raise ValueError(f"Unknown tap_mode: {tap_mode}")
    x = _stem(encoder, mel, compute_dtype)
    taps = [x]
    for x in _blocks(encoder, x, n_head, attn_impl, mlp_impl):
        taps.append(x)
    if tap_mode == "last":
        return x
    all_x = torch.stack(taps, dim=1)
    return all_x.mean(dim=2) if tap_mode == "all_pool" else all_x
