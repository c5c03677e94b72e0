"""Closed-form operation counts of the TL-TR heads and the Whisper backbone.

Counterpart of `whisper_at_tpu/ops/flops.py`, integer for integer: matmul
multiply-accumulates only (one MAC counted as one FLOP, fvcore's
convention; elementwise work ignored). Pure Python.

    python -m whisper_at_tpu_torch.ops.flops

prints the tagging head's share of a 30 s window's ASR cost for each size.
"""

from typing import Dict

from ..models.dims import ModelDimensions
from ..train.tltr import parse_tltr_mode


def _attention_flops(seq: int, dim: int) -> int:
    # q/k/v/out projections + qk and av matmuls (MACs)
    return 4 * seq * dim * dim + 2 * seq * seq * dim


def _block_flops(seq: int, dim: int) -> int:
    return _attention_flops(seq, dim) + 2 * seq * dim * 4 * dim


def tltr_flops(mode: str, n_layer: int, rep_dim: int, t: int = 25,
               label_dim: int = 527) -> int:
    """MACs of one TL-TR forward on [n_layer, t, rep_dim] features. Takes the
    research names (lw_tr*) and the inference head's (tl_tr*, tl_down_tr*)."""
    mode = mode.replace("tl_down_tr", "lw_down_tr")
    if mode.startswith("tl_tr"):
        mode = "lw_tr" + mode[len("tl_tr"):]
    cfg = parse_tltr_mode(mode)
    d = cfg["inter_dim"] if cfg["down"] else rep_dim
    total = 0
    if cfg["down"]:
        total += n_layer * t * rep_dim * cfg["inter_dim"]
    if cfg["time_tr"]:
        n_seq = n_layer if cfg["layer_tr"] else 1
        total += n_seq * _block_flops(t, d)
    if cfg["layer_tr"]:
        total += _block_flops(n_layer, d)
    total += d * label_dim  # classifier on the pooled vector
    return total


def encoder_flops(dims: ModelDimensions) -> int:
    """MACs of one 30 s encoder forward (conv stem + blocks)."""
    t_mel, t = 3000, dims.n_audio_ctx
    d = dims.n_audio_state
    conv = t_mel * 3 * dims.n_mels * d + t * 3 * d * d
    return conv + dims.n_audio_layer * _block_flops(t, d)


def decoder_flops(dims: ModelDimensions, n_tokens: int) -> int:
    """MACs of decoding n_tokens with a KV cache (per-token incremental)."""
    d = dims.n_text_state
    t_audio = dims.n_audio_ctx
    per_token = 0
    # self-attn projections + attention over <= n_tokens cached keys
    per_token += 4 * d * d + 2 * n_tokens * d
    # cross-attn query/out + attention over audio keys
    per_token += 2 * d * d + 2 * t_audio * d
    per_token += 2 * d * 4 * d
    per_token *= dims.n_text_layer
    per_token += d * dims.n_vocab  # output projection
    cross_kv = dims.n_text_layer * 2 * t_audio * d * d  # precomputed once
    return cross_kv + n_tokens * per_token


def at_overhead(dims: ModelDimensions, mode: str = "tl_tr_1_8") -> Dict[str, float]:
    """Audio-tagging MACs as a fraction of the ASR encoder + decoder cost."""
    enc = encoder_flops(dims)
    dec = decoder_flops(dims, 100)
    at = tltr_flops(mode, dims.n_audio_layer, dims.n_audio_state, t=25) * 3
    return {
        "encoder_flops": float(enc),
        "decoder_flops": float(dec),
        "at_flops": float(at),
        "at_overhead_ratio": at / (enc + dec),
    }


def count_parameters(params) -> int:
    """Elements of a module's parameters, or of the leaves of a nested dict
    of arrays."""
    if hasattr(params, "parameters"):
        return sum(p.numel() for p in params.parameters())
    return sum(count_parameters(v) if isinstance(v, dict) else int(v.size)
               for v in params.values())


def _cli():
    from ..models.dims import dims_for

    for name in ("tiny", "base", "small", "medium", "large-v1"):
        dims = dims_for(name)
        full = at_overhead(dims, "tl_tr_1_8")
        low = at_overhead(dims, "tl_down_tr_512_1_8")
        print(f"{name:9s} TL-TR {100*full['at_overhead_ratio']:.2f}%  "
              f"TL-TR-512 {100*low['at_overhead_ratio']:.2f}%")


if __name__ == "__main__":
    _cli()
