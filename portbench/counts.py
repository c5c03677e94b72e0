"""Operations, bytes and roofline bounds of the work a call does.

Copied from the port's `ops/flops.py` and `chip_smoke.py`'s kernel bounds,
with two corrections: a multiply-accumulate is two floating-point
operations, and a decoder position attends over its own number of keys,
not over every key of the finished row. Pure Python; `dims` is a
configuration's dims dict.

Peaks are those of one NVIDIA H100 SXM (NVIDIA's data sheet, dense): 989
TFLOP/s in bf16, 67 TFLOP/s in fp32 outside the tensor cores, 3.35 TB/s.
"""

from typing import Dict, List

PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
POOL = 20  # encoder frames a tap averages
MEL_FRAMES = 3000


def bound_s(flops: float, nbytes: float, peak_flops: float) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(flops / peak_flops, nbytes / PEAK_BYTES)


# --------------------------------------------------------------------------- #
# kernel bounds, per launch
# --------------------------------------------------------------------------- #


def k1_bound_s(b: int, t: int, d: int) -> float:
    """K1 (encoder attention) over [b, t, d]: the qk and av products, 4 b t^2 d
    operations; q, k, v read and the output written once in bf16."""
    return bound_s(4.0 * b * t * t * d, 2.0 * 4 * b * t * d, PEAK_BF16_FLOPS)


def k2_bound_s(m: int, d: int, f: int = None) -> float:
    """K2 (LN, fc1 + GELU, fc2 + residual) over m rows of d, f hidden units
    (4d): 4 m d f operations; x, the weights and out once in bf16, the LN
    and bias vectors once in fp32."""
    f = 4 * d if f is None else f
    return bound_s(4.0 * m * d * f, 2.0 * (2 * m * d + 2 * d * f) + 4.0 * (3 * d + f),
                   PEAK_BF16_FLOPS)


def k4_bound_s(a: int, n_head: int, groups: int, t: int, d: int, bits: int = 8) -> float:
    """K4 (cross-attention over the quantized cross K/V) at a audio rows, G
    query rows a head and t valid positions: the K and V codes and scales
    of the valid positions and the pad bias read once, q read and out
    written once; 4 a H G t dh fp32 operations (CUDA cores at G = 1)."""
    dh = d // n_head
    nbytes = (2 * a * t * d * bits / 8 + 2 * 4.0 * a * n_head * t + 4.0 * t
              + 2.0 * a * n_head * groups * dh + 4.0 * a * n_head * groups * dh)
    return bound_s(4.0 * a * n_head * groups * t * dh, nbytes, PEAK_FP32_FLOPS)


def chunks(windows: int, max_batch: int) -> List[int]:
    """Rows of each batch the entry runs the encoder and decoder on."""
    return [min(max_batch, windows - lo) for lo in range(0, windows, max_batch)]


# --------------------------------------------------------------------------- #
# multiply-accumulates of a call
# --------------------------------------------------------------------------- #


def _attention_macs(q_rows: int, keys: int, d: int) -> int:
    """Projections of q_rows queries (q, k, v, out) and their products over keys."""
    return 4 * q_rows * d * d + 2 * q_rows * keys * d


def _block_macs(seq: int, d: int) -> int:
    return _attention_macs(seq, seq, d) + 2 * seq * d * 4 * d


def encoder_macs(dims: Dict[str, int]) -> int:
    """One 30 s window: conv stem and blocks (ops/flops.py)."""
    t, d = dims["n_audio_ctx"], dims["n_audio_state"]
    conv = MEL_FRAMES * 3 * dims["n_mels"] * d + t * 3 * d * d
    return conv + dims["n_audio_layer"] * _block_macs(t, d)


def cross_kv_macs(dims: Dict[str, int]) -> int:
    """The cross-attention keys and values of every decoder layer (K3)."""
    return dims["n_text_layer"] * 2 * dims["n_audio_ctx"] * dims["n_text_state"] ** 2


def decoder_macs(dims: Dict[str, int], n_prompt: int, n_tokens: int) -> int:
    """Greedy decoding of n_tokens after n_prompt prompt tokens with a
    self cache: the prompt's positions and every sampled token but the last
    are forwarded, position p attending over p + 1 keys; logits at the SOT
    slot (no-speech), the last prompt slot and each forwarded token."""
    d, t_audio = dims["n_text_state"], dims["n_audio_ctx"]
    positions = n_prompt + max(n_tokens - 1, 0)
    keys = positions * (positions + 1) // 2  # sum over positions of p + 1
    per_layer = (4 * positions * d * d + 2 * keys * d            # self-attention
                 + 2 * positions * d * d + 2 * positions * t_audio * d  # cross q, out
                 + 2 * positions * d * 4 * d)                    # MLP
    logit_rows = 2 + max(n_tokens - 1, 0)
    return dims["n_text_layer"] * per_layer + logit_rows * d * dims["n_vocab"]


def tltr_macs(dims: Dict[str, int], mode: str, n_seg: int = 3, window: int = 25,
              labels: int = 527) -> int:
    """The TL-TR head over one window's taps (tl_tr_<time heads>_<layer
    heads>): a time transformer over each layer's n_seg segments of
    `window` pooled frames, a layer transformer over each segment's layers,
    the classifier on each segment's pooled vector."""
    if not mode.startswith("tl_tr_"):
        raise ValueError(f"counts cover the tl_tr head modes, not {mode!r}")
    d, layers = dims["n_audio_state"], dims["n_audio_layer"]
    return n_seg * (layers * _block_macs(window, d) + _block_macs(layers, d) + d * labels)


def window_macs(dims: Dict[str, int], at_mode: str, n_prompt: int, n_tokens: int) -> int:
    """Every product of one window: encoder, cross K/V, decoder, tags."""
    return (encoder_macs(dims) + cross_kv_macs(dims) + decoder_macs(dims, n_prompt, n_tokens)
            + tltr_macs(dims, at_mode))


def flops_from_macs(macs: float) -> float:
    return 2.0 * macs


def mfu_percent(macs: float, seconds: float) -> float:
    """Share of the bf16 peak, in percent, of `macs` products in `seconds`."""
    return 100.0 * flops_from_macs(macs) / (seconds * PEAK_BF16_FLOPS)
