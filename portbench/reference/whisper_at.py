"""A plain Whisper-AT in float32: log-mel, encoder with pooled taps, TL-TR
head, and the decoder's logits over whole token rows.

Follows the published model (openai/whisper `model.py` and `audio.py`,
Whisper-AT's TL-TR head, Gong et al. 2023) on a state dict under the
reference checkpoints' names. Plain torch operations only, no cache, no
kernels, no quantization but the decoder's stated codes (`quant`); it
imports nothing of the program it judges.
Each weight is upcast to float32 when it is read, so a bf16 state dict is
served as the program gets it. Matrix products run in float32 with TF32
off (`fp32_matmuls`).

`quant`: the decoder's quantization as the configuration states it, worked
out again here from the published scheme (symmetric, scale = amax / qmax +
1e-12, codes round(x / scale) clipped to +-qmax, qmax 127 at 8 bits and 7 at
4): "weight_bits" quantizes each output channel of the decoder's self-
attention q, k, v and out, cross-attention q and out and MLP weights;
"kv_bits" each head's cross-attention key and value at each audio position;
"self_kv_bits" each head's self-attention key and value at each position.
The arithmetic stays float32: only the stated codes are the program's.

`matmul_bits`: the control. "fp8" rounds both operands of every linear
layer and convolution to float8 e4m3 with a per-tensor scale before the
float32 product: the reference one precision below the bf16 the
configuration states.

Departures from the published code: the key projection has no bias
(as published); the attention scale dh^-0.5 is applied to the logits once
rather than dh^-0.25 to q and k each, which is the same product.
"""

import contextlib
import os
import re
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
N_FRAMES = 3000
N_SAMPLES = 30 * SAMPLE_RATE
POOL = 20
FP8_MAX = 448.0
QMAX = {8: 127.0, 4: 7.0}
# the decoder weights the configuration's weight quantization covers
QUANTIZED_WEIGHTS = re.compile(
    r"^decoder\.blocks\.\d+\.(attn\.(query|key|value|out)|cross_attn\.(query|out)|mlp\.[02])$")

_ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "whisper_at_tpu", "assets")


@contextlib.contextmanager
def fp32_matmuls():
    """float32 products without TF32, restored afterwards."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def mel_filters(device) -> torch.Tensor:
    """The 80-bin mel filterbank [80, 201], read from the asset file as data."""
    with np.load(os.path.join(_ASSETS, "mel_filters.npz")) as f:
        return torch.from_numpy(f["mel_80"].astype(np.float32)).to(device)


def log_mel(pcm: np.ndarray, device) -> torch.Tensor:
    """Whisper's log-mel [80, frames] of int16 PCM with its 30 s tail of
    zeros (the transcription paths' padding): a Hann STFT (centred, reflect
    padding, the last frame dropped), power, mel, log10 clamped at 1e-10,
    floored 8 dB under the recording's maximum, (x + 4) / 4."""
    x = torch.from_numpy(np.asarray(pcm, np.int16).astype(np.float32) / 32768.0).to(device)
    x = F.pad(x, (0, N_SAMPLES))
    window = torch.hann_window(N_FFT, device=device)
    stft = torch.stft(x, N_FFT, HOP_LENGTH, window=window, return_complex=True)
    power = stft[..., :-1].abs() ** 2
    with fp32_matmuls():
        mel = mel_filters(device) @ power
    log_spec = torch.clamp(mel, min=1e-10).log10()
    log_spec = torch.maximum(log_spec, log_spec.max() - 8.0)
    return (log_spec + 4.0) / 4.0


def quantize(x: torch.Tensor, bits: Optional[int], dim: int = -1) -> torch.Tensor:
    """x with each slice along `dim` replaced by its symmetric codes times
    their scale (bits None: x itself)."""
    if bits is None:
        return x
    qmax = QMAX[bits]
    scale = x.abs().amax(dim=dim, keepdim=True) / qmax + 1e-12
    return torch.clamp(torch.round(x / scale), -qmax, qmax) * scale


def mel_window(mel: torch.Tensor, w: int) -> torch.Tensor:
    """Window w [80, 3000] of a recording's mel (the tail pads the last)."""
    out = mel[:, w * N_FRAMES:(w + 1) * N_FRAMES]
    return F.pad(out, (0, N_FRAMES - out.shape[1]))


class Reference:
    """The float32 model over a state dict `sd` (name -> tensor)."""

    def __init__(self, sd: Dict[str, torch.Tensor], dims: Dict[str, int], at_mode: str,
                 quant: Optional[Dict[str, Optional[int]]] = None,
                 matmul_bits: Optional[str] = None):
        if matmul_bits not in (None, "fp8"):
            raise ValueError(f"matmul_bits {matmul_bits!r}: None or 'fp8'")
        self.sd, self.dims, self.matmul_bits = sd, dims, matmul_bits
        quant = quant or {}
        self.weight_bits = quant.get("weight_bits")
        self.kv_bits, self.self_kv_bits = quant.get("kv_bits"), quant.get("self_kv_bits")
        parts = at_mode.split("_")
        if not at_mode.startswith("tl_tr_"):
            raise ValueError(f"the reference has the tl_tr heads, not {at_mode!r}")
        self.time_heads, self.layer_heads = int(parts[-2]), int(parts[-1])

    # ------------------------------------------------------------ pieces
    def w(self, name: str) -> torch.Tensor:
        return self.sd[name].float()

    def _round(self, x: torch.Tensor) -> torch.Tensor:
        if self.matmul_bits is None:
            return x
        scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale

    def linear(self, x: torch.Tensor, prefix: str, bias: bool = True) -> torch.Tensor:
        w = self.w(f"{prefix}.weight")
        if QUANTIZED_WEIGHTS.match(prefix):
            w = quantize(w, self.weight_bits, dim=1)
        y = self._round(x) @ self._round(w).t()
        return y + self.w(f"{prefix}.bias") if bias else y

    def conv(self, x: torch.Tensor, prefix: str, stride: int) -> torch.Tensor:
        return F.conv1d(self._round(x), self._round(self.w(f"{prefix}.weight")),
                        self.w(f"{prefix}.bias"), stride=stride, padding=1)

    def ln(self, x: torch.Tensor, prefix: str) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.w(f"{prefix}.weight"),
                            self.w(f"{prefix}.bias"), eps=1e-5)

    def attention(self, x: torch.Tensor, xa: Optional[torch.Tensor], prefix: str,
                  n_head: int, causal: bool = False, kv_bits: Optional[int] = None
                  ) -> torch.Tensor:
        """Multi-head attention; kv_bits quantizes each head's key and value
        at each position."""
        kv = x if xa is None else xa
        q = self.linear(x, f"{prefix}.query")
        k = self.linear(kv, f"{prefix}.key", bias=False)
        v = self.linear(kv, f"{prefix}.value")
        b, t, d = q.shape
        s, dh = k.shape[1], d // n_head
        q = q.view(b, t, n_head, dh).transpose(1, 2)
        k = quantize(k.view(b, s, n_head, dh), kv_bits).transpose(1, 2)
        v = quantize(v.view(b, s, n_head, dh), kv_bits).transpose(1, 2)
        qk = (q @ k.transpose(-1, -2)) * dh ** -0.5
        if causal:
            qk = qk + torch.full((t, s), float("-inf"), device=x.device).triu(1)
        out = (torch.softmax(qk, dim=-1) @ v).transpose(1, 2).reshape(b, t, d)
        return self.linear(out, f"{prefix}.out")

    def block(self, x, prefix: str, n_head: int, xa=None, causal: bool = False):
        """A pre-LN block; with xa, the decoder's (its self and cross K/V
        quantized as the configuration states)."""
        decoder = xa is not None
        x = x + self.attention(self.ln(x, f"{prefix}.attn_ln"), None, f"{prefix}.attn",
                               n_head, causal, self.self_kv_bits if decoder else None)
        if decoder:
            x = x + self.attention(self.ln(x, f"{prefix}.cross_attn_ln"), xa,
                                   f"{prefix}.cross_attn", n_head, kv_bits=self.kv_bits)
        h = F.gelu(self.linear(self.ln(x, f"{prefix}.mlp_ln"), f"{prefix}.mlp.0"))
        return x + self.linear(h, f"{prefix}.mlp.2")

    # ------------------------------------------------------------ model
    @torch.no_grad()
    def encode(self, mel: torch.Tensor):
        """mel [B, 80, 3000] -> (features [B, 1500, D] after ln_post, taps
        [B, L, 75, D]: each block's output averaged over 20 frames)."""
        dims = self.dims
        with fp32_matmuls():
            x = F.gelu(self.conv(mel.float(), "encoder.conv1", 1))
            x = F.gelu(self.conv(x, "encoder.conv2", 2)).transpose(1, 2)
            x = x + self.w("encoder.positional_embedding")[:x.shape[1]]
            b, t, d = x.shape
            taps = []
            for i in range(dims["n_audio_layer"]):
                x = self.block(x, f"encoder.blocks.{i}", dims["n_audio_head"])
                taps.append(x.reshape(b, t // POOL, POOL, d).mean(dim=2))
            return self.ln(x, "encoder.ln_post"), torch.stack(taps, dim=1)

    @torch.no_grad()
    def tags(self, taps: torch.Tensor, segment: int = 25) -> torch.Tensor:
        """taps [B, L, 75, D] -> TL-TR logits [B, n_seg, 527]: a transformer
        over each segment's pooled frames of each layer (mean-pooled), then
        one over the layers (mean-pooled), LN and the classifier."""
        b, n_layer, t, d = taps.shape
        n_seg = -(-t // segment)
        x = F.pad(taps.float(), (0, 0, 0, n_seg * segment - t))
        x = x.reshape(b, n_layer, n_seg, segment, d).transpose(1, 2)
        x = x.reshape(b * n_seg * n_layer, segment, d)
        with fp32_matmuls():
            x = self.block(x, "at_model.time_tr", self.time_heads).mean(dim=1)
            x = x.reshape(b * n_seg, n_layer, d)
            x = self.block(x, "at_model.layer_tr", self.layer_heads).mean(dim=1)
            logits = self.linear(self.ln(x, "at_model.mlp_layer.0"), "at_model.mlp_layer.1")
        return logits.reshape(b, n_seg, -1)

    @torch.no_grad()
    def logits(self, tokens: torch.Tensor, features: torch.Tensor) -> torch.Tensor:
        """Causal decoder over whole rows tokens [B, S] cross-attending to
        features [B, 1500, D] -> float32 logits [B, S, V]."""
        dims = self.dims
        with fp32_matmuls():
            x = (self.w("decoder.token_embedding.weight")[tokens]
                 + self.w("decoder.positional_embedding")[:tokens.shape[1]])
            for i in range(dims["n_text_layer"]):
                x = self.block(x, f"decoder.blocks.{i}", dims["n_text_head"], xa=features,
                               causal=True)
            x = self.ln(x, "decoder.ln")
            return self._round(x) @ self._round(self.w("decoder.token_embedding.weight")).t()


def allowed_mask(n_vocab: int, suppress: Sequence[int], suppress_from: int, device):
    """bool [V]: the tokens greedy decoding may pick (the suppressed set,
    the timestamps from `suppress_from` on, removed)."""
    mask = torch.ones(n_vocab, dtype=torch.bool, device=device)
    mask[torch.as_tensor(list(suppress), dtype=torch.long, device=device)] = False
    mask[suppress_from:] = False
    return mask


def served_token_gaps(logits: torch.Tensor, served: torch.Tensor, allowed: torch.Tensor,
                      first_blocked: Sequence[int]):
    """For each served token t (logits [n, V] at the positions that chose
    them): the gap by which its logit lies below the best allowed logit,
    and its log-probability under the allowed softmax. At the first
    position `first_blocked` (blank, EOT) is not allowed either. A served
    token that is not allowed has an infinite gap."""
    mask = allowed[None, :].repeat(logits.shape[0], 1)
    mask[0, torch.as_tensor(list(first_blocked), device=logits.device)] = False
    filtered = logits.masked_fill(~mask, float("-inf"))
    chosen = filtered.gather(1, served[:, None])[:, 0]
    gaps = filtered.amax(dim=-1) - chosen
    logprobs = chosen - torch.logsumexp(filtered, dim=-1)
    return gaps, logprobs
