"""The Whisper-AT model: encoder, decoder and TL-TR head in one `nn.Module`.

Counterpart of `whisper_at_tpu/models/whisper.py`. Parameter names follow
the reference checkpoints, so a reference state dict loads directly (see
`load_model` in the package root); `convert.from_jax_params` turns the JAX
package's parameter tree into the same state dict.
"""

import base64
import gzip
import os
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..utils import resolve_device
from .at_head import ATHead, at_head_apply, at_window_geometry
from .decoder import (
    Parts,
    TextDecoder,
    decoder_forward_with_qk,
    fuse_decoder_blocks,
    quantize_decoder_blocks,
)
from .dims import MULTILINGUAL_VOCAB, ModelDimensions, dims_for
from .encoder import AudioEncoder, encoder_apply
from .layers import reset_random_


def default_alignment_heads(dims: ModelDimensions) -> np.ndarray:
    """Every head of the last half of the decoder layers, as bool [L, H]."""
    heads = np.zeros((dims.n_text_layer, dims.n_text_head), dtype=bool)
    heads[dims.n_text_layer // 2:] = True
    return heads


def decode_alignment_heads(dump: bytes, dims: ModelDimensions) -> np.ndarray:
    """A base85 + gzip alignment-head mask (`registry._ALIGNMENT_HEADS`) as
    bool [L, H]; raises ValueError when it does not fit `dims`."""
    array = np.frombuffer(gzip.decompress(base64.b85decode(dump)), dtype=bool).copy()
    return array.reshape(dims.n_text_layer, dims.n_text_head)


class Whisper(nn.Module):
    """Whisper backbone + TL-TR tagging head. `alignment_heads` (bool
    [L, H]) marks the cross-attention heads word timing reads."""

    def __init__(self, dims: ModelDimensions, at_low_compute: bool = False,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.dims = dims
        self.at_mode = "tl_down_tr_512_1_8" if at_low_compute else "tl_tr_1_8"
        self.encoder = AudioEncoder(dims, device=device, dtype=dtype)
        self.decoder = TextDecoder(dims, device=device, dtype=dtype)
        self.at_model = ATHead(dims.n_audio_state, self.at_mode, device=device, dtype=dtype)
        self.requires_grad_(False)
        self._decode_params = {}
        self.alignment_heads = default_alignment_heads(dims)
        self.tp = None     # the tensor-parallel axis (parallel.inference.place_model_tp)
        self._mesh = None  # the mesh the model was placed on

    @property
    def text_heads(self) -> int:
        """Decoder heads this rank holds: all, or n_text_head / tp."""
        return self.dims.n_text_head // (self.tp.size if self.tp else 1)

    @property
    def audio_heads(self) -> int:
        """Encoder heads this rank holds: all, or n_audio_head / tp."""
        return self.dims.n_audio_head // (self.tp.size if self.tp else 1)

    @property
    def device(self) -> torch.device:
        return self.decoder.token_embedding.weight.device

    @property
    def is_multilingual(self) -> bool:
        return self.dims.n_vocab == MULTILINGUAL_VOCAB

    @staticmethod
    def compute_dtype(fp16: bool = True):
        """Half precision is bfloat16."""
        return torch.bfloat16 if fp16 else torch.float32

    def set_alignment_heads(self, dump: bytes) -> None:
        self.alignment_heads = decode_alignment_heads(dump, self.dims)

    def reset_random(self, gen: torch.Generator) -> None:
        self.encoder.reset_random(gen)
        self.decoder.reset_random(gen)
        reset_random_(self.at_model, gen)

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        self._decode_params = {}
        return super().load_state_dict(state_dict, strict=strict, assign=assign)

    def decoder_params_decode(self, weight_quant: bool = False,
                              weight_bits: int = 8) -> Parts:
        """Decode-form decoder parameters (fused q/k/v; with weight_quant,
        int8 weights at weight_bits=8 or packed int4 at weight_bits=4), built
        from the plain weights once per width and cached."""
        key = weight_bits if weight_quant else 0
        if 0 not in self._decode_params:
            self._decode_params[0] = fuse_decoder_blocks(self.decoder)
        if key not in self._decode_params:
            self._decode_params[key] = quantize_decoder_blocks(
                self._decode_params[0], weight_bits)
        return self._decode_params[key]

    def embed_audio(self, mel: torch.Tensor, fp16: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """mel [B, 80, 3000] -> (features [B, 1500, D], taps [B, L, 75, D]).
        WHISPER_AT_TPU_ENC_ATTN ("single", "flash" or "xla") and
        WHISPER_AT_TPU_ENC_MLP ("fused" or "xla") choose the encoder's
        kernels, read on every call as the JAX package reads them."""
        if mel.dim() == 2:
            mel = mel[None]
        return encoder_apply(self.encoder, mel, self.audio_heads,
                             self.compute_dtype(fp16),
                             attn_impl=os.environ.get("WHISPER_AT_TPU_ENC_ATTN", "single"),
                             mlp_impl=os.environ.get("WHISPER_AT_TPU_ENC_MLP", "fused"))

    def at_forward(self, audio_rep: torch.Tensor, time_resolution: float = 10) -> torch.Tensor:
        """Tag logits [B, n_seg, 527] (or [n_seg, 527]) from taps [B, L, T, D]."""
        single = audio_rep.dim() == 3
        if single:
            audio_rep = audio_rep[None]
        window, n_seg = at_window_geometry(audio_rep.shape[2], time_resolution)
        out = at_head_apply(self.at_model, audio_rep, window, n_seg)
        return out[0] if single else out

    def logits(self, tokens: torch.Tensor, audio_features: torch.Tensor,
               fp16: bool = True) -> torch.Tensor:
        """Full (non-incremental) decoder forward -> fp32 logits [B, S, V]."""
        no_heads = np.zeros_like(self.alignment_heads)
        return decoder_forward_with_qk(self.decoder, tokens, audio_features, no_heads,
                                       self.text_heads, self.compute_dtype(fp16))[0]


def build_model(name: str, device="cuda", dtype=torch.float32, seed: int = 0,
                at_low_compute: bool = False, dims: Optional[ModelDimensions] = None
                ) -> Whisper:
    """A model of an official size (or of `dims`) with random weights drawn
    from a torch.Generator seeded with `seed` on `device`."""
    dev = resolve_device(device)
    model = Whisper(dims or dims_for(name), at_low_compute=at_low_compute,
                    device=dev, dtype=dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    model.reset_random(gen)
    return model.eval()
