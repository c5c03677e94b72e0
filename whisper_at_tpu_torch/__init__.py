"""whisper_at_tpu_torch: Whisper-AT (speech recognition + AudioSet tagging)
in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

The port of `whisper_at_tpu` (JAX). Entry points run on the card
(`device="cuda"`) unless the caller passes `device="cpu"`, and raise when
no card is present. Importing the package loads no JAX and builds nothing.
"""

import os
import warnings
from typing import Optional

import torch

from .at_post_processing import parse_at_label
from .audio import (
    PrefetchedAudio,
    load_audio,
    load_audio_pcm16,
    log_mel_spectrogram,
    pad_or_trim,
    prefetch_audio,
    prefetch_audio_many,
)
from .decoding import DecodingOptions, DecodingResult, decode, detect_language
from .models.dims import ModelDimensions, dims_for
from .models.whisper import Whisper, build_model
from .serving import TranscriptionService
from .streaming import StreamingService, StreamingTranscriber
from .transcribe import transcribe, transcribe_batched, transcribe_many
from .utils import resolve_device

__all__ = [
    "DecodingOptions", "DecodingResult", "ModelDimensions", "PrefetchedAudio",
    "StreamingService", "StreamingTranscriber", "TranscriptionService", "Whisper",
    "build_model", "decode", "detect_language", "dims_for", "load_audio", "load_audio_pcm16",
    "load_model", "log_mel_spectrogram", "pad_or_trim", "parse_at_label", "prefetch_audio",
    "prefetch_audio_many", "transcribe", "transcribe_batched", "transcribe_many",
]

# the inference entry points as model methods, as the JAX package binds them
Whisper.detect_language = detect_language
Whisper.decode = decode
Whisper.transcribe = transcribe


def load_model(path: str, device="cuda", dtype=torch.bfloat16,
               at_checkpoint: Optional[str] = None, at_low_compute: bool = False) -> Whisper:
    """A model from a local Whisper checkpoint file: {"dims": {...},
    "model_state_dict": {...}} in the reference layout, optionally merged
    with a local TL-TR head file (`at_model.*` or `module.*` keys). Without a
    head the tagging head stays random (with a warning). Nothing is fetched
    over the network."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint file at {path!r}")
    dev = resolve_device(device)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = dict(ckpt["model_state_dict"])
    if at_checkpoint is not None:
        head = torch.load(at_checkpoint, map_location="cpu", weights_only=True)
        for key, value in head.items():
            key = key[len("module."):] if key.startswith("module.") else key
            state[key if key.startswith("at_model.") else "at_model." + key] = value
    model = build_model("", device=dev, dtype=dtype, at_low_compute=at_low_compute,
                        dims=ModelDimensions(**ckpt["dims"]))
    if not any(k.startswith("at_model.") for k in state):
        warnings.warn("checkpoint has no TL-TR head; the tagging head is random",
                      stacklevel=2)
        state.update({f"at_model.{k}": v for k, v in model.at_model.state_dict().items()})
    model.load_state_dict({k: v.to(dtype) for k, v in state.items()})
    return model
