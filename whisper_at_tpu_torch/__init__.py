"""whisper_at_tpu_torch: Whisper-AT (speech recognition + AudioSet tagging)
in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

The port of `whisper_at_tpu` (JAX). Entry points run on the card
(`device="cuda"`) unless the caller passes `device="cpu"`, and raise when
no card is present. Importing the package loads no JAX and builds nothing.
"""

import hashlib
import io
import os
import warnings
from typing import List, Optional

import torch

from .at_post_processing import parse_at_label, print_label_name, print_support_language
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
from .checkpoint import load_params
from .convert import from_jax_params
from .models.whisper import Whisper, build_model
from .registry import _ALIGNMENT_HEADS, _MODELS, _MODELS_AT, file_name, sha256_of
from .serving import TranscriptionService
from .streaming import StreamingService, StreamingTranscriber
from .transcribe import transcribe, transcribe_batched, transcribe_many
from .utils import resolve_device
from .version import __version__

__all__ = [
    "__version__", "available_models", "print_label_name", "print_support_language",
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


def available_models() -> List[str]:
    """Names of the official models."""
    return list(_MODELS)


def _default_root() -> str:
    cache = os.getenv("XDG_CACHE_HOME", os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(cache, "whisper")


def _official_file(url: str, root: str) -> str:
    """The local file of an official checkpoint, checked against the sha256
    its address carries. Nothing is fetched, deleted or overwritten."""
    path = os.path.join(root, file_name(url))
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"no checkpoint file at {path!r}: this package does not download; put the "
            f"file {file_name(url)!r} there or pass download_root (--model_dir)")
    expected = sha256_of(url)
    if expected is not None:
        digest = hashlib.sha256()
        with open(path, "rb") as f:
            for block in iter(lambda: f.read(1 << 24), b""):
                digest.update(block)
        if digest.hexdigest() != expected:
            raise RuntimeError(f"{path} has sha256 {digest.hexdigest()}, not the released "
                               f"file's {expected}; the file is left as it is")
    return path


def _torch_load(path: str, in_memory: bool):
    if in_memory:
        with open(path, "rb") as f:
            path = io.BytesIO(f.read())
    return torch.load(path, map_location="cpu", weights_only=True)


def load_model(name: str, device="cuda", download_root: Optional[str] = None,
               in_memory: bool = False, at_low_compute: bool = False, dtype=None,
               at_checkpoint: Optional[str] = None) -> Whisper:
    """A Whisper-AT model on `device` (the card unless asked otherwise), in
    `dtype` (bfloat16 by default), from

    * an official name (`available_models()`): the reference's Whisper
      checkpoint and the matching TL-TR head (`_low` with at_low_compute)
      under their released file names in `download_root` (default
      `$XDG_CACHE_HOME/whisper` or `~/.cache/whisper`), each checked against
      the sha256 its address carries where it carries one; the registry's
      alignment heads are set;
    * a `.npz` file of the JAX package's parameter tree with its dims
      (`checkpoint.save_params`);
    * a local Whisper checkpoint file, {"dims": {...}, "model_state_dict":
      {...}} in the reference layout, optionally merged with a local TL-TR
      head file `at_checkpoint` (`at_model.*` or `module.*` keys). Without a
      head the tagging head stays random (with a warning).

    Nothing is fetched over the network: a missing file raises
    FileNotFoundError, and a file whose checksum differs raises and stays."""
    dev = resolve_device(device)
    dtype = torch.bfloat16 if dtype is None else dtype
    heads = None
    if name in _MODELS:
        root = download_root or _default_root()
        at_name = name + "_low" if at_low_compute else name
        ckpt = _torch_load(_official_file(_MODELS[name], root), in_memory)
        at_checkpoint = _official_file(_MODELS_AT[at_name], root)
        heads = _ALIGNMENT_HEADS[name]
    elif not os.path.isfile(name):
        raise FileNotFoundError(f"no checkpoint file at {name!r}, and it is not an official "
                                f"name {available_models()}")
    elif name.endswith(".npz"):
        dims, tree = load_params(name)
        if dims is None:
            raise RuntimeError(f"{name} does not embed model dimensions")
        low = at_low_compute or "down" in tree["at_model"]
        model = build_model("", device=dev, dtype=dtype, at_low_compute=low, dims=dims)
        model.load_state_dict({k: v.to(dtype) for k, v in from_jax_params(tree).items()})
        return model
    else:
        ckpt = _torch_load(name, in_memory)
    state = dict(ckpt["model_state_dict"])
    if at_checkpoint is not None:
        for key, value in _torch_load(at_checkpoint, in_memory).items():
            key = key[len("module."):] if key.startswith("module.") else key
            state[key if key.startswith("at_model.") else "at_model." + key] = value
    model = build_model("", device=dev, dtype=dtype, at_low_compute=at_low_compute,
                        dims=ModelDimensions(**ckpt["dims"]))
    if not any(k.startswith("at_model.") for k in state):
        warnings.warn("checkpoint has no TL-TR head; the tagging head is random",
                      stacklevel=2)
        state.update({f"at_model.{k}": v for k, v in model.at_model.state_dict().items()})
    model.load_state_dict({k: v.to(dtype) for k, v in state.items()})
    if heads is not None:
        try:
            model.set_alignment_heads(heads)
        except ValueError:
            # a local file under an official name whose dims differ from the
            # release keeps the default heads, as in the JAX package
            warnings.warn(f"registry alignment heads for {name!r} do not match the "
                          "checkpoint's dims; using the default (last half of decoder "
                          "layers)", stacklevel=2)
    return model
