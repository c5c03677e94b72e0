"""Audio frontend: WAV decode, pad/trim, and the public log-mel API.

Only PCM WAV files are decoded (with the standard `wave` module); there is
no ffmpeg dependency. Waveforms may be passed as arrays instead: int16 PCM
or float32 in [-1, 1] at 16 kHz.
"""

import wave
from typing import Union

import numpy as np
import torch

from .ops.mel import (  # noqa: F401  (re-exported constants)
    CHUNK_LENGTH,
    HOP_LENGTH,
    N_FFT,
    N_FRAMES,
    N_MELS,
    N_SAMPLES,
    SAMPLE_RATE,
    log_mel,
    mel_filters,
)

N_SAMPLES_PER_TOKEN = HOP_LENGTH * 2  # the encoder's stem has stride 2
FRAMES_PER_SECOND = SAMPLE_RATE // HOP_LENGTH  # 10 ms per mel frame
TOKENS_PER_SECOND = SAMPLE_RATE // N_SAMPLES_PER_TOKEN  # 20 ms per encoder position


def _resample(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    if orig_sr == target_sr:
        return x
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(orig_sr, target_sr)
    return resample_poly(x, target_sr // g, orig_sr // g).astype(np.float32)


def load_audio(file: str, sr: int = SAMPLE_RATE) -> np.ndarray:
    """Mono float32 waveform at `sr` Hz from a PCM WAV file (8/16/24/32-bit)."""
    if not file.lower().endswith(".wav"):
        raise RuntimeError(f"only PCM WAV files can be decoded, not {file!r}")
    with wave.open(file, "rb") as wf:
        channels, width, rate = wf.getnchannels(), wf.getsampwidth(), wf.getframerate()
        raw = wf.readframes(wf.getnframes())
    if width == 1:
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 2:
        x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 3:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3).astype(np.int32)
        v = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
        x = (np.where(v >= 1 << 23, v - (1 << 24), v)).astype(np.float32) / float(1 << 23)
    elif width == 4:
        x = np.frombuffer(raw, np.int32).astype(np.float32) / float(1 << 31)
    else:
        raise RuntimeError(f"Unsupported WAV sample width: {width}")
    if channels > 1:
        x = x.reshape(-1, channels).mean(axis=1)
    return _resample(x, rate, sr)


def pad_or_trim(array, length: int = N_SAMPLES, *, axis: int = -1):
    """Zero-pad or trim a numpy array or torch tensor to `length` along `axis`."""
    n = array.shape[axis]
    if n > length:
        index = [slice(None)] * array.ndim
        index[axis] = slice(0, length)
        array = array[tuple(index)]
    elif n < length:
        if isinstance(array, torch.Tensor):
            shape = list(array.shape)
            shape[axis] = length - n
            array = torch.cat([array, array.new_zeros(shape)], dim=axis)
        else:
            widths = [(0, 0)] * array.ndim
            widths[axis] = (0, length - n)
            array = np.pad(array, widths)
    return array


def log_mel_spectrogram(audio: Union[str, np.ndarray, torch.Tensor],
                        n_mels: int = N_MELS, padding: int = 0,
                        device: Union[str, torch.device, None] = None) -> torch.Tensor:
    """Log-mel [80, n_frames] of a waveform or WAV file, computed on `device`
    (a tensor's own device when omitted, else the card)."""
    if n_mels != N_MELS:
        raise ValueError(f"Unsupported n_mels: {n_mels}")
    if isinstance(audio, str):
        audio = load_audio(audio)
    if device is None:
        device = audio.device if isinstance(audio, torch.Tensor) else "cuda"
    if not isinstance(audio, torch.Tensor):
        audio = torch.from_numpy(np.ascontiguousarray(np.asarray(audio).reshape(-1)))
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run on the CPU")
    return log_mel(audio.to(device), padding=padding)
