"""Log-mel spectrogram as a windowed real DFT in two matrix products.

Counterpart of `whisper_at_tpu/ops/mel.py`: the same Hann-windowed DFT
matrices (N_FFT = 400 is not a power of two), the same framing as
torch.stft(center=True, pad_mode="reflect") with the last frame dropped,
and the same log10 / clamp / 8-dB floor / (x + 4) / 4 chain, computed in
fp32 on the tensor's device.
"""

import functools
import os

import numpy as np
import torch

SAMPLE_RATE = 16000
N_FFT = 400
N_MELS = 80
HOP_LENGTH = 160
CHUNK_LENGTH = 30
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE  # 480000 samples in a 30 s window
N_FRAMES = N_SAMPLES // HOP_LENGTH      # 3000 frames in a 30 s window

_ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "whisper_at_tpu", "assets")


@functools.lru_cache(maxsize=None)
def mel_filters(n_mels: int = N_MELS) -> np.ndarray:
    """The 80-bin mel filterbank shipped as a data asset, [80, 201] fp32."""
    if n_mels != N_MELS:
        raise ValueError(f"Unsupported n_mels: {n_mels}")
    with np.load(os.path.join(_ASSETS, "mel_filters.npz")) as f:
        return f[f"mel_{n_mels}"].astype(np.float32)


@functools.lru_cache(maxsize=None)
def _dft_matrices() -> tuple:
    """Hann-windowed cos and sin analysis matrices, each [400, 201] fp32."""
    n = np.arange(N_FFT)[:, None]
    k = np.arange(N_FFT // 2 + 1)[None, :]
    angle = 2.0 * np.pi * n * k / N_FFT
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(N_FFT) / N_FFT))
    return ((window[:, None] * np.cos(angle)).astype(np.float32),
            (window[:, None] * np.sin(angle)).astype(np.float32))


def log_mel(audio: torch.Tensor, padding: int = 0) -> torch.Tensor:
    """Log-mel [80, n_frames] of a 1-D 16 kHz waveform tensor (int16 PCM or
    float), n_frames = (len(audio) + padding) // 160, on audio's device."""
    dev = audio.device
    if audio.dtype == torch.int16:
        x = audio.float() * (1.0 / 32768.0)
    else:
        x = audio.float()
    if padding > 0:
        x = torch.cat([x, x.new_zeros(padding)])
    n_frames = x.shape[0] // HOP_LENGTH
    if x.shape[0] > 200:
        left, right = x[1:201].flip(0), x[-201:-1].flip(0)
    else:
        left = right = x.new_zeros(200)
    sig = torch.cat([left, x, right])
    frames = sig.unfold(0, N_FFT, HOP_LENGTH)[:n_frames]  # [n_frames, 400]
    cos_m, sin_m = (torch.from_numpy(m).to(dev) for m in _dft_matrices())
    re = frames @ cos_m
    im = frames @ sin_m
    mel = (re * re + im * im) @ torch.from_numpy(mel_filters()).to(dev).t()
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    if n_frames > 0:
        log_spec = torch.maximum(log_spec, log_spec.max() - 8.0)
    return ((log_spec + 4.0) / 4.0).t()
