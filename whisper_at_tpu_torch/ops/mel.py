"""Log-mel spectrogram as a windowed real DFT in two matrix products.

Counterpart of `whisper_at_tpu/ops/mel.py`: the same Hann-windowed DFT
matrices (N_FFT = 400 is not a power of two), the same framing as
torch.stft(center=True, pad_mode="reflect") with the last frame dropped,
and the same log10 / clamp / 8-dB floor / (x + 4) / 4 chain, computed in
fp32 on the tensor's device.

The serving path prepares waveforms on the host (`stft_host_prep`: the
int16-grid check, the zero tail, the reflect padding) and copies them to
the card ahead of use (`PrefetchedAudio`); `log_mel_batched` then computes
the mel of many same-length prepared signals at once, each row's 8-dB floor
taken over its own valid frames. Only the frames a caller reads are
computed: nothing is padded to a 30 s multiple.
"""

import functools
import os
from typing import Tuple

import numpy as np
import torch

SAMPLE_RATE = 16000
N_FFT = 400
N_MELS = 80
HOP_LENGTH = 160
CHUNK_LENGTH = 30
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE  # 480000 samples in a 30 s window
N_FRAMES = N_SAMPLES // HOP_LENGTH      # 3000 frames in a 30 s window

# frames past the last content frame (len // 160) that can still read a
# sample of content: frame t reads samples [160 t - 200, 160 t + 200)
WINDOW_SLACK = 3

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


def _dequantize(x: torch.Tensor) -> torch.Tensor:
    """fp32 samples of int16 PCM (x / 32768) or of a float waveform."""
    if x.dtype == torch.int16:
        return x.float() * (1.0 / 32768.0)
    return x.float()


def _log_power_mel(sig: torch.Tensor, n_frames: int) -> torch.Tensor:
    """log10 of the mel energies [..., n_frames, 80] of reflect-padded fp32
    signals [..., L]: frame t reads sig[160 t : 160 t + 400]."""
    dev = sig.device
    frames = sig.unfold(-1, N_FFT, HOP_LENGTH)[..., :n_frames, :]  # [..., F, 400]
    cos_m, sin_m = (torch.from_numpy(m).to(dev) for m in _dft_matrices())
    re = frames @ cos_m
    im = frames @ sin_m
    mel = (re * re + im * im) @ torch.from_numpy(mel_filters()).to(dev).t()
    return torch.log10(torch.clamp(mel, min=1e-10))


def log_mel(audio: torch.Tensor, padding: int = 0) -> torch.Tensor:
    """Log-mel [80, n_frames] of a 1-D 16 kHz waveform tensor (int16 PCM or
    float), n_frames = (len(audio) + padding) // 160, on audio's device."""
    x = _dequantize(audio)
    if padding > 0:
        x = torch.cat([x, x.new_zeros(padding)])
    n_frames = x.shape[0] // HOP_LENGTH
    if x.shape[0] > 200:
        left, right = x[1:201].flip(0), x[-201:-1].flip(0)
    else:
        left = right = x.new_zeros(200)
    log_spec = _log_power_mel(torch.cat([left, x, right]), n_frames)
    if n_frames > 0:
        log_spec = torch.maximum(log_spec, log_spec.max() - 8.0)
    return ((log_spec + 4.0) / 4.0).t()


def log_mel_batched(sigs: torch.Tensor, n_valid: torch.Tensor, n_frames: int) -> torch.Tensor:
    """Normalized log-mel [N, n_frames, 80] of N prepared signals [N, L]
    (`stft_host_prep` rows, int16 or float, L >= (n_frames + 2) * 160).
    Row i's 8-dB floor is taken over its first n_valid[i] frames only, as
    the JAX package's `_log_normalize` does; the caller makes sure that
    the frames it does not compute below n_valid[i] are silent."""
    log_spec = _log_power_mel(_dequantize(sigs), n_frames)
    if n_frames == 0:
        return log_spec
    valid = torch.arange(n_frames, device=sigs.device)[None, :] < n_valid[:, None]
    vmax = torch.where(valid[..., None], log_spec, float("-inf")).amax(dim=(1, 2))
    log_spec = torch.maximum(log_spec, (vmax - 8.0)[:, None, None])
    return (log_spec + 4.0) / 4.0


def mel_windows_many(sigs: torch.Tensor, n_valid: torch.Tensor, n_windows: int
                     ) -> torch.Tensor:
    """The 30 s decode windows [N, W, 80, 3000] of N prepared signals with
    the 30 s tail (`padding=N_SAMPLES`) that give W windows each: rows hold
    at least (W * 3000 + WINDOW_SLACK + 2) * 160 samples. Frames past
    W * 3000 + WINDOW_SLACK start past the last sample of content, so they
    are silent and the floor over the computed frames is the floor over
    all n_valid frames (`transcribe_batched` run file by file)."""
    n = sigs.shape[0]
    logs = log_mel_batched(sigs, n_valid, n_windows * N_FRAMES + WINDOW_SLACK)
    wins = logs[:, :n_windows * N_FRAMES].reshape(n, n_windows, N_FRAMES, N_MELS)
    return wins.transpose(2, 3)


def mel_stream_pieces(sigs: torch.Tensor, n_valid: torch.Tensor, lead: int) -> torch.Tensor:
    """The [N, 80, 3000] decode windows of N same-length streaming pieces
    (`stft_host_prep(piece, 0)` rows): every frame of a piece is computed
    and floored over its n_valid frames, then the `lead` margin frames are
    dropped, as the session's own `log_mel` of the piece does."""
    logs = log_mel_batched(sigs, n_valid, sigs.shape[1] // HOP_LENGTH - 2)
    return logs[:, lead:lead + N_FRAMES].transpose(1, 2)


def stft_host_prep(audio, padding: int = 0) -> Tuple[np.ndarray, int]:
    """Host prep of a waveform for the card: (sig [(n_frames + 2) * 160],
    n_frames), n_frames = (len + padding) // 160.

    A float waveform whose samples all lie on the int16 grid (k / 32768) is
    shipped as int16, half the bytes, and dequantized on the card to the
    same fp32 values; then the zero tail of `padding` samples and the
    torch.stft(center=True) reflect padding. The JAX package's
    `_stft_host_prep` with exact=True, bit for bit."""
    audio = np.asarray(audio).reshape(-1)
    if audio.dtype == np.int16:
        host_dtype = np.int16
    else:
        audio = audio.astype(np.float32)
        host_dtype = np.float32
        # a prefix probe rejects most float audio before the full check
        probe = audio[:4096] * 32768.0
        if (probe >= -32768.0).all() and (probe <= 32767.0).all() \
                and (probe == np.rint(probe)).all():
            scaled = audio * 32768.0
            if (scaled >= -32768.0).all() and (scaled <= 32767.0).all() \
                    and (scaled == np.rint(scaled)).all():
                audio = scaled.astype(np.int16)
                host_dtype = np.int16
    if padding > 0:
        audio = np.concatenate([audio, np.zeros(padding, host_dtype)])
    total = audio.shape[0]
    n_frames = total // HOP_LENGTH
    left = audio[1:201][::-1] if total > 200 else np.zeros(200, host_dtype)
    right = audio[-2:-202:-1] if total > 200 else np.zeros(200, host_dtype)
    sig = np.concatenate([left, audio, right])
    pad_to = (max(1, n_frames) + 2) * HOP_LENGTH
    if sig.shape[0] < pad_to:
        sig = np.concatenate([sig, np.zeros(pad_to - sig.shape[0], host_dtype)])
    return sig[:pad_to], n_frames


class PrefetchedAudio:
    """A prepared waveform (`stft_host_prep`) whose copy to the device was
    started without waiting for it.

    On the card the copy runs from a pinned host buffer on a side stream;
    `ready()` makes the caller's current stream wait for it before the
    signal is read. Pass it wherever a waveform is taken
    (`log_mel_spectrogram`, `transcribe`, `transcribe_batched`,
    `transcribe_many`, `TranscriptionService.submit`). `padding` is fixed
    when it is made and must match the consumer's."""

    __slots__ = ("sig", "n_frames", "padding", "host", "event")

    def __init__(self, sig: torch.Tensor, n_frames: int, padding: int, host=None, event=None):
        self.sig = sig            # [(n_frames + 2) * 160] int16 or fp32, on the device
        self.n_frames = n_frames
        self.padding = padding
        self.host = host          # the pinned source of the copy, kept until it is read
        self.event = event        # recorded on the side stream after the copy

    @property
    def device(self) -> torch.device:
        return self.sig.device

    def ready(self) -> torch.Tensor:
        """The signal, once the current stream has been made to wait for
        its copy (and the allocator told that stream reads it)."""
        if self.event is not None:
            stream = torch.cuda.current_stream(self.sig.device)
            stream.wait_event(self.event)
            self.sig.record_stream(stream)
        return self.sig


def prefetch_stft_input(audio, padding: int, device: torch.device) -> PrefetchedAudio:
    """`stft_host_prep` and the start of the copy to `device`."""
    sig, n_frames = stft_host_prep(audio, padding)
    host = torch.from_numpy(sig)
    if device.type != "cuda":
        return PrefetchedAudio(host.to(device), n_frames, padding)
    host = host.pin_memory()
    side = torch.cuda.Stream(device)  # from PyTorch's pool of side streams
    with torch.cuda.stream(side):
        # allocated on the side stream, so the copy waits for no other work;
        # `ready()` tells the allocator which stream reads it next
        out = torch.empty(host.shape, dtype=host.dtype, device=device)
        out.copy_(host, non_blocking=True)
        event = torch.cuda.Event()
        event.record(side)
    return PrefetchedAudio(out, n_frames, padding, host=host, event=event)
