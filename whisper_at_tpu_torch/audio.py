"""Audio frontend: file decode, pad/trim, prefetch, and the public log-mel
API.

PCM WAV files (`.wav`) are decoded with the standard `wave` module. Any
other file goes through the `ffmpeg` program when it is on PATH, with the
JAX package's command line (mono int16 at 16 kHz; float = int16 / 32768),
and raises RuntimeError naming the missing tool and the file when it is
not: there is no other decoder. Waveforms may be passed as arrays instead:
int16 PCM or float32 in [-1, 1] at 16 kHz, or as a `PrefetchedAudio` whose
copy to the device is already under way (`prefetch_audio`).
"""

import shutil
import subprocess
import wave
from concurrent.futures import ThreadPoolExecutor
from typing import BinaryIO, Union

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
    PrefetchedAudio,
    log_mel,
    log_mel_batched,
    mel_filters,
    prefetch_stft_input,
)
from .utils import exact_div, resolve_device

N_SAMPLES_PER_TOKEN = HOP_LENGTH * 2  # the encoder's stem has stride 2
FRAMES_PER_SECOND = exact_div(SAMPLE_RATE, HOP_LENGTH)  # 10 ms per mel frame
TOKENS_PER_SECOND = exact_div(SAMPLE_RATE, N_SAMPLES_PER_TOKEN)  # 20 ms per encoder position


def _resample(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    if orig_sr == target_sr:
        return x
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(orig_sr, target_sr)
    return resample_poly(x, target_sr // g, orig_sr // g).astype(np.float32)


def _is_wav(file: str) -> bool:
    return file.lower().endswith(".wav")


def _ffmpeg_pcm16(file: str, sr: int) -> np.ndarray:
    """Any container or codec as mono int16 PCM at `sr` Hz, through ffmpeg
    (the JAX package's command line); raises when ffmpeg is not on PATH."""
    if shutil.which("ffmpeg") is None:
        raise RuntimeError(f"ffmpeg is not on PATH, and only PCM WAV files are decoded "
                           f"without it: cannot load {file!r}")
    cmd = ["ffmpeg", "-nostdin", "-threads", "0", "-i", file, "-f", "s16le", "-ac", "1",
           "-acodec", "pcm_s16le", "-ar", str(sr), "-"]
    try:
        out = subprocess.run(cmd, capture_output=True, check=True).stdout
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"Failed to load audio: {e.stderr.decode()}") from e
    return np.frombuffer(out, np.int16).flatten()


def load_audio(file: str, sr: int = SAMPLE_RATE) -> np.ndarray:
    """Mono float32 waveform at `sr` Hz from a PCM WAV file (8/16/24/32-bit),
    or from any other audio file through ffmpeg."""
    if _is_wav(file):
        return decode_wav(file, sr)
    return _ffmpeg_pcm16(file, sr).astype(np.float32) / 32768.0


def decode_wav(file: Union[str, BinaryIO], sr: int = SAMPLE_RATE) -> np.ndarray:
    """Mono float32 waveform at `sr` Hz from PCM WAV (a path or a file object)."""
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


def decode_wav_pcm16(file: Union[str, BinaryIO], sr: int = SAMPLE_RATE) -> np.ndarray:
    """int16 PCM when the WAV is 16-bit mono at `sr` Hz (no conversion at
    all), else `decode_wav`'s float32."""
    with wave.open(file, "rb") as wf:
        if wf.getsampwidth() == 2 and wf.getnchannels() == 1 and wf.getframerate() == sr:
            return np.frombuffer(wf.readframes(wf.getnframes()), np.int16).copy()
    if not isinstance(file, str):
        file.seek(0)
    return decode_wav(file, sr)


def load_audio_pcm16(file: str, sr: int = SAMPLE_RATE) -> np.ndarray:
    """A PCM WAV file as int16 when that loses nothing (16-bit mono at
    `sr`), else as `load_audio`'s float32; any other file as ffmpeg's int16.
    int16 goes to the card at half the bytes and is dequantized there to
    `load_audio`'s values."""
    if _is_wav(file):
        return decode_wav_pcm16(file, sr)
    return _ffmpeg_pcm16(file, sr)


def prefetch_audio(audio: Union[str, np.ndarray], padding: int = N_SAMPLES,
                   device="cuda") -> PrefetchedAudio:
    """Start a waveform's (or WAV file's) copy to `device` now, without
    waiting for it: the host prep (`ops.mel.stft_host_prep`) and, on the
    card, a pinned-host copy on a side stream. `padding` defaults to the
    30 s tail the transcribe paths use (pass 0 to mirror a bare
    `log_mel_spectrogram`). The result is taken wherever a waveform is."""
    dev = resolve_device(device)
    if isinstance(audio, str):
        audio = load_audio_pcm16(audio)
    return prefetch_stft_input(np.asarray(audio), padding, dev)


def prefetch_audio_many(audios, padding: int = N_SAMPLES, workers: int = 8,
                        device="cuda") -> list:
    """`prefetch_audio` over many inputs in a thread pool (the WAV decode
    and the numpy prep release the interpreter lock), in input order."""
    dev = resolve_device(device)
    if not audios:
        return []
    with ThreadPoolExecutor(max_workers=min(workers, len(audios))) as pool:
        return list(pool.map(lambda a: prefetch_audio(a, padding, dev), audios))


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


def log_mel_spectrogram(audio: Union[str, np.ndarray, torch.Tensor, PrefetchedAudio],
                        n_mels: int = N_MELS, padding: int = 0,
                        device: Union[str, torch.device, None] = None) -> torch.Tensor:
    """Log-mel [80, n_frames] of a waveform, WAV file or `PrefetchedAudio`,
    computed on `device` (a tensor's or prefetch's own device when omitted,
    else the card)."""
    if n_mels != N_MELS:
        raise ValueError(f"Unsupported n_mels: {n_mels}")
    if isinstance(audio, PrefetchedAudio):
        if audio.padding != padding:
            raise ValueError(f"PrefetchedAudio was prepared with padding={audio.padding}, "
                             f"but padding={padding} was requested")
        sig = audio.ready().to(device if device is not None else audio.device)
        n = audio.n_frames
        return log_mel_batched(sig[None], torch.tensor([n], device=sig.device), n)[0].t()
    if isinstance(audio, str):
        audio = load_audio(audio)
    if device is None:
        device = audio.device if isinstance(audio, torch.Tensor) else "cuda"
    if not isinstance(audio, torch.Tensor):
        audio = torch.from_numpy(np.ascontiguousarray(np.asarray(audio).reshape(-1)))
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run on the CPU")
    return log_mel(audio.to(device), padding=padding)
