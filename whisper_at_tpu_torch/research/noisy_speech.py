"""Noisy-speech test sets for the noise-robustness experiments.

Counterpart of `whisper_at_tpu/research/noisy_speech.py` (the reference's
noise_robust_asr/asr_experiments/gen_noisy_speech.py:21-65 and
transcribe_whisper.py): each clean utterance is mixed with a noise clip at
a target SNR, power-scaled, the noise looped or truncated to the speech's
length, and written as 16-bit WAV under the reference's file names; every
mixture is then transcribed by the port's sequential `transcribe`. numpy
and the standard `wave` module.
"""

import os
import wave
from typing import Dict, List, Sequence

import numpy as np

from ..audio import load_audio

SNR_LEVELS = [-20, -15, -10, -5, 0, 5, 10, 15, 20]


def add_noise(speech: np.ndarray, noise: np.ndarray, noise_db: float) -> np.ndarray:
    """speech + scale * noise at `noise_db` dB SNR, float32, with
    scale = 10^(-snr/20) sqrt(P_speech) / sqrt(P_noise); the noise is
    looped when shorter than the speech and truncated when longer."""
    power_speech = float((speech**2).mean())
    power_noise = float((noise**2).mean())
    scale = 10 ** (-noise_db / 20) * np.sqrt(power_speech) / np.sqrt(max(power_noise, 1e-10))
    if len(speech) > len(noise):
        noise = np.concatenate([noise] * int(np.ceil(len(speech) / len(noise))))
    noise = noise[: len(speech)]
    return (speech + scale * noise).astype(np.float32)


def write_wav(path: str, audio: np.ndarray, sample_rate: int = 16000):
    """Mono 16-bit PCM WAV of a float waveform in [-1, 1] (x 32767, clipped)."""
    pcm = np.clip(audio * 32767.0, -32768, 32767).astype(np.int16)
    with wave.open(path, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(sample_rate)
        wf.writeframes(pcm.tobytes())


def generate_noisy_set(
    speech_files: List[str],
    noise_files_by_class: Dict[int, List[str]],
    out_dir: str,
    snr_levels: Sequence[int] = tuple(SNR_LEVELS),
    n_utterances: int = 40,
) -> List[str]:
    """The SNR x noise class x utterance grid of mixtures, written as
    '<db>_<class>_<utt>_mix_<noise>.wav' (the names the WER scorer parses).
    Utterance i of a class takes its noise file i modulo the class's count."""
    os.makedirs(out_dir, exist_ok=True)
    speech_files = sorted(speech_files)[:n_utterances]
    written = []
    for db in snr_levels:
        for cla, noise_files in sorted(noise_files_by_class.items()):
            for idx in range(min(n_utterances, len(speech_files))):
                noise_file = noise_files[idx % len(noise_files)]
                mixed = add_noise(load_audio(speech_files[idx]), load_audio(noise_file), db)
                utt = os.path.splitext(os.path.basename(speech_files[idx]))[0]
                noise_name = os.path.splitext(os.path.basename(noise_file))[0]
                tar = os.path.join(out_dir, f"{db}_{cla}_{utt}_mix_{noise_name}.wav")
                write_wav(tar, mixed)
                written.append(tar)
    return written


def transcribe_noisy_set(model, noisy_dir: str, text_dir: str, language: str = "en") -> List[str]:
    """Transcribe every mixture under `noisy_dir` (in sorted order a
    directory) into `text_dir/<name>.txt` with `model.transcribe`, the
    sequential call at its defaults; a transcript that exists is skipped.
    Returns the files written."""
    os.makedirs(text_dir, exist_ok=True)
    outputs = []
    for root, _, files in os.walk(noisy_dir):
        for fname in sorted(files):
            if not fname.endswith((".wav", ".flac")):
                continue
            out_path = os.path.join(text_dir, os.path.splitext(fname)[0] + ".txt")
            if os.path.exists(out_path):
                continue
            result = model.transcribe(os.path.join(root, fname), language=language,
                                      verbose=None)
            with open(out_path, "w") as f:
                f.write(result["text"])
            outputs.append(out_path)
    return outputs
