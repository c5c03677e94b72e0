"""Noise-robustness WER experiment on the PyTorch/CUDA port
(`examples/noise_robustness.py` in the port's API).

The reference's analysis (noise_robust_asr/): mix clean speech with
class-labelled noise at a grid of SNRs, transcribe every mixture with the
sequential `transcribe`, score WER per SNR and plot WER against SNR (the
figure is drawn only where matplotlib is installed). Runs offline with
synthetic "speech" (tone bursts) and noise and a random-weight model; swap
in LibriSpeech and ESC-50 paths and a real checkpoint for the paper's
protocol. Runs on the card unless --device cpu.
"""

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import whisper_at_tpu_torch as whisper  # noqa: E402
from whisper_at_tpu_torch.research.noisy_speech import (  # noqa: E402
    generate_noisy_set,
    transcribe_noisy_set,
    write_wav,
)
from whisper_at_tpu_torch.research.plots import plot_wer_vs_snr  # noqa: E402
from whisper_at_tpu_torch.research.wer import eval_noise_wer  # noqa: E402


def make_corpus(root: str, n_utts: int = 3, n_noise_classes: int = 2):
    """n_utts 3 s tone-burst utterances with their truths, and n_utts noise
    clips a class (default_rng(0)), as WAVs under `root`."""
    rng = np.random.default_rng(0)
    speech_dir = os.path.join(root, "speech")
    noise_dir = os.path.join(root, "noise")
    truth_dir = os.path.join(root, "truth")
    for d in (speech_dir, noise_dir, truth_dir):
        os.makedirs(d, exist_ok=True)

    speech_files = []
    for i in range(n_utts):
        t = np.arange(16000 * 3) / 16000.0
        x = 0.4 * np.sin(2 * np.pi * (300 + 50 * i) * t)
        x *= (np.sin(2 * np.pi * 2.0 * t) > 0)  # tone bursts stand in for speech
        path = os.path.join(speech_dir, f"utt{i}.wav")
        write_wav(path, x.astype(np.float32))
        speech_files.append(path)
        with open(os.path.join(truth_dir, f"utt{i}.txt"), "w") as f:
            f.write(f"synthetic utterance {i}")

    noise_by_class = {}
    for cla in range(n_noise_classes):
        files = []
        for j in range(n_utts):
            noise = (0.5 * rng.standard_normal(16000 * 2)).astype(np.float32)
            path = os.path.join(noise_dir, f"n{cla}_{j}.wav")
            write_wav(path, noise)
            files.append(path)
        noise_by_class[cla] = files
    return speech_files, noise_by_class, truth_dir


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=None,
                        help="working directory (default: a new one under the "
                             "temporary directory)")
    parser.add_argument("--model", default="tiny")
    parser.add_argument("--snrs", type=int, nargs="*", default=[-10, 0, 10])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args()
    args.root = args.root or tempfile.mkdtemp(prefix="wat_noise_torch_")

    model = whisper.build_model(args.model, device=args.device)  # random; real use: load_model
    speech, noise_by_class, truth_dir = make_corpus(args.root)

    mixed_dir = os.path.join(args.root, "mixed")
    written = generate_noisy_set(speech, noise_by_class, mixed_dir, snr_levels=args.snrs,
                                 n_utterances=len(speech))
    print(f"mixed {len(written)} noisy clips -> {mixed_dir}")

    text_dir = os.path.join(args.root, "hyp")
    transcribe_noisy_set(model, mixed_dir, text_dir)

    result_csv = os.path.join(args.root, "wer_by_snr.csv")
    wer = eval_noise_wer(text_dir, truth_dir, result_csv, snr_levels=args.snrs)
    print("WER by SNR:", {k: round(v, 3) for k, v in wer.items()})
    plot_wer_vs_snr({args.model: [wer[s] for s in args.snrs]},
                    os.path.join(args.root, "wer_vs_snr.png"), snr_levels=args.snrs)
    print(f"curve -> {os.path.join(args.root, 'wer_vs_snr.png')}")


if __name__ == "__main__":
    main()
