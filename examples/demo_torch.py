"""Walkthrough of the whisper_at_tpu_torch API, the PyTorch/CUDA port
(`examples/demo.py` in the port's API).

Runs offline: with --random it builds a random-weight model, so the output
is gibberish but every API is exercised end to end. Without it, `--model`
is an official name read from the local checkpoint cache (nothing is
downloaded) or a checkpoint file. Runs on the card unless --device cpu.

    python examples/demo_torch.py [audio.wav] --random --model tiny [--device cpu]
"""

import argparse
import contextlib
import io
import os
import sys

import numpy as np

# allow running straight from a source checkout: python examples/demo_torch.py
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import whisper_at_tpu_torch as whisper  # noqa: E402


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("audio", nargs="?", default=None, help="audio file (wav)")
    parser.add_argument("--model", default="tiny")
    parser.add_argument("--random", action="store_true",
                        help="random weights (offline smoke run)")
    parser.add_argument("--at_time_res", type=float, default=10)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args()

    if args.random:
        model = whisper.build_model(args.model, device=args.device)
    else:
        model = whisper.load_model(args.model, device=args.device)

    if args.audio is None:
        rng = np.random.default_rng(0)
        t = np.arange(16000 * 20) / 16000.0
        audio = (0.3 * np.sin(2 * np.pi * 440 * t)
                 + 0.02 * rng.standard_normal(len(t))).astype(np.float32)
    else:
        audio = args.audio

    # speech recognition and audio tagging in one pass
    result = whisper.transcribe(
        model, audio, at_time_res=args.at_time_res, language="en", verbose=None,
        logprob_threshold=None, compression_ratio_threshold=None, no_speech_threshold=None)
    print("=== transcript ===")
    print(result["text"] or "(empty)")
    print("\n=== segments ===")
    for seg in result["segments"][:5]:
        print(f"[{seg['start']:6.2f} -> {seg['end']:6.2f}] {seg['text']}")

    print("\n=== audio tags (top 3 per segment) ===")
    tags = whisper.parse_at_label(result, language="en", top_k=3, p_threshold=-np.inf)
    for seg in tags:
        names = ", ".join(f"{name} ({logit:.2f})" for name, logit in seg["audio tags"])
        print(f"{seg['time']['start']:4d}-{seg['time']['end']:4d}s: {names}")

    # supported label languages and the class list
    print("\n=== first 5 label names (en) ===")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        whisper.print_label_name("en")
    print("\n".join(buf.getvalue().splitlines()[:5]))


if __name__ == "__main__":
    main()
