"""Live streaming transcription on the PyTorch/CUDA port
(`examples/streaming_demo.py` in the port's API).

Simulates a microphone delivering 4 s blocks and prints segments the moment
the engine finalizes them, then the final transcribe()-shaped result. Runs
offline with --random (random weights: gibberish text, but the whole
streaming path runs). Runs on the card unless --device cpu.

    python examples/streaming_demo_torch.py [audio.wav] [--model tiny] [--random]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import whisper_at_tpu_torch as whisper  # noqa: E402


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("audio", nargs="?", default=None)
    parser.add_argument("--model", default="tiny")
    parser.add_argument("--random", action="store_true",
                        help="random weights (offline smoke run)")
    parser.add_argument("--block-seconds", type=float, default=4.0)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args()

    model = (whisper.build_model(args.model, device=args.device) if args.random
             else whisper.load_model(args.model, device=args.device))

    if args.audio is None:
        rng = np.random.default_rng(0)
        t = np.arange(16000 * 40) / 16000.0
        audio = (0.3 * np.sin(2 * np.pi * 440 * t)
                 + 0.02 * rng.standard_normal(len(t))).astype(np.float32)
    else:
        audio = whisper.load_audio(args.audio)

    sess = whisper.StreamingTranscriber(
        model, language="en" if args.random else None,
        **(dict(fp16=False, logprob_threshold=None, compression_ratio_threshold=None,
                no_speech_threshold=None) if args.random else {}))
    block = int(args.block_seconds * 16000)
    for i in range(0, len(audio), block):
        for seg in sess.feed(audio[i:i + block]):
            print(f"live [{seg['start']:7.2f} -> {seg['end']:7.2f}] {seg['text']}")
    result = sess.finish()
    print(f"\nfinal: {len(result['segments'])} segments, "
          f"tags {np.asarray(result['audio_tag']).shape}")
    for cell in whisper.parse_at_label(result, top_k=3)[:2]:
        print(cell["time"], [name for name, _ in cell["audio tags"]])


if __name__ == "__main__":
    main()
