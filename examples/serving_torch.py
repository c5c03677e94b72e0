"""Serving patterns on the PyTorch/CUDA port (`examples/serving.py` in the
port's API): audio copies started ahead of the compute, and windows of
many files packed into shared batches.

  - `whisper_at_tpu_torch.audio.prefetch_audio` starts a request's copy to
    the device without blocking, so a serving loop copies request i+1 while
    request i computes.
  - `transcribe_many` packs every file's 30 s windows into shared batches,
    so a pile of short clips fills the batch the way one long file does.
  - `--service` sends the same requests through the always-on
    `TranscriptionService` (continuous batching) instead.

Runs offline with --random (gibberish text, the real pipeline). Runs on the
card unless --device cpu.

Usage:
    python examples/serving_torch.py file1.wav file2.wav ... [--random]
    python examples/serving_torch.py --synthetic 6 --random   # 6 generated clips
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import whisper_at_tpu_torch as whisper  # noqa: E402
from whisper_at_tpu_torch.audio import prefetch_audio  # noqa: E402


def synthetic_clip(seconds: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000.0
    x = 0.3 * np.sin(2 * np.pi * (200 + 30 * seed) * t)
    x += 0.05 * rng.standard_normal(len(t))
    return (np.clip(x, -1, 1) * 32767).astype(np.int16)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("audio", nargs="*", help="audio files")
    parser.add_argument("--model", default="tiny")
    parser.add_argument("--random", action="store_true",
                        help="random weights (offline smoke run)")
    parser.add_argument("--synthetic", type=int, default=0,
                        help="generate N synthetic clips instead of files")
    parser.add_argument("--batches", type=int, default=2,
                        help="number of request batches to simulate")
    parser.add_argument("--service", action="store_true",
                        help="drive the same requests through the always-on "
                             "TranscriptionService (continuous batching) "
                             "instead of manual batch loops")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args()

    if args.random:
        model = whisper.build_model(args.model, device=args.device, seed=0)
    else:
        model = whisper.load_model(args.model, device=args.device)

    if args.synthetic:
        requests = [[synthetic_clip(8 + 3 * i, seed=100 * b + i) for i in range(args.synthetic)]
                    for b in range(args.batches)]
    else:
        if not args.audio:
            parser.error("pass audio files or --synthetic N")
        requests = [args.audio] * args.batches

    opts = dict(language="en", temperature=0.0, logprob_threshold=None,
                compression_ratio_threshold=None, no_speech_threshold=None)

    if args.service:
        # the always-on pattern: every request is submitted as it arrives;
        # the service's scheduler coalesces them into shared batches and
        # each caller waits only on its own Future
        with whisper.TranscriptionService(model, max_wait_s=0.2, **opts) as svc:
            t0 = time.perf_counter()
            futures = [svc.submit(a) for batch in requests for a in batch]
            for i, f in enumerate(futures):
                r = f.result()
                text = r["text"][:60].strip() or "<no speech>"
                print(f"  request {i}: lang={r['language']} "
                      f"tags={np.asarray(r['audio_tag']).shape} text={text!r}")
            dt = time.perf_counter() - t0
            stats = svc.stats()
        print(f"service: {stats['completed']} requests in {dt:.2f}s, "
              f"{stats['batches']} device batches, {stats['audio_seconds']:.0f} audio-s "
              f"({stats['audio_seconds'] / dt:.1f} audio-s/s)")
        return

    # prefetch the next request batch's audio before processing the
    # current one: the copies run while the device decodes
    pre = [prefetch_audio(a, device=model.device) for a in requests[0]]
    for b in range(len(requests)):
        nxt = ([prefetch_audio(a, device=model.device) for a in requests[b + 1]]
               if b + 1 < len(requests) else None)
        t0 = time.perf_counter()
        results = whisper.transcribe_many(model, pre, **opts)
        dt = time.perf_counter() - t0
        total_s = sum(len(r["segments"]) for r in results)
        print(f"batch {b}: {len(results)} files, {total_s} segments, {dt:.2f}s")
        for i, r in enumerate(results):
            text = r["text"][:60].strip() or "<no speech>"
            print(f"  file {i}: lang={r['language']} "
                  f"tags={np.asarray(r['audio_tag']).shape} text={text!r}")
        pre = nxt


if __name__ == "__main__":
    main()
