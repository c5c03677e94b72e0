"""The port's TranscriptionService scheduler against a direct transcribe_many.

    python3 tools/profile_service_torch.py [--size large-v1] [--batch 24]
        [--tokens 96] [--iters 2]
    python3 tools/profile_service_torch.py --size tiny --cpu       # smoke

The port of tools/profile_service.py. The service should cost next to
nothing over the packed batch API: the same device work plus a scheduler
thread and futures. Both run over fleets of 3 x --batch files of 8-25 s
(`make_fleet`: chip_smoke.py's `synth_audio` a file, the JAX bench's
serving workload) with the headline options (`HEADLINE_OPTS` at --tokens):

  direct:  prefetch_audio_many(fleet) -> transcribe_many   (one call)
  service: burst-submit the fleet -> wait for every future (scheduler batches)

A warm-up fleet goes first; each path then runs --iters fleets of its own,
the best taken. Last, one service burst under torch.profiler gives the
device's busy time and idle share. --cpu runs fp32 on the CPU (a smoke).
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from profile_torch_headline import device_busy, idle_line, sync, tool_model  # noqa: E402

from chip_smoke import HEADLINE_OPTS, card_line, synth_audio  # noqa: E402

FLEET_SECONDS = (8, 26)  # a file's length in seconds, drawn from [8, 26)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", default="large-v1")
    ap.add_argument("--batch", type=int, default=24)
    ap.add_argument("--tokens", type=int, default=96)
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--cpu", action="store_true", help="fp32 on the CPU (a smoke)")
    return ap.parse_args(argv)


def make_fleet(rng, n_files: int, seed_base: int) -> list:
    """n_files int16 recordings of 8-25 s, file i from seed seed_base + i."""
    return [synth_audio(int(d), seed_base + i)
            for i, d in enumerate(rng.integers(*FLEET_SECONDS, size=n_files))]


def serving_options(tokens: int, fp16: bool) -> dict:
    """The headline's decode options at `tokens` a window, without max_batch."""
    return {**{k: v for k, v in HEADLINE_OPTS.items() if k != "max_batch"},
            "sample_len": tokens, "fp16": fp16}


def run(model, fp16: bool, args) -> dict:
    import whisper_at_tpu_torch as wat

    opts = serving_options(args.tokens, fp16)
    dev = model.device
    rng = np.random.default_rng(0)
    n_files = 3 * args.batch
    fleets = [make_fleet(rng, n_files, 1000 * it) for it in range(2 * args.iters + 2)]
    audio_s = [sum(len(f) for f in fl) / 16000.0 for fl in fleets]

    def direct(fleet):
        return wat.transcribe_many(model, wat.prefetch_audio_many(fleet, device=dev),
                                   max_batch=args.batch, **opts)

    def served(svc, fleet):
        for f in [svc.submit(a) for a in fleet]:
            f.result(timeout=1800)

    direct(fleets[0])  # warm-up: what both paths share
    times = {"direct": [], "service": []}
    for it in range(args.iters):
        sync()
        t0 = time.perf_counter()
        direct(fleets[1 + it])
        sync()
        times["direct"].append(time.perf_counter() - t0)
    with wat.TranscriptionService(model, max_batch=args.batch, max_wait_s=0.05, **opts) as svc:
        for it in range(args.iters):
            t0 = time.perf_counter()
            served(svc, fleets[1 + args.iters + it])
            times["service"].append(time.perf_counter() - t0)
        stats = svc.stats()
        busy = device_busy(lambda: served(svc, fleets[-1]))
    rates = {}
    for path, offset in (("direct", 1), ("service", 1 + args.iters)):
        best = min(range(args.iters), key=lambda i: times[path][i])
        rates[path] = audio_s[offset + best] / times[path][best]
    print(f"direct:  times {[f'{t:.2f}' for t in times['direct']]} -> {rates['direct']:.1f} "
          f"audio-s/s", flush=True)
    print(f"service: times {[f'{t:.2f}' for t in times['service']]} -> {rates['service']:.1f} "
          f"audio-s/s ({stats['batches']} batches over {args.iters} fleets)", flush=True)
    print(f"service/direct: {rates['service'] / rates['direct']:.3f}", flush=True)
    print(f"service, one profiled burst of {n_files} files: {idle_line(busy)}", flush=True)
    return dict(times=times, rates=rates, stats=stats, busy_s=busy["busy_s"],
                idle_share=busy["idle_share"])


def main(argv=None) -> int:
    args = parse_args(argv)
    print("card: none (CPU run)" if args.cpu else card_line(), flush=True)
    model, fp16 = tool_model(args.size, args.cpu)
    print(f"{args.size}: fleets of {3 * args.batch} files of 8-25 s, max_batch {args.batch}, "
          f"{args.tokens} tokens a window, best of {args.iters}", flush=True)
    run(model, fp16, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
