"""Per-stage split of the port's serving path against the offline headline.

    python3 tools/profile_serving_torch.py [--size large-v1] [--batch 24]
        [--tokens 96] [--iters 3]
    python3 tools/profile_serving_torch.py --size tiny --cpu --iters 1   # smoke

The port of tools/profile_serving.py. It runs the serving workload (3 x
--batch files of 8-25 s through one TranscriptionService, every file one 30 s
window; chip_smoke.py's audio and headline options) with the
WHISPER_AT_TPU_SERVE_PROF stage profile on, and prints:

  1. the window throughput of the offline packed path (transcribe_batched
     over --batch windows of 30 s) and of serving in the same process:
     windows/s is the device-work unit, since every window costs one decode
     whatever the audio it carries;
  2. the padding multiplier: the real audio a window carries over 30 s,
     which audio-s/s applies on top of windows/s;
  3. the wall and CPU time of every stage of each transcribe_many call
     (frontend-mel, detect, decode, tag-dispatch, assembly, tag-commit,
     emit) and of the scheduler (sched-fill, sched-settle, sched-gap);
  4. one profiled serving burst: the device's busy time and idle share.

--cpu runs fp32 on the CPU (a smoke).
"""

import argparse
import contextlib
import os
import sys
import time

import numpy as np

os.environ.setdefault("WHISPER_AT_TPU_SERVE_PROF", "1")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from profile_service_torch import make_fleet, serving_options  # noqa: E402
from profile_torch_headline import device_busy, idle_line, sync, tool_model  # noqa: E402

from chip_smoke import card_line, synth_audio  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", default="large-v1")
    ap.add_argument("--batch", type=int, default=24)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--tokens", type=int, default=96)
    ap.add_argument("--cpu", action="store_true", help="fp32 on the CPU (a smoke)")
    return ap.parse_args(argv)


@contextlib.contextmanager
def profiling(prof):
    """`prof` (a StageProf, on when its variable was "1" at import) on in the block."""
    was = prof.enabled
    prof.enabled = True
    try:
        yield prof
    finally:
        prof.enabled = was


def stage_table(stages: dict, drive_s: float) -> list:
    """The stage profile's lines, the longest first."""
    return [f"  {k:14s} wall {v['wall_ms']:9.1f} ms  cpu {v['cpu_ms']:9.1f} ms  x{v['count']:<4d} "
            f"({v['wall_ms'] / 10 / max(drive_s, 1e-9):5.1f}% of drive)"
            for k, v in sorted(stages.items(), key=lambda kv: -kv[1]["wall_ms"])]


def run(model, fp16: bool, args) -> dict:
    import whisper_at_tpu_torch as wat
    from whisper_at_tpu_torch.transcribe import _serve_prof

    opts = serving_options(args.tokens, fp16)
    dev = model.device
    with profiling(_serve_prof):
        # ---- the offline packed path: windows/s of the headline's call ---- #
        long_audio = synth_audio(args.batch * 30, 9999)
        t0 = time.perf_counter()
        wat.transcribe_batched(model, wat.prefetch_audio(long_audio, device=dev),
                               max_batch=args.batch, **opts)
        sync()
        print(f"offline warmup {time.perf_counter() - t0:.1f}s", flush=True)
        offline_times = []
        for it in range(args.iters):
            pre = wat.prefetch_audio(synth_audio(args.batch * 30, it), device=dev)
            sync()
            t0 = time.perf_counter()
            wat.transcribe_batched(model, pre, max_batch=args.batch, **opts)
            sync()
            offline_times.append(time.perf_counter() - t0)
        _serve_prof.snapshot()  # transcribe_batched records none of the serving stages
        offline_best = min(offline_times)
        offline_wps = args.batch / offline_best
        print(f"\noffline packed: {args.batch} windows in {offline_best:.2f}s = "
              f"{offline_wps:.2f} windows/s ({args.batch * 30 / offline_best:.1f} audio-s/s)",
              flush=True)

        # ---- the serving workload ------------------------------------------ #
        rng = np.random.default_rng(0)
        fleets = [make_fleet(rng, 3 * args.batch, 1000 * it) for it in range(args.iters + 2)]
        n_files = len(fleets[0])
        with wat.TranscriptionService(model, max_batch=args.batch, max_wait_s=0.05,
                                      **opts) as service:
            def serve(fleet):
                for f in [service.submit(a) for a in wat.prefetch_audio_many(fleet,
                                                                             device=dev)]:
                    f.result(timeout=1800)

            serve(fleets[0])  # warm-up
            _serve_prof.snapshot()
            serve_times, audio_s = [], []
            for it in range(args.iters):
                t0 = time.perf_counter()
                serve(fleets[1 + it])
                serve_times.append(time.perf_counter() - t0)
                audio_s.append(sum(len(a) for a in fleets[1 + it]) / 16000)
            stages = _serve_prof.snapshot()
            busy = device_busy(lambda: serve(fleets[-1]))
            _serve_prof.snapshot()

    best = min(range(args.iters), key=lambda i: serve_times[i])
    serve_best, seconds = serve_times[best], audio_s[best]
    serve_wps = n_files / serve_best  # every file of 8-25 s is one 30 s window
    per_window = seconds / n_files
    print(f"\nserving: {n_files} files ({seconds:.0f} audio-s, {n_files} windows) best "
          f"{serve_best:.2f}s")
    print(f"  window throughput : {serve_wps:6.2f} windows/s (offline {offline_wps:6.2f}) -> "
          f"{100 * serve_wps / offline_wps:.1f}% of offline")
    print(f"  audio-s/s         : {seconds / serve_best:6.1f} (offline "
          f"{args.batch * 30 / offline_best:6.1f})")
    print(f"  padding multiplier: {per_window:.1f}s real audio per 30s window = "
          f"{per_window / 30:.3f} (decode sees the full 30 s context)")
    print(f"  predicted serving audio-s/s from padding alone: {offline_wps * per_window:.1f}")
    drive_s = sum(serve_times)
    print(f"\nper-stage totals over {args.iters} iterations ({drive_s:.2f}s wall):")
    print("\n".join(stage_table(stages, drive_s)))
    decode_ms = stages.get("decode", {}).get("wall_ms", 0.0)
    host_ms = (sum(v["wall_ms"] for v in stages.values()) - decode_ms
               - stages.get("sched-gap", {}).get("wall_ms", 0.0))
    print(f"  [decode {decode_ms:.0f} ms; other instrumented host work {host_ms:.0f} ms = "
          f"{100 * host_ms / max(decode_ms, 1e-9):.1f}% of decode]")
    print(f"serving, one profiled burst of {n_files} files: {idle_line(busy)}", flush=True)
    return dict(offline_wps=offline_wps, serve_wps=serve_wps, rate=seconds / serve_best,
                stages=stages, busy_s=busy["busy_s"], idle_share=busy["idle_share"])


def main(argv=None) -> int:
    args = parse_args(argv)
    print("card: none (CPU run)" if args.cpu else card_line(), flush=True)
    model, fp16 = tool_model(args.size, args.cpu)
    print(f"{args.size}: max_batch {args.batch}, {args.tokens} tokens a window, best of "
          f"{args.iters}", flush=True)
    run(model, fp16, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
