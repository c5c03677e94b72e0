"""Window-finalize latency of the port's live streaming sessions.

    python3 tools/profile_streaming_torch.py [--size large-v1] [--minutes 3]
        [--streams 1|N] [--block-ms 250] [--sample-len 96] [--realtime]
        [--host-prof]
    python3 tools/profile_streaming_torch.py --size tiny --minutes 1 --cpu  # smoke

The port of tools/profile_streaming.py. It feeds live streams (chip_smoke.py's
`synth_audio`, --minutes each) in --block-ms blocks and records, for every
feed that finalized a window, the wall time of that feed: when a window's
last sample arrives, how long until its transcript and tags are in hand.
With --streams 1 one standalone StreamingTranscriber after a warm-up
session; with --streams N, N sessions of one StreamingService, each fed from
its own thread like N client connections, after the service's warm-up over
N sessions, so the scheduler batches their windows. --realtime sleeps
between blocks as a microphone would; otherwise blocks go as fast as they
are taken. Prints p50 / p95 / max finalize latency, the real-time headroom,
the aggregate audio-s/s, with --host-prof the WHISPER_AT_TPU_STREAM_PROF
stage table (feed-normalize, window-join, prep-h2d, decode-wait,
parse-segments, tags-drain; the scheduler's sched-materialize,
sched-decode, sched-tags), and the device's busy time and idle share over
one profiled stream of the same workload. The decode options are the
headline's (`HEADLINE_OPTS`) at --sample-len tokens. --cpu runs fp32 on
the CPU (a smoke).
"""

import argparse
import contextlib
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from profile_serving_torch import profiling, stage_table  # noqa: E402
from profile_service_torch import serving_options  # noqa: E402
from profile_torch_headline import device_busy, idle_line, tool_model  # noqa: E402

from chip_smoke import SEED, card_line, synth_audio  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", default="large-v1")
    ap.add_argument("--minutes", type=float, default=3.0)
    ap.add_argument("--block-ms", type=int, default=250,
                    help="feed granularity (a mic callback cadence)")
    ap.add_argument("--sample-len", type=int, default=96)
    ap.add_argument("--streams", type=int, default=1,
                    help="concurrent sessions through StreamingService "
                         "(1 = a single standalone session)")
    ap.add_argument("--max-wait", type=float, default=0.05,
                    help="service batch-fill window (s)")
    ap.add_argument("--max-total-wait", type=float, default=None,
                    help="rolling-fill hard cap (s); equal to --max-wait gives the "
                         "fixed-window scheduler")
    ap.add_argument("--cpu", action="store_true", help="fp32 on the CPU (a smoke)")
    ap.add_argument("--realtime", action="store_true",
                    help="sleep between blocks to simulate a live mic (default: feed as "
                         "fast as possible and measure only the finalize latency)")
    ap.add_argument("--host-prof", action="store_true",
                    help="print the WHISPER_AT_TPU_STREAM_PROF stage table")
    return ap.parse_args(argv)


def run(model, fp16: bool, args) -> dict:
    import whisper_at_tpu_torch as wat
    from whisper_at_tpu_torch.streaming import _stream_prof

    opts = serving_options(args.sample_len, fp16)
    block = int(16000 * args.block_ms / 1000)
    seconds = int(60 * args.minutes)

    def drive(sess, wave, latencies):
        """Feed one stream; the latency of every feed after which the
        session's seek advanced (a window was decoded, speech or not)."""
        for lo in range(0, len(wave), block):
            before = sess._seek
            t0 = time.perf_counter()
            sess.feed(wave[lo:lo + block])
            dt = time.perf_counter() - t0
            if sess._seek > before:
                latencies.append(dt)
            if args.realtime:
                time.sleep(max(0.0, args.block_ms / 1000 - dt))
        t0 = time.perf_counter()
        result = sess.finish()
        return result, time.perf_counter() - t0

    latencies, finishes, errors = [], [], []
    stats_line, n_segments = "", None
    with profiling(_stream_prof) if args.host_prof else contextlib.nullcontext():
        if args.streams == 1:
            warm = wat.StreamingTranscriber(model, **opts)
            warm.feed(synth_audio(31, SEED + 99))
            warm.finish()
            _stream_prof.snapshot()
            t0 = time.perf_counter()
            result, finish_s = drive(wat.StreamingTranscriber(model, **opts),
                                     synth_audio(seconds, SEED), latencies)
            wall = time.perf_counter() - t0
            n_segments = len(result["segments"])
            snap = _stream_prof.snapshot()
            busy = device_busy(lambda: drive(wat.StreamingTranscriber(model, **opts),
                                             synth_audio(seconds, SEED + 1), []))
        else:
            with wat.StreamingService(model, max_wait_s=args.max_wait,
                                      max_total_wait_s=args.max_total_wait) as service:
                service.warmup(args.streams, **opts)
                warm = service.stats()
                _stream_prof.snapshot()

                def drive_all(waves, lats):
                    sessions = [service.open(**opts) for _ in waves]

                    def one(i):
                        try:
                            finishes.append(drive(sessions[i], waves[i], lats)[1])
                        except Exception as exc:  # noqa: BLE001 - raised in the caller
                            errors.append(exc)
                    threads = [threading.Thread(target=one, args=(i,))
                               for i in range(len(waves))]
                    for th in threads:
                        th.start()
                    for th in threads:
                        th.join(timeout=1800)
                    if errors or any(th.is_alive() for th in threads):
                        raise errors[0] if errors else RuntimeError("a session did not finish")

                t0 = time.perf_counter()
                drive_all([synth_audio(seconds, SEED + i) for i in range(args.streams)],
                          latencies)
                wall = time.perf_counter() - t0
                finish_s = max(finishes)
                st = service.stats()
                stats_line = (f"  service: {st['windows'] - warm['windows']} window decodes in "
                              f"{st['batches'] - warm['batches']} batches (max "
                              f"{st['max_batch_windows']}/batch; warmup excluded)")
                snap = _stream_prof.snapshot()
                busy = device_busy(lambda: drive_all(
                    [synth_audio(seconds, SEED + 50 + i) for i in range(args.streams)], []))
        _stream_prof.snapshot()

    lat = sorted(latencies)
    total_audio = seconds * args.streams
    print(f"{args.streams} stream(s), {args.minutes:.1f} min each, fed in {args.block_ms} ms "
          f"blocks: {len(lat)} window finalizations"
          + (f", {n_segments} segments" if n_segments is not None else ""))
    if stats_line:
        print(stats_line)
    out = dict(wall_s=wall, rate=total_audio / wall, busy_s=busy["busy_s"],
               idle_share=busy["idle_share"])
    if lat:
        out.update(p50=lat[len(lat) // 2], p95=lat[int(len(lat) * 0.95) if len(lat) > 1 else 0],
                   max=lat[-1])
        print(f"window-finalize latency: p50 {out['p50']:.3f}s  p95 {out['p95']:.3f}s  "
              f"max {lat[-1]:.3f}s  (finish(): {finish_s:.3f}s)")
        print(f"real-time headroom: {30.0 / lat[-1]:.1f}x (worst window vs its 30 s budget); "
              f"aggregate {out['rate']:.1f} audio-s/s over the drive")
    if args.host_prof:
        out["stages"] = snap
        print(f"\nhost-work profile over the whole drive (wall vs CPU separates blocked "
              f"waits from work that holds the interpreter lock):")
        print("\n".join(stage_table(snap, wall)))
    print(f"streaming, one profiled drive of {args.streams} stream(s): {idle_line(busy)}",
          flush=True)
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    print("card: none (CPU run)" if args.cpu else card_line(), flush=True)
    model, fp16 = tool_model(args.size, args.cpu)
    print(f"{args.size}: {args.streams} stream(s) of {args.minutes} min, {args.sample_len} "
          f"tokens a window{', real time' if args.realtime else ''}", flush=True)
    run(model, fp16, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
