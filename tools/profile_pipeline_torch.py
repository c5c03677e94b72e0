"""Stage timing of the port's batched transcribe+tag pipeline.

    python3 tools/profile_pipeline_torch.py [--size large-v1] [--batch 24]
        [--tokens 96] [--iters 3]
    python3 tools/profile_pipeline_torch.py --size tiny --cpu      # smoke

The port of tools/profile_pipeline.py. Over chip_smoke.py's synthesized
audio (`synth_audio`, --batch windows of 30 s) and its headline options
(`HEADLINE_OPTS` at --tokens a window), it times, each warm and the best of
--iters with the device synchronized before and after (`timed` of
tools/profile_torch_headline.py):

  full pipeline        the whole transcribe_batched call;
  mel (incl. H2D)      the log-mel of the audio, its copy to the device
                       included;
  encoder+taps         Whisper.embed_audio over the windows;
  DecodingTask.run     the encoder again, the cross K/V, the decode loop
                       and the logits; decode alone is it minus the
                       encoder, as the JAX tool subtracts.

The stages overlap. Then one call with its stages timed inside it
(`stage_times` over `stage_hooks` of the same tool), and two under
torch.profiler: the device's busy time and idle share with device activity
recorded, as the other profilers record it, then with host activity
recorded too, as the headline profile does. On the card the
kernels are built first; --cpu runs fp32 on the CPU (host times only).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from profile_torch_headline import (  # noqa: E402
    device_busy, idle_line, stage_hooks, stage_times, timed, tool_model)

from chip_smoke import HEADLINE_OPTS, SEED, card_line, synth_audio  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", default="large-v1")
    ap.add_argument("--batch", type=int, default=24)
    ap.add_argument("--tokens", type=int, default=96)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--cpu", action="store_true", help="fp32 on the CPU (a smoke)")
    return ap.parse_args(argv)


def best_of(fn, iters: int) -> float:
    """Seconds of the fastest of `iters` synchronized calls after a warm-up."""
    timed(fn)
    return min(timed(fn)[1] for _ in range(iters))


def run(model, fp16: bool, args) -> dict:
    """Print and return the stage times of the pipeline at args' sizes."""
    import whisper_at_tpu_torch as wat
    from whisper_at_tpu_torch.audio import N_SAMPLES, log_mel_spectrogram
    from whisper_at_tpu_torch.decoding import DecodingOptions, DecodingTask
    from whisper_at_tpu_torch.transcribe import _mel_to_windows

    secs = args.batch * 30
    audio = synth_audio(secs, SEED)
    opts = dict(HEADLINE_OPTS, sample_len=args.tokens, max_batch=args.batch, fp16=fp16)
    dev = model.device
    out = {}

    out["full_s"] = best_of(lambda: wat.transcribe_batched(model, audio, **opts), args.iters)
    print(f"full pipeline: {out['full_s'] * 1000:.0f} ms ({secs / out['full_s']:.1f} audio-s/s)",
          flush=True)
    out["mel_s"] = best_of(lambda: log_mel_spectrogram(audio, padding=N_SAMPLES, device=dev),
                           args.iters)
    print(f"mel (incl. H2D): {out['mel_s'] * 1000:.0f} ms", flush=True)

    windows, _ = _mel_to_windows(log_mel_spectrogram(audio, padding=N_SAMPLES, device=dev))
    n_win = windows.shape[0]
    out["encoder_s"] = best_of(lambda: model.embed_audio(windows, fp16), args.iters)
    print(f"encoder+taps (batch {n_win}): {out['encoder_s'] * 1000:.0f} ms", flush=True)

    task = DecodingTask(model, DecodingOptions(**{
        k: v for k, v in opts.items() if k in DecodingOptions.__dataclass_fields__}))
    out["task_s"] = best_of(lambda: task.run(windows), args.iters)
    out["decode_s"] = out["task_s"] - out["encoder_s"]
    print(f"DecodingTask.run (incl. encoder): {out['task_s'] * 1000:.0f} ms "
          f"(decode alone ~{out['decode_s'] * 1000:.0f} ms)", flush=True)

    def call():
        return wat.transcribe_batched(model, audio, **opts)

    out["stages"] = stage_times(call, stage_hooks(False))
    print("stages inside one call: " + ", ".join(
        f"{k} {v:.4f}" for k, v in out["stages"].items()), flush=True)
    busy = device_busy(call)
    out.update(busy_s=busy["busy_s"], idle_share=busy["idle_share"])
    print(f"full pipeline, one profiled call: {idle_line(busy)}", flush=True)
    # the next call recorded as the headline profile records it (host
    # activity too), so the two readings' idle shares stand side by side
    hosted = device_busy(call, host_activity=True)
    out["idle_share_host_recorded"] = hosted["idle_share"]
    if hosted["idle_share"] is not None:
        print(f"full pipeline, the next call with host activity recorded too (the "
              f"headline profile's recording): {idle_line(hosted)}", flush=True)
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    print("card: none (CPU run)" if args.cpu else card_line(), flush=True)
    model, fp16 = tool_model(args.size, args.cpu)
    print(f"{args.size}, {args.batch} windows of 30 s, {args.tokens} tokens a window, best of "
          f"{args.iters}", flush=True)
    run(model, fp16, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
