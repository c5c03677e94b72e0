"""Where the time goes in the port's headline workload, on the card.

    python3 tools/profile_torch_headline.py [--words | --int4 | --beam]
        [--out build/profile_torch_headline.json]

Builds large-v1 (bf16, random weights from a seeded generator) and runs
`transcribe_batched` over chip_smoke.py's synthesized audio with
chip_smoke.py's headline options (`HEADLINE_OPTS`, `synth_audio`):

1. one warm-up call, then two plain calls, each timed on the host clock
   between two `torch.cuda.synchronize()`;
2. one call with its stages timed. The functions that `transcribe_batched`
   reaches for each stage (log-mel, `Whisper.embed_audio` with K1 and K2,
   `precompute_cross_kv` with K3, `greedy_sample_loop` with K4,
   `Whisper.at_forward`) are wrapped so that each call synchronizes before
   and after and adds its wall time to its stage; the call itself is the
   real path. The call's time minus the stages is host work. With
   `--words` the call takes chip_smoke.py's words options (`words_opts`:
   word timestamps, every window decoding full-length text) and the
   word-timing stages
   are timed the same way: the alignment forward
   (`decoder_forward_with_qk`), the token probabilities, the weight chain
   (`_process_qk_weights`), K6 (`ops.dtw.dtw_trace`), the host backtrace
   and the word carving (`_alignment_from_path`, `_apply_alignment`).
   With `--int4` the call takes chip_smoke.py's `INT4_OPTS` (int4 cross
   K/V, weights through K5, self cache); with `--beam` its beam call's
   options (beam_size=5, full-length text), the decode stage being
   `beam_sample_loop`;
3. one call under `torch.profiler`: the device's busy time (the union of
   kernel intervals) and its idle share of that same profiled call, the
   kernels that take the most device time, and the device time of K5 and
   of the widening copies (`direct_copy` kernels) with their shares of the
   busy time.

Prints the card's name and power limit, then one JSON object (also
written to --out). Needs one NVIDIA GPU.
"""

import argparse
import functools
import importlib
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (  # noqa: E402
    BATCH, BEAM, HEADLINE_OPTS, INT4_OPTS, SEED, SIZE, card_line, full_text_opts, synth_audio,
    words_opts)


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def busy_seconds(intervals) -> float:
    """Length of the union of [start, end) intervals (microseconds in, s out)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total * 1e-6


def stage_hooks(words: bool) -> list:
    """(owner, function name, stage) of every function timed as a stage."""
    from whisper_at_tpu_torch import decoding, timing
    from whisper_at_tpu_torch.models.whisper import Whisper
    from whisper_at_tpu_torch.ops import dtw

    # the module, not the package's `transcribe` function of the same name
    transcribe = importlib.import_module("whisper_at_tpu_torch.transcribe")
    hooks = [(transcribe, "log_mel_spectrogram", "mel_s"),
             (Whisper, "embed_audio", "encoder_s"),
             (decoding, "precompute_cross_kv", "cross_kv_s"),
             (decoding, "greedy_sample_loop", "decode_s"),
             (decoding, "beam_sample_loop", "decode_s"),
             (Whisper, "at_forward", "tags_s")]
    if words:
        hooks += [(timing, "decoder_forward_with_qk", "align_forward_s"),
                  (timing, "_token_probs_from_logits", "token_probs_s"),
                  (timing, "_process_qk_weights", "weight_chain_s"),
                  (dtw, "dtw_trace", "dtw_kernel_s"),
                  (dtw, "backtrace", "backtrace_s"),
                  (timing, "_alignment_from_path", "carving_s"),
                  (timing, "_apply_alignment", "carving_s")]
    return hooks


def stage_times(call, hooks) -> dict:
    """Run call() once with the path's stage functions wrapped by timers."""
    stages = {key: 0.0 for _, _, key in hooks}
    steps = []

    def wrap(fn, key):
        @functools.wraps(fn)
        def timed_stage(*args, **kwargs):
            out, seconds = timed(lambda: fn(*args, **kwargs))
            stages[key] += seconds
            if key == "decode_s":  # greedy: steps run; beam: a device count
                steps.append(int(out[3] if len(out) == 4 else out[6]))
            return out
        return timed_stage

    originals = [(owner, name, getattr(owner, name)) for owner, name, _ in hooks]
    for (owner, name, key), (_, _, fn) in zip(hooks, originals):
        setattr(owner, name, wrap(fn, key))
    try:
        _, call_s = timed(call)
    finally:
        for owner, name, fn in originals:
            setattr(owner, name, fn)
    stage_keys = list(stages)
    stages["decode_steps"] = sum(steps)
    stages["decode_ms_per_step"] = stages["decode_s"] / max(sum(steps), 1) * 1e3
    stages["rest_s"] = call_s - sum(stages[k] for k in stage_keys)
    stages["call_s"] = call_s
    return stages


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default="build/profile_torch_headline.json")
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--words", action="store_true",
                      help="profile the call with word_timestamps=True")
    mode.add_argument("--int4", action="store_true",
                      help="profile the call with every int4 option")
    mode.add_argument("--beam", action="store_true",
                      help=f"profile the call with beam_size={BEAM}, full-length text")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import whisper_at_tpu_torch as wat
    from whisper_at_tpu_torch.ops import cuda

    card = card_line()
    print(card, flush=True)
    cuda.build_all()
    model = wat.build_model(SIZE, device="cuda", dtype=torch.bfloat16, seed=SEED)
    audio = synth_audio(BATCH * 30, SEED)

    if args.words:
        opts = words_opts(model)
    elif args.int4:
        opts = INT4_OPTS
    elif args.beam:
        opts = dict(full_text_opts(model), beam_size=BEAM)
    else:
        opts = HEADLINE_OPTS

    def call():
        return wat.transcribe_batched(model, audio, **opts)

    _, warm_s = timed(call)
    call_s = [timed(call)[1] for _ in range(2)]
    torch.cuda.reset_peak_memory_stats()
    stages = stage_times(call, stage_hooks(args.words))
    peak = torch.cuda.max_memory_allocated()
    print(json.dumps({"call_s": call_s, "stages": stages}), flush=True)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, prof_s = timed(call)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = busy_seconds([(e.time_range.start, e.time_range.end) for e in kernels])
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]

    def device_s(pattern: str) -> float:
        return sum(us for name, us in by_name.items() if pattern in name) * 1e-6

    k5_s, copy_s = device_s("w4_matmul_kernel"), device_s("direct_copy")
    audio_s = len(audio) / 16000
    report = {
        "card": card, "audio_s": audio_s,
        "options": "words" if args.words else "int4" if args.int4 else
                   f"beam{BEAM}" if args.beam else "headline",
        "peak_memory_bytes_stage_call": peak,
        "first_call_s": warm_s, "call_s": call_s,
        "audio_s_per_s": [audio_s / s for s in call_s], "stages": stages,
        "profiled_call_s": prof_s, "device_busy_s": busy,
        "device_idle_share_of_profiled_call": 1 - busy / prof_s,
        "n_kernel_launches": len(kernels),
        "k5_device_s": k5_s, "k5_share_of_device_busy": k5_s / busy,
        "widening_copies_device_s": copy_s, "widening_copies_share_of_device_busy": copy_s / busy,
        "top_kernels_ms": [[name[:90], us * 1e-3] for name, us in top],
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
