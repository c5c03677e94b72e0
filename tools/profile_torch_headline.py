"""Where the time goes in the port's headline workload, on the card.

    python3 tools/profile_torch_headline.py [--words | --int4 | --beam | --switches]
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
   `beam_sample_loop`. With `--switches` the whole profile runs three
   times in one process: the headline, then chip_smoke.py's switches calls
   (a) and (b) (WHISPER_AT_TPU_ENC_ATTN=flash, WHISPER_AT_TPU_CROSS_DECODE=
   stream and `models.decoder.FUSED_MLP`: K7, K8, K10; (b) with int4 cross
   K/V and bf16 weights), so each alternative's stages stand beside the
   headline's;
3. one call under `torch.profiler`: the device's busy time (the union of
   kernel intervals) and its idle share of that same profiled call, the
   kernels that take the most device time, the device time of each of the
   port's kernels, and that of the widening copies (`direct_copy` kernels),
   each with its share of the busy time.

Prints the card's name and power limit, then one JSON object per profiled
configuration (all of them also written to --out). Needs one NVIDIA GPU.
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
    BATCH, BEAM, HEADLINE_OPTS, INT4_OPTS, SEED, SIZE, SWITCHES_B_OPTS, card_line,
    full_text_opts, switches_on, synth_audio, words_opts)

# device kernels of the port, by the name of their __global__ function
# (K1 and K7 are both attn_sm90's attn_kernel; a call runs one of them;
# K2 is ln_rows, then gemm_sm90's gemm_kernel for fc1 (BiasGelu) and for
# fc2 (BiasResidual); K3 and K3-int4 are gemm_kernel with the KvQuantize
# epilogue; K8 is fused_mlp_gemm twice, fc1 then fc2)
PORT_KERNELS = ("attn_kernel", "ln_rows", "BiasGelu", "BiasResidual", "KvQuantize",
                "cross_decode_kernel", "cross_decode_stream_kernel",
                "cross_decode_stream_combine", "w4_matmul_kernel",
                "fused_mlp_gemm", "flash_decode", "dtw")


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


def time_stages(call, words: bool, label: str) -> dict:
    """A warm-up call, two timed calls and the stage split of call()."""
    _, warm_s = timed(call)
    call_s = [timed(call)[1] for _ in range(2)]
    torch.cuda.reset_peak_memory_stats()
    stages = stage_times(call, stage_hooks(words))
    peak = torch.cuda.max_memory_allocated()
    print(json.dumps({"options": label, "call_s": call_s, "stages": stages}), flush=True)
    return {"options": label, "peak_memory_bytes_stage_call": peak, "first_call_s": warm_s,
            "call_s": call_s, "stages": stages}


def profile_call(call, audio_s: float, card: str, timing: dict) -> dict:
    """One call of call() under torch.profiler, reported beside `timing`.
    Every timed call of a run comes before its first profiled call: calls
    timed after a profiled one ran up to 1.5x slower than the same calls in
    a process that had not run the profiler (NVIDIA H100, switches calls)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, prof_s = timed(call)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = busy_seconds([(e.time_range.start, e.time_range.end) for e in kernels])
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]

    def device_s(pattern: str) -> float:
        return sum(us for name, us in by_name.items() if pattern in name) * 1e-6

    port = {name: device_s(name) for name in PORT_KERNELS if device_s(name) > 0}
    copy_s = device_s("direct_copy")
    return {
        "card": card, "audio_s": audio_s, **timing,
        "audio_s_per_s": [audio_s / s for s in timing["call_s"]],
        "profiled_call_s": prof_s, "device_busy_s": busy,
        "device_idle_share_of_profiled_call": 1 - busy / prof_s,
        "n_kernel_launches": len(kernels),
        "port_kernels_device_s": port,
        "port_kernels_share_of_device_busy": {k: v / busy for k, v in port.items()},
        "widening_copies_device_s": copy_s, "widening_copies_share_of_device_busy": copy_s / busy,
        "top_kernels_ms": [[name[:90], us * 1e-3] for name, us in top],
    }


def with_switches(call):
    """call() with the JAX package's three switches on (chip_smoke's
    `switches_on`)."""
    def switched():
        with switches_on():
            return call()
    return switched


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
    mode.add_argument("--switches", action="store_true",
                      help="profile the headline, then switches calls (a) and (b)")
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

    if args.switches:
        runs = [("headline", HEADLINE_OPTS, False),
                ("switches (a)", HEADLINE_OPTS, True),
                ("switches (b)", SWITCHES_B_OPTS, True)]
    elif args.words:
        runs = [("words", words_opts(model), False)]
    elif args.int4:
        runs = [("int4", INT4_OPTS, False)]
    elif args.beam:
        runs = [(f"beam{BEAM}", dict(full_text_opts(model), beam_size=BEAM), False)]
    else:
        runs = [("headline", HEADLINE_OPTS, False)]
    calls, timings = [], []
    for label, opts, switches in runs:
        call = functools.partial(wat.transcribe_batched, model, audio, **opts)
        calls.append(with_switches(call) if switches else call)
        timings.append(time_stages(calls[-1], args.words, label))
    reports = []
    for call, timing in zip(calls, timings):
        reports.append(profile_call(call, len(audio) / 16000, card, timing))
        print(json.dumps(reports[-1]), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(reports[0] if len(reports) == 1 else reports, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
