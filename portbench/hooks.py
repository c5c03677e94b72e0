"""Stage spans around the program's layers, and the device's trace.

Copied from the port's `tools/profile_torch_headline.py` (`stage_hooks`,
`stage_times`, `busy_seconds`, `device_busy`): the functions that an entry
reaches for each layer are wrapped so that each call synchronises before
and after and adds its wall time to its stage. The synchronisations
serialise the pipeline, so these seconds are read in a traced run only,
on one call after the plain calls and before any profiled call.

`device_profile` records device activity only: the union of its
operations' intervals is the busy time against which the idle share is
read. `breakdown_profile` records host activity too, which lengthens the
call, so it gives the `breakdown` and nothing else.
"""

import bisect
import functools
import importlib
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch


def sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed(fn: Callable):
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
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


def stage_hooks() -> List[Tuple[object, str, str]]:
    """(owner, function name, stage) of every function timed as a stage:
    the frontend (`log_mel_spectrogram` of transcribe_batched,
    `_frontend_many` of transcribe_many: host prep, copy and mel), the
    encoder with its taps, the cross K/V (K3), the greedy loop and the
    TL-TR head."""
    from whisper_at_tpu_torch import decoding
    from whisper_at_tpu_torch.models.whisper import Whisper

    # the module, not the package's function of the same name
    transcribe = importlib.import_module("whisper_at_tpu_torch.transcribe")
    return [(transcribe, "log_mel_spectrogram", "mel_s"),
            (transcribe, "_frontend_many", "mel_s"),
            (Whisper, "embed_audio", "encoder_s"),
            (decoding, "precompute_cross_kv", "cross_kv_s"),
            (decoding, "greedy_sample_loop", "decode_s"),
            (Whisper, "at_forward", "tags_s")]


def stage_times(call: Callable, hooks) -> Dict[str, float]:
    """Run call() once with the stage functions wrapped by timers. Returns
    each stage's seconds, the greedy loop's steps, the rest (the call minus
    its stages: host work) and the call's seconds."""
    stages = {key: 0.0 for _, _, key in hooks}
    steps = []

    def wrap(fn, key):
        @functools.wraps(fn)
        def timed_stage(*args, **kwargs):
            out, seconds = timed(lambda: fn(*args, **kwargs))
            stages[key] += seconds
            if key == "decode_s":
                steps.append(int(out[3]))
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
    stages["rest_s"] = call_s - sum(stages[k] for k in stage_keys)
    stages["call_s"] = call_s
    return stages


def _device_events(prof) -> list:
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.start_ns() * 1e-3, (e.start_ns() + e.duration_ns()) * 1e-3)
            for e in prof.profiler.kineto_results.events() if e.device_type() == cuda]


def device_profile(call: Callable) -> Optional[dict]:
    """One call under torch.profiler recording device activity only, read
    from the profiler's raw records: {"call_s", "busy_s" (the union of the
    device's operation intervals), "ops": [(name, start us, end us)]}.
    None without a device."""
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_initialized():
        return None
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, call_s = timed(call)
    ops = _device_events(prof)
    return {"call_s": call_s, "busy_s": busy_seconds([(s, e) for _, s, e in ops]),
            "ops": ops}


def _idle_gaps(ops) -> List[Tuple[float, float]]:
    """[start, end) microseconds of every gap between the device's busy
    intervals."""
    gaps, cur_e = [], None
    for s, e in sorted((s, e) for _, s, e in ops):
        if cur_e is not None and s > cur_e:
            gaps.append((cur_e, s))
        cur_e = e if cur_e is None else max(cur_e, e)
    return gaps


def breakdown_profile(call: Callable, top: int = 10, scan: int = 64) -> Optional[dict]:
    """One call under torch.profiler recording host and device activity:
    {"device_ops": the `top` device operations by summed seconds,
    "idle_gaps": the device's idle seconds summed by what the host was
    doing, the `top` largest}. A gap is put on the innermost host operation
    running at its middle (the last of `scan` host records that start before
    it and cover it), or on "host: between recorded ops" (Python)."""
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_initialized():
        return None
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        timed(call)
    cpu = torch.autograd.DeviceType.CPU
    ops = _device_events(prof)
    host = sorted((e.start_ns() * 1e-3, (e.start_ns() + e.duration_ns()) * 1e-3, e.name())
                  for e in prof.profiler.kineto_results.events() if e.device_type() == cpu)
    starts = [h[0] for h in host]
    by_op: Dict[str, float] = {}
    for name, s, e in ops:
        by_op[name] = by_op.get(name, 0.0) + (e - s) * 1e-6
    by_host: Dict[str, float] = {}
    for s, e in _idle_gaps(ops):
        mid = 0.5 * (s + e)
        label = "host: between recorded ops"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - scan, -1), -1):
            if host[j][1] >= mid:
                label = host[j][2]
                break
        by_host[label] = by_host.get(label, 0.0) + (e - s) * 1e-6

    def largest(d):
        return [[k[:120], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": largest(by_op), "idle_gaps": largest(by_host)}
