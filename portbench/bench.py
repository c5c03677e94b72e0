"""One run of one cell: set-up, the measured window, the traced calls, the
comparison, and the result line.

Everything a cell needs is found by name under the benchmark's root:

  BENCHMARK.json                  the cell (`workloads`), its configuration
                                  (`configs[].file`) and its metrics
  portbench/traffic/<mix>.json    the traffic mix (`generator.py` reads it)
  portbench/entries/<entry>.py    the entry a mix drives: its call, and
                                  optionally its own window, traced calls
                                  and readings (`generator.py`)
  portbench/end_to_end/<name>.py  an end-to-end metric's reader: read(run),
                                  run = {"window": what the window returned,
                                  "setup_s", "peak_bytes"}
  portbench/metrics/<name>.py     a per-layer metric's reader: read(trace)
                                  returns a number, or None when the trace
                                  holds nothing to read
  portbench/limits/<cell>.json    the limits of the cell's compared numbers

so a later cell, configuration, mix, entry or metric is new files and
entries.
"""

import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

import torch

from . import check, generator, hooks
from .weights import make_weights

FORBIDDEN = ("jax", "jaxlib", "flax", "whisper_at_tpu")
HERE = os.path.dirname(os.path.abspath(__file__))


class CellError(ValueError):
    """The manifest does not define what the run asks for."""


def load_cell(root: str, workload: str) -> dict:
    """The cell `workload` of root/BENCHMARK.json with its configuration,
    mix, metric specs and the paths of its readers and limits."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise CellError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    with open(os.path.join(root, configs[cell["config"]]["file"])) as f:
        config = json.load(f)
    bench_dir = os.path.join(root, os.path.basename(HERE))
    mix = generator.load_mix(os.path.join(bench_dir, "traffic", f"{cell['traffic']}.json"))

    def reports(metric):
        return workload in metric.get("workloads", [workload])

    return {"cell": cell, "config": config, "mix": mix, "dir": bench_dir,
            "end_to_end": [m for m in manifest["end_to_end"] if reports(m)],
            "per_layer": [m for m in manifest["per_layer"] if reports(m)]}


def load_reader(bench_dir: str, name: str, kind: str = "metrics"):
    """<kind>/<name>.py's `read` (kind "metrics": per-layer, "end_to_end")."""
    path = os.path.join(bench_dir, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def card_info(device) -> dict:
    """The card's name and power limit (nvidia-smi), or the CPU."""
    if device.type != "cuda":
        return {"kind": "cpu", "power_limit": None}
    limit = None
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        limit = out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.TimeoutExpired, IndexError):
        pass
    return {"kind": torch.cuda.get_device_name(device), "power_limit": limit}


def build_model(config: dict, sd, device):
    """The program's model, its tensors the state dict's own."""
    from whisper_at_tpu_torch.models.dims import ModelDimensions
    from whisper_at_tpu_torch.models.whisper import Whisper

    model = Whisper(ModelDimensions(**config["dims"]), device="meta")
    if model.at_mode != config["at_mode"]:
        raise CellError(f"the program's head is {model.at_mode}, the configuration's "
                        f"{config['at_mode']}")
    model.load_state_dict(sd, assign=True)
    return model.eval()


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run_cell(root: str, workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", t0: Optional[float] = None) -> dict:
    """Run the cell once; return the result line's dict. `t0` is the
    process's start on the perf_counter clock (set-up is counted from it)."""
    t0 = time.perf_counter() if t0 is None else t0
    device = torch.device(device)
    spec = load_cell(root, workload)
    config, mix = spec["config"], spec["mix"]
    entry = generator.load_entry(spec["dir"], mix["entry"])
    dtype = torch.bfloat16 if config["program"].get("fp16", True) else torch.float32

    # ---------------------------------------------------------- set-up
    if device.type == "cuda":
        from whisper_at_tpu_torch.ops import cuda as kernels

        kernels.build_all()
    sd = make_weights(config["dims"], seed, device, dtype)
    model = build_model(config, sd, device)
    pool = generator.make_pool(mix, seed, device)
    options = generator.call_options(mix, config)
    entry.call(model, pool[0], options)  # every shape the window uses
    _sync(device)
    gc.collect()
    gc.freeze()  # what set-up made is never scanned again by the collector
    setup_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    setup_s = time.perf_counter() - t0

    # ---------------------------------------------------------- window
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    run_window = getattr(entry, "run_window", generator.closed_loop)
    window = run_window(entry.call, model, mix, pool, options, seconds,
                        lambda: _sync(device))
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    card = card_info(device)

    metrics: Dict[str, dict] = {}
    out_device = {"platform": "gpu" if device.type == "cuda" else "cpu",
                  "kind": card["kind"], "count": 1,
                  "memory_peak_bytes": int(max(peak, setup_peak))}
    breakdown = None
    if trace:
        traced = getattr(entry, "traced_calls", traced_calls)
        trace_data = traced(entry.call, model, mix, pool, options, window, config)
        profile = trace_data["profile"]
        if profile is not None:
            out_device["busy_s"] = profile["busy_s"]
            out_device["window_s"] = profile["call_s"]
        breakdown = trace_data.pop("breakdown")
        for m in spec["per_layer"]:
            v = load_reader(spec["dir"], m["name"])(trace_data)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        run = {"window": window, "setup_s": setup_s, "peak_bytes": peak}
        for m in spec["end_to_end"]:
            v = load_reader(spec["dir"], m["name"], "end_to_end")(run)
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    calls = window.get("calls", [])
    print(f"card {card['kind']}, power limit {card['power_limit']}; {len(calls)} calls, "
          f"{window.get('audio_s')} audio s in {window['wall_s']:.4f} s, set-up "
          f"{setup_s:.4f} s; calls (s): {[round(c['seconds'], 4) for c in calls]}",
          file=sys.stderr)

    # ---------------------------------------------------------- comparison
    del model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    readings = getattr(entry, "readings", check.readings)(window, pool, sd, config, mix, seed,
                                                          device)
    judged = check.judge(readings, check.load_limits(spec["dir"], workload))

    result = {"correct": all(j["ok"] for j in judged.values()), "attempted": len(calls),
              "failed": 0, "metrics": metrics, "device": out_device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": j["value"], "limit": j["limit"]}
                        for name, j in judged.items()}
    return result


def traced_calls(call, model, mix, pool, options, window, config) -> dict:
    """After the plain calls of a closed loop: one call with its stages
    timed, one under the profiler recording device activity, one recording
    host activity too (the breakdown). Returns what the per-layer readers
    read."""
    calls = window["calls"]
    n = len(calls)

    def one(i):
        return lambda: call(model, pool[i % len(pool)], options)

    stages = hooks.stage_times(one(n), hooks.stage_hooks())
    profile = hooks.device_profile(one(n + 1))
    breakdown = hooks.breakdown_profile(one(n + 2))
    window_tokens = [len(seg["tokens"]) for c in calls for r in c["results"]
                     for seg in r["segments"]]
    if profile is not None:
        plain = window["wall_s"] / n
        print(f"profiled call {profile['call_s']:.4f} s against the plain calls' mean "
              f"{plain:.4f} s: the profiler's overhead "
              f"{100 * (profile['call_s'] / plain - 1):.2f}%", file=sys.stderr)
    return {
        "stages": stages, "profile": profile, "breakdown": breakdown,
        "cell": {"dims": config["dims"], "at_mode": config["at_mode"],
                 "max_batch": mix["options"]["max_batch"],
                 "sample_len": mix["options"]["sample_len"],
                 "windows_per_call": calls[0]["windows"],
                 "prompt_len": len(config["tokens"]["prompt_en_transcribe_notimestamps"])},
        "window": {"calls": n, "wall_s": window["wall_s"],
                   "windows": sum(sum(c["windows"]) for c in calls),
                   "window_tokens": window_tokens},
    }
