"""The one traffic generator: reads a mix's data file and makes its calls.

A mix (`traffic/<name>.json`) names the entry it drives and its parameters:

  entry             the module `entries/<entry>.py` that drives the program:
                    its `call(model, files, options)` returns one result
                    dict a file; it may also define `run_window(...)`,
                    `traced_calls(...)` and `readings(...)`, which default
                    to the closed loop below, `bench.traced_calls` and
                    `check.readings`
                    ("transcribe_batched": one recording a call,
                    "transcribe_many": many files a call)
  files_per_call    recordings a call
  seconds_per_file  length of each recording (16 kHz int16 PCM)
  pool              distinct calls made at set-up; call i sends pool[i % pool]
  tone_hz           [low, high]: each segment_seconds of a recording is a
                    tone at its own frequency, drawn log-uniformly from the
                    seed, so that no two windows carry the same input
  segment_seconds   the length of one tone (30: one a decode window)
  tone_amplitude, noise_amplitude
                    each recording is tones plus Gaussian noise, clipped to
                    [-1, 1] and scaled to int16 (the repository's synthetic
                    speech stand-in, `chip_smoke.synth_audio`, with a tone a
                    segment in place of one 220 Hz tone)
  options           the entry's keyword options as sent
  check_windows     windows the comparison samples after the window closes

Every recording is drawn on the device from the run's seed and its pool
index, in one call per pool entry, and copied to the host as a numpy array,
which is what a user hands the entry after reading files. The same seed
gives the same audio; every seed gives the same sizes, so the work a call
does does not depend on the seed.
"""

import importlib.util
import json
import os
import time
from typing import Callable, Dict, List

import numpy as np
import torch

SAMPLE_RATE = 16000


def entry_path(bench_dir: str, entry: str) -> str:
    return os.path.join(bench_dir, "entries", f"{entry}.py")


def load_mix(path: str) -> dict:
    with open(path) as f:
        mix = json.load(f)
    bench_dir = os.path.dirname(os.path.dirname(os.path.abspath(path)))
    if not os.path.isfile(entry_path(bench_dir, mix["entry"])):
        raise ValueError(f"{path}: no entry {entry_path(bench_dir, mix['entry'])}")
    mix["name"] = os.path.splitext(os.path.basename(path))[0]
    return mix


def load_entry(bench_dir: str, entry: str):
    """The module entries/<entry>.py."""
    spec = importlib.util.spec_from_file_location(f"portbench_entry_{entry}",
                                                  entry_path(bench_dir, entry))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def sub_seed(seed: int, index: int) -> int:
    """A generator seed for entry `index` of a run's pool (any int seed)."""
    return (int(seed) * 1_000_003 + 7919 * (index + 1)) % (1 << 63)


def make_call_audio(mix: dict, seed: int, index: int, device) -> List[np.ndarray]:
    """The recordings of pool entry `index`: files_per_call int16 arrays."""
    n = int(mix["seconds_per_file"] * SAMPLE_RATE)
    files = int(mix["files_per_call"])
    seg = int(mix["segment_seconds"] * SAMPLE_RATE)
    n_seg = -(-n // seg)
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, index))
    lo, hi = np.log(mix["tone_hz"][0]), np.log(mix["tone_hz"][1])
    u = torch.rand((files, n_seg, 1), generator=gen, device=device, dtype=torch.float64)
    hz = torch.exp(lo + (hi - lo) * u)
    # time within each segment, in float64 so the phase stays exact
    t = torch.arange(seg, device=device, dtype=torch.float64) / SAMPLE_RATE
    tone = torch.sin(2 * np.pi * hz * t).float().reshape(files, n_seg * seg)[:, :n]
    noise = torch.randn((files, n), generator=gen, device=device, dtype=torch.float32)
    a = mix["tone_amplitude"] * tone + mix["noise_amplitude"] * noise
    pcm = (torch.clamp(a, -1.0, 1.0) * 32767.0).to(torch.int16).cpu().numpy()
    return list(pcm)


def make_pool(mix: dict, seed: int, device) -> List[List[np.ndarray]]:
    return [make_call_audio(mix, seed, i, device) for i in range(int(mix["pool"]))]


def call_options(mix: dict, config: dict) -> Dict:
    """The options a call sends: the mix's, the configuration's program
    options and its suppressed tokens (EOT and timestamps among them, so
    every window decodes exactly sample_len tokens)."""
    tok = config["tokens"]
    suppress = sorted(set(tok["suppress"]) | set(range(tok["suppress_from"],
                                                         config["dims"]["n_vocab"])))
    return dict(mix["options"], **config["program"], suppress_tokens=suppress)


def windows_of(files) -> List[int]:
    """30 s windows the entry decodes for each recording."""
    return [-(-(len(a) // 160) // 3000) for a in files]


def closed_loop(call: Callable, model, mix: dict, pool, options, seconds: float,
                sync: Callable) -> dict:
    """Whole calls back to back, one at a time, call i sending pool[i %
    pool], until `seconds` have passed. Returns {"calls": [{"pool",
    "windows", "results", "seconds"}], "wall_s": first call's start to the
    last call's end, "audio_s": the audio seconds the calls sent}."""
    windows = [windows_of(files) for files in pool]
    calls = []
    start = time.perf_counter()
    while not calls or time.perf_counter() - start < seconds:
        p = len(calls) % len(pool)
        t_call = time.perf_counter()
        results = call(model, pool[p], options)
        calls.append({"pool": p, "windows": windows[p], "results": results,
                      "seconds": time.perf_counter() - t_call})
    sync()
    wall_s = time.perf_counter() - start
    audio_s = len(calls) * mix["files_per_call"] * mix["seconds_per_file"]
    return {"calls": calls, "wall_s": wall_s, "audio_s": audio_s}
