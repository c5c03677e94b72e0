"""Shared fixtures of the benchmark's tests: a copy of the benchmark with a
small configuration and small mixes that a CPU run can hold.

The `cuda` marker (registered here and in the repository's pytest.ini)
marks tests that need an NVIDIA GPU; they skip without one, decided inside
the test."""

import copy
import json
import os
import shutil

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a Whisper of the multilingual vocabulary at a width a CPU run holds
SMALL_DIMS = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=2,
                  n_audio_layer=2, n_vocab=51865, n_text_ctx=448, n_text_head=2,
                  n_text_state=64, n_text_layer=2)
# fp32 and every int8 option: the program's CPU path (plain twins)
SMALL_PROGRAM = {"fp16": False, "kv_quant": True, "weight_quant": True,
                 "self_kv_quant": True, "at_time_res": 10}
SMALL_OPTIONS = {"language": "en", "temperature": 0.0, "sample_len": 6, "max_batch": 4,
                 "without_timestamps": True, "logprob_threshold": None,
                 "compression_ratio_threshold": None, "no_speech_threshold": None}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skipped without one")


def small_config(program=None) -> dict:
    with open(os.path.join(ROOT, "portbench", "configs", "large-v1.json")) as f:
        config = json.load(f)
    config.update(name="small", dims=dict(SMALL_DIMS),
                  program=dict(program or SMALL_PROGRAM))
    return config


def small_mixes() -> dict:
    base = dict(files_per_call=1, pool=2, tone_hz=[100, 4000], segment_seconds=30,
                tone_amplitude=0.3,
                noise_amplitude=0.05, options=dict(SMALL_OPTIONS), check_windows=3)
    long = dict(copy.deepcopy(base), about="two windows", entry="transcribe_batched",
                seconds_per_file=45)
    many = dict(copy.deepcopy(base), about="three clips", entry="transcribe_many",
                files_per_call=3, seconds_per_file=10)
    return {"small_long": long, "small_many": many}


def make_small_root(tmp, limits=None, program=None) -> str:
    """A copy of the benchmark at `tmp` whose BENCHMARK.json has the small
    configuration and a cell for each small mix, added as new files."""
    root = str(tmp)
    shutil.copytree(os.path.join(ROOT, "portbench"), os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(root, "portbench", "configs", "small.json"), "w") as f:
        json.dump(small_config(program), f)
    manifest["configs"].append({"name": "small", "source": "a test width", "reduced": [],
                                "file": "portbench/configs/small.json", "why": "tests"})
    for name, mix in small_mixes().items():
        with open(os.path.join(root, "portbench", "traffic", f"{name}.json"), "w") as f:
            json.dump(mix, f)
        cell = f"small.{name}"
        manifest["workloads"].append({"name": cell, "config": "small", "traffic": name,
                                      "chips": 1, "why": "tests"})
        for metric in manifest["per_layer"]:
            metric["workloads"].append(cell)
        with open(os.path.join(root, "portbench", "limits", f"{cell}.json"), "w") as f:
            json.dump({"limits": limits or {"tag_err": 1e-3, "token_gap": 1e-3,
                                            "logprob_err": 1e-3, "missing": 0}}, f)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(manifest, f)
    return root


@pytest.fixture
def small_root(tmp_path):
    return make_small_root(tmp_path)
