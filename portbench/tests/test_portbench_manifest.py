"""BENCHMARK.json against the benchmark's contract, the harness's isolation
from JAX, and cells, configurations, mixes and metrics added as files."""

import json
import os
import re
import subprocess
import sys

import pytest

from portbench import bench, generator

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
HARNESS = ["portbench.bench", "portbench.check", "portbench.counts", "portbench.generator",
           "portbench.hooks", "portbench.weights", "portbench.readings"]


def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def loaded_after(imports, program=True) -> set:
    """Top-level names of every module a fresh interpreter holds after
    importing `imports` (and the program, when asked)."""
    code = "; ".join([f"import {m}" for m in imports]
                     + (["import whisper_at_tpu_torch"] if program else [])
                     + ["import sys, json",
                        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, USE_FLAX="0"))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_neither_jax_nor_the_jax_package():
    # whole top-level names: whisper_at_tpu_torch begins with whisper_at_tpu
    names = loaded_after(HARNESS)
    assert "whisper_at_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "whisper_at_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    names = loaded_after(["portbench.reference"], program=False)
    assert not names & {"whisper_at_tpu_torch", "whisper_at_tpu", "jax", "jaxlib", "flax"}


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "whisper_at_tpu_torch_x", sys)
    assert "whisper_at_tpu_torch_x" not in bench.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax.numpy" in bench.forbidden_modules()


def test_manifest_keys_names_and_units():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert 1 <= m["run_seconds"] <= 51 and isinstance(m["run_seconds"], int)
    assert m["paths"] == ["portbench"] and m["command"][1] == "portbench/run.py"
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
    for section, need in keys.items():
        names = [e["name"] for e in m[section]]
        assert len(names) == len(set(names))
        for e in m[section]:
            assert set(e) - {"workloads"} == need, e
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for text in ("why", "layer", "source"):
                if text in e:
                    assert 1 <= len(e[text]) <= 200 and "\n" not in e[text]
    for c in m["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("portbench/")
    for w in m["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    for e in m["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25 and e["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {e["name"] for e in m["end_to_end"]}


def test_every_per_layer_metric_moves_a_metric_its_cells_report():
    m = manifest()
    cells = {w["name"] for w in m["workloads"]}
    e2e = {e["name"]: set(e.get("workloads", cells)) for e in m["end_to_end"]}
    for metric in m["per_layer"]:
        assert metric["moves"] in e2e
        for cell in metric.get("workloads", cells):
            assert cell in cells and cell in e2e[metric["moves"]]
        assert os.path.isfile(os.path.join(ROOT, "portbench", "metrics",
                                           f"{metric['name']}.py"))
    for metric in m["end_to_end"]:
        assert os.path.isfile(os.path.join(ROOT, "portbench", "end_to_end",
                                           f"{metric['name']}.py"))


@pytest.mark.parametrize("cell", [w["name"] for w in manifest()["workloads"]])
def test_every_cell_finds_its_files(cell):
    spec = bench.load_cell(ROOT, cell)
    assert spec["end_to_end"] and spec["per_layer"]
    assert os.path.isfile(os.path.join(ROOT, "portbench", "limits", f"{cell}.json"))
    for metric in spec["per_layer"]:
        assert callable(bench.load_reader(spec["dir"], metric["name"]))
    for metric in spec["end_to_end"]:
        assert callable(bench.load_reader(spec["dir"], metric["name"], "end_to_end"))
    assert callable(generator.load_entry(spec["dir"], spec["mix"]["entry"]).call)


def test_a_new_config_mix_metric_and_cell_are_new_files(tmp_path):
    from portbench.conftest import make_small_root

    before = {p: open(os.path.join(ROOT, p), "rb").read()
              for p in ("BENCHMARK.json", "portbench/bench.py")}
    root = make_small_root(tmp_path)
    with open(os.path.join(root, "portbench", "metrics", "windows_per_call.py"), "w") as f:
        f.write("def read(trace):\n    return sum(trace['cell']['windows_per_call'])\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        m = json.load(f)
    m["per_layer"].append({"name": "windows_per_call", "unit": "windows", "better": "higher",
                           "source": "program_counter", "layer": "entry point",
                           "moves": "audio_s_per_s", "workloads": ["small.small_long"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(m, f)
    spec = bench.load_cell(root, "small.small_long")
    assert spec["config"]["name"] == "small" and spec["mix"]["name"] == "small_long"
    names = [x["name"] for x in spec["per_layer"]]
    assert "windows_per_call" in names
    read = bench.load_reader(spec["dir"], "windows_per_call")
    assert read({"cell": {"windows_per_call": [2]}}) == 2
    assert "windows_per_call" not in [x["name"] for x in
                                      bench.load_cell(root, "small.small_many")["per_layer"]]
    for p, data in before.items():  # nothing of the repository was edited
        assert open(os.path.join(ROOT, p), "rb").read() == data


# an entry of its own: files sent at fixed arrivals (open loop), each
# call's latency counted from its arrival
OPEN_LOOP_ENTRY = '''
import time


def call(model, files, options):
    import whisper_at_tpu_torch as wat

    return wat.transcribe_many(model, files, **options)


def run_window(call, model, mix, pool, options, seconds, sync):
    calls, latencies = [], []
    start = time.perf_counter()
    while not calls or time.perf_counter() - start < seconds:
        due = start + len(calls) * mix["arrival_s"]
        time.sleep(max(0.0, due - time.perf_counter()))
        p = len(calls) % len(pool)
        results = call(model, pool[p], options)
        latencies.append(time.perf_counter() - due)
        calls.append({"pool": p, "windows": [1] * len(pool[p]), "results": results,
                      "seconds": latencies[-1]})
    sync()
    return {"calls": calls, "wall_s": time.perf_counter() - start, "latencies": latencies,
            "audio_s": len(calls) * mix["files_per_call"] * mix["seconds_per_file"]}
'''
P95 = "def read(run):\n    lat = sorted(run['window']['latencies'])\n" \
      "    return lat[int(0.95 * (len(lat) - 1))]\n"


def test_a_new_entry_and_end_to_end_metric_are_new_files(tmp_path):
    from portbench.conftest import make_small_root, small_mixes

    before = {p: open(os.path.join(ROOT, p), "rb").read()
              for p in ("BENCHMARK.json", "portbench/bench.py", "portbench/generator.py")}
    root = make_small_root(tmp_path)
    pb = os.path.join(root, "portbench")
    files = {"entries/open_loop_many.py": OPEN_LOOP_ENTRY, "end_to_end/call_p95_s.py": P95}
    mix = dict(small_mixes()["small_many"], entry="open_loop_many", arrival_s=0.05)
    files["traffic/small_open.json"] = json.dumps(mix)
    files["limits/small.small_open.json"] = json.dumps(
        {"limits": {"tag_err": 1e-3, "token_gap": 1e-3, "logprob_err": 1e-3, "missing": 0}})
    for name, text in files.items():
        with open(os.path.join(pb, name), "w") as f:
            f.write(text)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        m = json.load(f)
    m["workloads"].append({"name": "small.small_open", "config": "small",
                           "traffic": "small_open", "chips": 1, "why": "tests"})
    m["end_to_end"].append({"name": "call_p95_s", "unit": "s", "better": "lower",
                            "bound": 0.1, "source": "host_clock",
                            "workloads": ["small.small_open"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(m, f)
    result = bench.run_cell(root, "small.small_open", 12, 0.1, trace=False, device="cpu")
    assert result["correct"] is True
    assert set(result["metrics"]) == {"audio_s_per_s", "peak_mem_gib", "setup_s",
                                      "call_p95_s"}
    assert result["metrics"]["call_p95_s"]["value"] > 0
    assert "call_p95_s" not in [x["name"] for x in
                                bench.load_cell(root, "small.small_many")["end_to_end"]]
    for p, data in before.items():  # nothing of the repository was edited
        assert open(os.path.join(ROOT, p), "rb").read() == data


def test_the_run_fails_without_a_card():
    # decided here, at run time: this test is for a machine with no card
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "medium.clips",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_no_test_file_shares_a_name_with_the_repository_tests():
    ours = {f for f in os.listdir(os.path.dirname(os.path.abspath(__file__)))
            if f.endswith(".py")}
    theirs = set(os.listdir(os.path.join(ROOT, "tests")))
    assert ours and not ours & theirs


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "medium.clips",
                          "--seed", "20260101", "--seconds", "10", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {"audio_s_per_s", "peak_mem_gib", "setup_s"}
