"""The port's examples, its app handler and its notebook, on the CPU at a
small size, against the JAX package's.

Every example's `main()` runs with `--device cpu` on its own synthetic
data. `build_model` is patched in both packages to hand out one small model
pair (2 layers, width 64, a 64-token text context; the port's weights
carried across with `convert.from_jax_params`) whose decoder is confident
(`confident_pair.py`), so that the gate keeps the temperature-0 decode and
both packages decode the same text. The models run in fp32 (`fp16=False`
patched into each package's `transcribe` and `extract_features`): bf16
rounding differs between XLA and PyTorch. Cut from the examples' defaults: the noise
experiment at one SNR, the probe over 12 clips at 200 epochs (the JAX
example's 40 and 1000), train_pipeline at 2 epochs, train_trajectory at 12
/ 16 clips and 2 epochs, the serving example in fp32; the serving and streaming examples and the live
client run on the port only (the client against the port's own server).
"""

import ast
import functools
import importlib.util
import json
import os
import re
import sys
import tempfile
import threading

import numpy as np
import pytest
import torch

import whisper_at_tpu as jwat
import whisper_at_tpu_torch as wat
from whisper_at_tpu_torch.models.dims import ModelDimensions
from whisper_at_tpu_torch.models.whisper import Whisper

from confident_pair import DIMS, confident_models

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORTED = ["demo", "noise_robustness", "esc50_probe", "serving", "streaming_demo",
          "train_pipeline", "train_trajectory", "live_http_client"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The models and probes here are tiny: torch and numpy's BLAS run on
    one thread, which keeps the file's time steady when other test
    processes share the cores (a thread pool per process oversubscribes
    them)."""
    from threadpoolctl import threadpool_limits

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def pair():
    return confident_models()


@pytest.fixture()
def patched(pair, monkeypatch):
    """Both packages hand out the pair and run it in fp32."""
    jm, tm = pair
    monkeypatch.setattr(jwat, "build_model", lambda *a, **k: jm)
    monkeypatch.setattr(wat, "build_model", lambda *a, **k: tm)
    monkeypatch.setattr(jwat, "transcribe", functools.partial(jwat.transcribe, fp16=False))
    monkeypatch.setattr(wat, "transcribe", functools.partial(wat.transcribe, fp16=False))
    jm.transcribe = functools.partial(jwat.transcribe, jm)
    tm.transcribe = functools.partial(wat.transcribe, tm)
    try:
        yield jm, tm
    finally:
        del jm.transcribe, tm.transcribe


def _run(module, argv, capsys, monkeypatch) -> str:
    monkeypatch.setattr(sys, "argv", [module.__name__] + argv)
    capsys.readouterr()
    module.main()
    return capsys.readouterr().out


def test_demo_matches_jax(patched, capsys, monkeypatch):
    """Segments and the top tags of each cell."""
    want = _run(_load("examples/demo.py", "demo"), ["--random"], capsys, monkeypatch)
    got = _run(_load("examples/demo_torch.py", "demo_torch"), ["--random", "--device", "cpu"],
               capsys, monkeypatch)
    assert "=== segments ===" in got and "=== audio tags" in got
    assert got == want


def test_noise_robustness_matches_jax(patched, tmp_path, capsys, monkeypatch):
    """WER by SNR at one SNR; every decode ran at temperature 0 (the pair's
    decoder is confident), so the transcripts, and the WER, are determined."""
    outs = {}
    for name, path in (("jax", "examples/noise_robustness.py"),
                       ("torch", "examples/noise_robustness_torch.py")):
        argv = ["--root", str(tmp_path / name), "--snrs", "0"]
        argv += ["--device", "cpu"] if name == "torch" else []
        outs[name] = _run(_load(path, f"noise_{name}"), argv, capsys, monkeypatch)
        hyp = tmp_path / name / "hyp"
        outs[name + "_texts"] = {f: (hyp / f).read_bytes() for f in sorted(os.listdir(hyp))}
    line = [ln for ln in outs["torch"].splitlines() if ln.startswith("WER by SNR:")]
    assert line and line == [ln for ln in outs["jax"].splitlines()
                              if ln.startswith("WER by SNR:")]
    assert len(outs["torch_texts"]) == 6 and outs["torch_texts"] == outs["jax_texts"]


@pytest.fixture()
def temp_root(tmp_path, monkeypatch):
    """TMPDIR set to a directory of its own, the working directory to
    another: returns (the temporary directory, the working directory)."""
    temp, cwd = tmp_path / "temp", tmp_path / "cwd"
    temp.mkdir()
    cwd.mkdir()
    monkeypatch.setenv("TMPDIR", str(temp))
    monkeypatch.setattr(tempfile, "tempdir", None)  # gettempdir() reads TMPDIR again
    monkeypatch.chdir(cwd)
    monkeypatch.delenv("RANK", raising=False)
    return temp, cwd


ROOTED = {"noise_robustness": ("make_corpus", "wat_noise_torch_"),
          "esc50_probe": ("make_clips", "wat_esc50_torch_"),
          "train_pipeline": ("make_synthetic_dataset", "wat_train_torch_"),
          "train_trajectory": ("make_corpus", "wat_trajectory_torch_")}


@pytest.mark.parametrize("name", sorted(ROOTED))
def test_example_default_root_is_a_new_temporary_directory(name, patched, temp_root,
                                                           monkeypatch):
    """Without --root, each run of an example works in a directory of its
    own under TMPDIR, so no run reads what another (or the JAX example)
    left behind."""
    temp, cwd = temp_root
    maker, prefix = ROOTED[name]
    module = _load(f"examples/{name}_torch.py", f"{name}_torch_root")
    roots = []

    def stop(root, *a, **k):
        roots.append(root)
        raise InterruptedError

    monkeypatch.setattr(module, maker, stop)
    for _ in range(2):
        monkeypatch.setattr(sys, "argv", [name, "--device", "cpu"])
        with pytest.raises(InterruptedError):
            module.main()
    assert len(set(roots)) == 2
    assert sorted(os.listdir(temp)) == sorted(os.path.basename(r) for r in roots)
    assert all(os.path.dirname(r) == str(temp) and os.path.basename(r).startswith(prefix)
               for r in roots)
    assert os.listdir(cwd) == []


def test_noise_robustness_default_root_transcribes_afresh(patched, temp_root, capsys,
                                                          monkeypatch):
    """Two runs without --root: each writes and scores its own six
    transcripts under TMPDIR, the second finding none of the first's."""
    temp, cwd = temp_root
    module = _load("examples/noise_robustness_torch.py", "noise_torch_default")
    outs = [_run(module, ["--snrs", "0", "--device", "cpu"], capsys, monkeypatch)
            for _ in range(2)]
    roots = sorted(os.listdir(temp))
    assert len(roots) == 2 and all(r.startswith("wat_noise_torch_") for r in roots)
    for root in roots:
        assert len(os.listdir(temp / root / "hyp")) == 6
    wer_lines = [[ln for ln in out.splitlines() if ln.startswith("WER by SNR:")] for out in outs]
    assert wer_lines[0] and wer_lines[0] == wer_lines[1]
    assert os.listdir(cwd) == []


def test_esc50_probe_matches_jax(patched, tmp_path, capsys, monkeypatch):
    """The layer accuracies over 12 clips at 200 epochs."""
    outs = {}
    for name, path in (("jax", "examples/esc50_probe.py"),
                       ("torch", "examples/esc50_probe_torch.py")):
        module = _load(path, f"esc50_{name}")
        monkeypatch.setattr(module, "make_clips", functools.partial(module.make_clips, n=12))
        monkeypatch.setattr(module, "extract_features",
                            functools.partial(module.extract_features, fp16=False))
        probe = module.layer_wise_probe
        monkeypatch.setattr(module, "layer_wise_probe",
                            lambda *a, **k: probe(*a, **dict(k, max_iter=200)))
        argv = ["--root", str(tmp_path / name)] + (["--device", "cpu"] if name == "torch" else [])
        outs[name] = _run(module, argv, capsys, monkeypatch)
    accs = [ln for ln in outs["torch"].splitlines() if ln.strip().startswith("layer ")]
    assert len(accs) == DIMS["n_audio_layer"]
    assert accs == [ln for ln in outs["jax"].splitlines() if ln.strip().startswith("layer ")]


def test_train_pipeline_saves_a_model_load_model_reads(pair, tmp_path, capsys, monkeypatch):
    """Two epochs; the saved reference-layout .pt reloads with load_model to
    the same tags, and it holds the averaged head."""
    _, tm = pair
    fresh = Whisper(ModelDimensions(**DIMS))
    fresh.load_state_dict(tm.state_dict())
    monkeypatch.setattr(wat, "build_model", lambda *a, **k: fresh)
    out = _run(_load("examples/train_pipeline_torch.py", "train_pipeline_torch"),
               ["--root", str(tmp_path), "--epochs", "2", "--device", "cpu"], capsys,
               monkeypatch)
    assert "extracted 24 feature files" in out
    assert re.search(r"weight-averaged mAP over the 6 tone classes: \d\.\d{4}", out)
    assert out.rstrip().endswith("equal: True")
    saved = str(tmp_path / "exp" / "whisper_at_trained.pt")
    reloaded = wat.load_model(saved, device="cpu", dtype=torch.float32)
    head = {k: v for k, v in reloaded.state_dict().items() if k.startswith("at_model.")}
    assert not all(torch.equal(v, tm.state_dict()[k]) for k, v in head.items())
    for k, v in head.items():
        assert torch.equal(v, fresh.state_dict()[k]), k


def test_app_predict_matches_jax(patched, tmp_path, monkeypatch):
    """`app_torch.predict` gives the JAX `predict`'s string, with each
    package's load_model handing out its model of the pair."""
    jm, tm = patched
    monkeypatch.setattr(jwat, "load_model", lambda *a, **k: jm)
    monkeypatch.setattr(wat, "load_model", lambda *a, **k: tm)
    from whisper_at_tpu.research.noisy_speech import write_wav

    t = np.arange(16000 * 12) / 16000.0
    path = str(tmp_path / "a.wav")
    write_wav(path, (0.3 * np.sin(2 * np.pi * 330 * t)).astype(np.float32))
    app, app_torch = _load("app.py", "app"), _load("app_torch.py", "app_torch")
    for res in (10, "3.9", "x"):
        assert app_torch.round_time_res(res) == app.round_time_res(res)
    got = app_torch.predict(path, "tiny", "en", "4")
    assert got == app.predict(path, "tiny", "en", "4")
    assert "[sounds: " in got


def test_serving_and_streaming_examples_run(patched, capsys, monkeypatch):
    monkeypatch.setattr(wat, "transcribe_many", functools.partial(wat.transcribe_many,
                                                                  fp16=False))
    monkeypatch.setattr(wat, "TranscriptionService",
                        functools.partial(wat.TranscriptionService, fp16=False))
    out = _run(_load("examples/serving_torch.py", "serving_torch"),
               ["--synthetic", "2", "--batches", "2", "--random", "--device", "cpu"],
               capsys, monkeypatch)
    assert out.count("file 0: lang=en tags=(") == 2 and "batch 1: 2 files" in out
    out = _run(_load("examples/serving_torch.py", "serving_torch"),
               ["--synthetic", "2", "--batches", "1", "--random", "--service", "--device",
                "cpu"], capsys, monkeypatch)
    assert "service: 2 requests" in out
    out = _run(_load("examples/streaming_demo_torch.py", "streaming_demo_torch"),
               ["--random", "--device", "cpu"], capsys, monkeypatch)
    assert "final: " in out and "tags (4, 527)" in out


def test_train_trajectory_example_runs(patched, tmp_path, capsys, monkeypatch):
    out = _run(_load("examples/train_trajectory_torch.py", "train_trajectory_torch"),
               ["--root", str(tmp_path), "--epochs", "2", "--n-train", "12", "--n-eval", "16",
                "--lr", "1e-3", "--device", "cpu"], capsys, monkeypatch)
    assert "extracted 28 all-layer pooled feature files" in out
    assert re.search(r"wa_model\(epochs 1-2\) mAP \d\.\d{4}", out)


def test_live_http_client_against_the_port_server(patched, capsys, monkeypatch):
    from whisper_at_tpu_torch.serving import TranscriptionService, make_http_server
    from whisper_at_tpu_torch.streaming import StreamingService

    _, tm = patched
    opts = dict(language="en", fp16=False)
    with TranscriptionService(tm, **opts) as svc, StreamingService(tm, **opts) as streams:
        server = make_http_server(svc, "127.0.0.1", 0, stream_service=streams)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            out = _run(_load("examples/live_http_client_torch.py", "live_http_client_torch"),
                       ["--synthetic", "35", "--block-seconds", "5", "--port",
                        str(server.server_address[1]), "--device", "cpu"], capsys, monkeypatch)
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=60)
    assert "== done ==" in out and "language: en" in out


def test_notebook_cells_compile_and_import_only_the_port():
    """The port's notebook: nine code cells that compile and import nothing
    of the JAX package or JAX."""
    with open(os.path.join(ROOT, "examples", "whisper_at_tpu_torch_demo.ipynb")) as f:
        nb = json.load(f)
    cells = ["".join(c["source"]) for c in nb["cells"] if c["cell_type"] == "code"]
    assert len(cells) == 9
    imported = set()
    for i, src in enumerate(cells):
        tree = ast.parse(compile(src, f"cell{i}", "exec", ast.PyCF_ONLY_AST))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                imported |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                imported.add(node.module.split(".")[0])
    assert "whisper_at_tpu_torch" in imported
    assert not imported & {"jax", "jaxlib", "whisper_at_tpu"}


@pytest.mark.parametrize("name", PORTED)
def test_example_flags_are_the_jax_examples_plus_device(name):
    """Each port example takes its JAX example's flags and --device."""
    def flags(path):
        src = open(os.path.join(ROOT, "examples", path)).read()
        return set(re.findall(r'add_argument\(\s*"(--[\w-]+)"', src))

    assert flags(f"{name}_torch.py") == flags(f"{name}.py") | {"--device"}
