"""The port's profilers (`tools/profile_{pipeline,decode,service,serving,
streaming}_torch.py`) run their --cpu smoke at tiny, in this process, at the
smallest counts that reach every stage, and print the JAX tools' row names
(and, for serving and streaming, the port's StageProf stage names) and the
line that says the run had no device."""

import contextlib
import importlib.util
import io
import os

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """These models are tiny: the port's passes run on two threads, which
    keeps the file's time steady when other test processes share the
    cores (a full thread pool per process oversubscribes them) and halves
    the service and streaming smokes' time against one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_DEVICE = "device: none (a CPU run"
SERVE_STAGES = ("frontend-mel", "detect", "decode", "tag-dispatch", "assembly", "tag-commit",
                "emit", "sched-fill", "sched-settle", "sched-gap")
SESSION_STAGES = ("feed-normalize", "window-join", "decode-wait", "parse-segments",
                  "tags-drain")
SCHEDULER_STAGES = ("prep-h2d", "sched-materialize", "sched-decode", "sched-tags")

CASES = {
    "pipeline": (["--batch", "1", "--tokens", "4", "--iters", "1"],
                 ["full pipeline:", "mel (incl. H2D):", "encoder+taps (batch 1):",
                  "DecodingTask.run (incl. encoder):", "decode alone ~",
                  "stages inside one call: mel_s", NO_DEVICE]),
    "decode": (["--batch", "1", "--steps", "2", "--iters", "1", "--layout", "heads",
                "--kv-bits", "4"],
               ["int4 cross K/V in the port's one layout (--layout heads is an alias)",
                "4L + logits:", "4L no logits:", "2L no logits:", "1L no logits:", "ms/step",
                "per-layer marginal", "fixed remainder", "weights", "crossKV", "selfKV",
                "emb", "speed-of-light: no memory rate known for cpu", NO_DEVICE]),
    "service": (["--batch", "1", "--tokens", "4", "--iters", "1"],
                ["direct:  times", "service: times", "service/direct:", NO_DEVICE]),
    "serving": (["--batch", "1", "--tokens", "4", "--iters", "1"],
                ["offline packed:", "window throughput", "audio-s/s", "padding multiplier",
                 "per-stage totals", *SERVE_STAGES, NO_DEVICE]),
    "streaming": (["--minutes", "0.6", "--sample-len", "4", "--host-prof", "--streams", "2"],
                  ["2 stream(s), 0.6 min each", "service:", "window-finalize latency: p50",
                   "real-time headroom", "host-work profile", *SESSION_STAGES,
                   *SCHEDULER_STAGES, NO_DEVICE]),
}


def _tool(name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tools", name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("case", list(CASES))
def test_profiler_cpu_smoke(case):
    argv, rows = CASES[case]
    tool = _tool(f"profile_{case.split('-')[0]}_torch")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tool.main(["--size", "tiny", "--cpu", *argv]) == 0
    text = out.getvalue()
    assert text.startswith("card: none (CPU run)")
    missing = [row for row in rows if row not in text]
    assert not missing, (missing, text)
