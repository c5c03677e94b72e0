"""Profiling and tracing hooks: a device trace of a block, named regions in
it, a synchronizing step timer, and `StageProf`, the environment-gated
per-stage accumulator the serving and streaming paths report through.

Counterpart of `whisper_at_tpu/utils/profiling.py` on `torch.profiler`.
`StageProf` takes a lock around every update: the serving scheduler and the
streaming sessions record from several threads at once.
"""

import contextlib
import os
import threading
import time
from typing import Optional

import torch


@contextlib.contextmanager
def device_trace(logdir: str):
    """A `torch.profiler` trace (CPU, and CUDA when there is a card) of the
    enclosed block, written to `logdir/trace.json` (Perfetto, chrome://tracing)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named region that shows up in device traces."""
    with torch.profiler.record_function(name):
        yield


class StepTimer:
    """Wall-clock step timer; with `sync`, each step ends when the card has
    finished its queued work."""

    def __init__(self, sync: bool = True):
        self.sync = sync
        self.times = []
        self._start: Optional[float] = None

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync and torch.cuda.is_available():
            torch.cuda.synchronize()
        self.times.append(time.perf_counter() - self._start)

    @property
    def avg(self) -> float:
        return sum(self.times) / len(self.times) if self.times else 0.0

    @property
    def best(self) -> float:
        return min(self.times) if self.times else 0.0


class StageProf:
    """Per-stage wall and CPU time, on when the environment variable
    `env_var` is "1" at construction (else every call is a nullcontext):
    ``with prof("stage"):`` around a stage, or ``prof.add(name, seconds)``
    for an interval timed elsewhere. ``snapshot()`` returns {stage:
    {wall_ms, cpu_ms, count, wall_us_each}}. Safe to use from many threads."""

    def __init__(self, env_var: str):
        self.enabled = os.environ.get(env_var) == "1"
        self._acc: dict = {}  # name -> [wall_s, cpu_s, count]
        self._lock = threading.Lock()

    def _record(self, name, wall_s: float, cpu_s: float) -> None:
        with self._lock:
            rec = self._acc.setdefault(name, [0.0, 0.0, 0])
            rec[0] += wall_s
            rec[1] += cpu_s
            rec[2] += 1

    @contextlib.contextmanager
    def _cm(self, name):
        w0 = time.perf_counter()
        c0 = time.thread_time()
        try:
            yield
        finally:
            self._record(name, time.perf_counter() - w0, time.thread_time() - c0)

    def __call__(self, name):
        return self._cm(name) if self.enabled else contextlib.nullcontext()

    def add(self, name, wall_s: float, cpu_s: float = 0.0) -> None:
        """Record an interval timed elsewhere (e.g. a gap between calls)."""
        if self.enabled:
            self._record(name, wall_s, cpu_s)

    def snapshot(self, reset: bool = True) -> dict:
        with self._lock:
            out = {k: dict(wall_ms=round(v[0] * 1e3, 1), cpu_ms=round(v[1] * 1e3, 1),
                           count=v[2], wall_us_each=round(v[0] / max(v[2], 1) * 1e6, 1))
                   for k, v in self._acc.items()}
            if reset:
                self._acc.clear()
        return out
