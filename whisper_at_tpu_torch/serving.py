"""Continuous-batching transcription service and its HTTP front end.

Counterpart of `whisper_at_tpu/serving.py`. Concurrent callers `submit()`
audio and get a `concurrent.futures.Future`; a scheduler thread packs
requests with the same decode options into shared batches through
`transcribe.transcribe_many` (windows packed across files), holding an
under-full batch open at most `max_wait_s` after each compatible arrival.
Each request's host work (WAV decode, STFT prep) and its copy to the model's
device run in a prep thread pool the moment it is submitted, so copies ride
under the previous batch's decode. Results equal `transcribe_batched` run
file by file.

A standard-library HTTP front end (`make_http_server`, `serve_http`,
`python -m whisper_at_tpu_torch.serving`) serves it as a JSON API:

    POST /v1/transcribe?language=en&tags=5   (body: WAV bytes)
    POST /v1/stream?tags=3                   (body: raw 16 kHz int16 PCM, NDJSON out)
    GET  /healthz                            (service stats)

`http.server.ThreadingHTTPServer` handles connections; each handler thread
waits on its request's future while the scheduler batches across them.

With a mesh (`parallel.mesh.Mesh`) every rank constructs the service with
the same arguments. Rank 0 owns the queue, the scheduler and the HTTP
front end; before each batch it broadcasts the batch's audio and options,
and every other rank makes the same `transcribe_many(mesh=)` call in its
own follower thread (`parallel.inference.follow`). While idle, rank 0
broadcasts a no-op every HEARTBEAT_S, so the followers' waits stay inside
the groups' timeout; `close()` on rank 0 releases them, and `close()` on
another rank returns once it has.
"""

from __future__ import annotations

import io
import json
import os
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError, ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from .audio import SAMPLE_RATE, decode_wav_pcm16, load_audio_pcm16, prefetch_audio
from .ops.mel import HOP_LENGTH, N_FRAMES, N_SAMPLES, PrefetchedAudio
from .parallel.inference import end, follow, heartbeat, lead
from .parallel.mesh import as_mesh
from .transcribe import DEFAULT_MAX_BATCH, _batch_bucket, _serve_prof, transcribe_many

HEARTBEAT_S = 10.0  # rank 0 of a mesh leads a no-op this often while idle


class MeshLink:
    """A service's side of the SPMD protocol over `mesh` (None: no mesh).
    Rank 0 leads each job under one lock, so the jobs of its threads
    (scheduler, warm-up) reach the other ranks in the order it runs them;
    every other rank runs `run(job)` in its follower thread."""

    def __init__(self, mesh):
        self.mesh = None if mesh is None else as_mesh(mesh)
        self.lock = threading.Lock()
        self.error = None

    @property
    def follower(self) -> bool:
        return self.mesh is not None and self.mesh.rank != 0

    def call(self, job: tuple, fn):
        """fn(), after the other ranks have been sent `job`."""
        if self.mesh is None:
            return fn()
        with self.lock:
            self.mesh.bind_thread()
            lead(self.mesh, job)
            return fn()

    def heartbeat(self) -> None:
        with self.lock:
            heartbeat(self.mesh)

    def end(self) -> None:
        if self.mesh is not None and not self.follower:
            with self.lock:
                self.mesh.bind_thread()
                end(self.mesh)

    def follow(self, run) -> None:
        try:
            follow(self.mesh, run)
        except BaseException as exc:  # noqa: BLE001 - raised again by close()
            self.error = exc

    def raise_error(self) -> None:
        if self.error is not None:
            raise RuntimeError(f"mesh rank {self.mesh.rank}: its follower thread "
                               f"failed") from self.error


def portable_audio(audio):
    """A prepared input as it travels to the other ranks: a PrefetchedAudio's
    signal on the host, or the waveform."""
    if isinstance(audio, PrefetchedAudio):
        return ("prefetched", audio.ready().cpu(), audio.n_frames, audio.padding)
    return ("waveform", np.asarray(audio))


def local_audio(item, device):
    """`portable_audio`'s item as this rank's input."""
    if item[0] == "prefetched":
        return PrefetchedAudio(item[1].to(device), item[2], item[3])
    return item[1]


def _canonical_options(options: dict) -> tuple:
    """Hashable identity of a decode-option set, the batching key: requests
    share a batch only when every option matches."""
    return tuple((k, tuple(v) if isinstance(v, (list, tuple)) else v)
                 for k, v in sorted(options.items()))


def _scan_compatible(pending: deque, key, budget: int):
    """One pass over a pending deque: up to `budget` requests whose key
    matches, in order; returns (matches, the rest as a new deque)."""
    cands, keep = [], deque()
    for r in pending:
        if r.key == key and len(cands) < budget:
            cands.append(r)
        else:
            keep.append(r)
    return cands, keep


def _settle(future: Future, *, result=None, exception=None) -> bool:
    """set_result / set_exception that tolerates the caller's concurrent
    cancel() (nothing marks these futures running, so cancel() can win at
    any time before the result lands)."""
    try:
        if exception is not None:
            future.set_exception(exception)
        else:
            future.set_result(result)
        return True
    except InvalidStateError:
        return False


class _Request:
    __slots__ = ("future", "prep", "key", "options", "submitted_at", "windows", "audio")

    def __init__(self, future, prep, key, options):
        self.future = future
        self.prep = prep            # Future[PrefetchedAudio | np.ndarray]
        self.key = key
        self.options = options
        self.submitted_at = time.monotonic()
        self.windows = None         # from the prep, when scheduled
        self.audio = None


def _content_frames(prepped) -> int:
    if isinstance(prepped, PrefetchedAudio):
        return prepped.n_frames - N_FRAMES  # n_frames counts the 30 s tail
    return int(np.asarray(prepped).size) // HOP_LENGTH


def _window_count(prepped) -> int:
    """30 s windows a prepared input adds to a packed batch, as
    `transcribe_many` counts them (zero-content clips decode nothing)."""
    return max(0, -(-_content_frames(prepped) // N_FRAMES))


def _audio_seconds(prepped) -> float:
    if isinstance(prepped, PrefetchedAudio):
        return max(0, _content_frames(prepped)) * HOP_LENGTH / SAMPLE_RATE
    return float(np.asarray(prepped).size) / SAMPLE_RATE


class TranscriptionService:
    """Always-on batching scheduler around `transcribe_many`, on its model's
    device.

    model: a `Whisper` model. max_batch: windows a batch may hold.
    max_wait_s: how long an under-full batch stays open for more compatible
        requests; every compatible arrival extends it by another max_wait_s,
        up to max_total_wait_s (default 10 x max_wait_s) from its first.
    prefetch: prepare each request's audio and start its copy to the
        device in the prep pool at submit time (results are the same off).
    mesh: a `parallel.mesh.Mesh`; construct the service on every rank with
        the same arguments; only rank 0 takes requests (module docstring).
    default_options: decode options of every request, overridable per
        `submit`, e.g. language="en".
    """

    _CLOSED = object()
    _IDLE = object()

    def __init__(self, model, *, max_batch: int = DEFAULT_MAX_BATCH,
                 max_wait_s: float = 0.05, max_total_wait_s: float = None,
                 prefetch: bool = True, prep_workers: int = 4, mesh=None,
                 **default_options):
        self._link = MeshLink(mesh)
        self.mesh = self._link.mesh
        if default_options.get("condition_on_previous_text"):
            raise ValueError("condition_on_previous_text=True serializes windows and "
                             "cannot ride the packed batch path; use transcribe() directly")
        self.model = model
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        self.max_total_wait_s = (10.0 * self.max_wait_s if max_total_wait_s is None
                                 else float(max_total_wait_s))
        self.default_options = dict(default_options)
        self._prefetch = prefetch
        self._pending: deque = deque()
        self._cv = threading.Condition()
        self._closed = False
        self._drain = True          # process the backlog on close(wait=True)
        self._stats_lock = threading.Lock()
        self._stats = dict(requests=0, completed=0, failed=0, batches=0, windows=0,
                           audio_seconds=0.0, busy_s=0.0, max_batch_windows=0)
        # submit-to-result latencies of the latest completions
        self._latencies: deque = deque(maxlen=1024)
        self._prep_pool = ThreadPoolExecutor(max_workers=max(1, prep_workers),
                                             thread_name_prefix="wat-serve-prep")
        if self._link.follower:
            self._thread = threading.Thread(target=self._link.follow, args=(self._run_job,),
                                            name="wat-serve-follower", daemon=True)
        else:
            self._thread = threading.Thread(target=self._scheduler,
                                            name="wat-serve-scheduler", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------ #
    # client surface
    # ------------------------------------------------------------------ #

    def submit(self, audio, **overrides) -> Future:
        """Queue one recording (waveform, WAV path or PrefetchedAudio);
        returns a Future of the `transcribe`-shaped dict."""
        if self._link.follower:
            raise RuntimeError(f"rank {self.mesh.rank} of the mesh takes no requests: "
                               f"submit on rank 0")
        with self._cv:
            if self._closed:
                raise RuntimeError("TranscriptionService is closed")
            options = dict(self.default_options)
            options.update(overrides)
            if options.get("condition_on_previous_text"):
                raise ValueError("condition_on_previous_text=True cannot be served "
                                 "from the packed batch path")
            fut: Future = Future()
            prep = self._prep_pool.submit(self._prep, audio)
            self._pending.append(_Request(fut, prep, _canonical_options(options), options))
            with self._stats_lock:
                self._stats["requests"] += 1
            self._cv.notify()
        return fut

    def transcribe(self, audio, **overrides) -> dict:
        """`submit(...).result()`."""
        return self.submit(audio, **overrides).result()

    def warmup(self, *, buckets=None, clip_seconds: float = 1.0, **overrides) -> dict:
        """Make the first requests pay no build: on the card, compile every
        kernel (`ops.cuda.build_all`), then run `transcribe_many` once with
        k one-window tone clips for each k of the JAX package's batch ladder
        (1, 2, 4, 8, 16, max_batch; the decode itself takes exactly its
        windows) or of `buckets`, under the service's options (`overrides`
        win). Bypasses
        the scheduler, so the stats are untouched. Returns {k: seconds}.
        On a mesh, rank 0's calls drive the other ranks, whose own warmup
        returns {} at once."""
        if self.model.device.type == "cuda":
            from .ops import cuda

            cuda.build_all()
        if self._link.follower:
            return {}
        if buckets is None:
            buckets = sorted({_batch_bucket(n, self.max_batch)
                              for n in range(1, self.max_batch + 1)})
        options = dict(self.default_options)
        options.update(overrides)
        t = np.arange(int(SAMPLE_RATE * clip_seconds)) / SAMPLE_RATE
        took = {}
        for k in buckets:
            clips = [(0.3 * np.sin(2 * np.pi * (220.0 + 5 * i) * t)).astype(np.float32)
                     for i in range(int(k))]
            t0 = time.monotonic()
            self._many(clips, options)
            took[int(k)] = round(time.monotonic() - t0, 3)
        return took

    def stats(self) -> dict:
        with self._stats_lock:
            s = dict(self._stats)
            lats = sorted(self._latencies)
        if lats:
            s["latency_p50_s"] = round(lats[len(lats) // 2], 4)
            s["latency_p95_s"] = round(lats[int(len(lats) * 0.95) if len(lats) > 1 else 0], 4)
            s["latency_max_s"] = round(lats[-1], 4)
        s["pending"] = len(self._pending)
        s["closed"] = self._closed
        return s

    def close(self, wait: bool = True):
        """Stop the service: wait=True serves the backlog first, wait=False
        cancels every request still queued. On a mesh, rank 0 then releases
        the other ranks; another rank returns once rank 0 has closed."""
        with self._cv:
            if self._closed and not self._thread.is_alive():
                return
            self._closed = True
            self._drain = wait
            self._cv.notify_all()
        self._thread.join()
        self._link.end()
        # on abort, drop the prep jobs nobody will read
        self._prep_pool.shutdown(wait=True, cancel_futures=not wait)
        self._link.raise_error()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(wait=not any(exc))

    # ------------------------------------------------------------------ #
    # scheduler
    # ------------------------------------------------------------------ #

    def _many(self, audios, options: dict):
        """`transcribe_many` of one batch; on a mesh, the other ranks are
        sent the batch first and make the same call."""
        job = ("many", [portable_audio(a) for a in audios] if self.mesh else None,
               self.max_batch, options)
        return self._link.call(job, lambda: transcribe_many(
            self.model, audios, max_batch=self.max_batch, mesh=self.mesh, **options))

    def _run_job(self, job) -> None:
        """A follower's part of rank 0's batch."""
        _, items, max_batch, options = job
        transcribe_many(self.model, [local_audio(i, self.mesh.device) for i in items],
                        max_batch=max_batch, mesh=self.mesh, **options)

    def _prep(self, audio):
        """A request's host work. Whatever makes this request invalid raises
        here, failing its own future only, never inside the shared
        transcribe_many call that would fail every request of the batch."""
        if isinstance(audio, PrefetchedAudio):
            if audio.padding != N_SAMPLES:
                raise ValueError(f"PrefetchedAudio was prepared with padding={audio.padding}; "
                                 f"the service needs {N_SAMPLES} (the prefetch_audio default)")
            return audio
        if isinstance(audio, str):
            if self._prefetch:
                return prefetch_audio(audio, device=self.model.device)
            return load_audio_pcm16(audio)
        audio = np.asarray(audio)
        if audio.ndim != 1 or not np.issubdtype(audio.dtype, np.number):
            raise ValueError(f"expected a 1-D numeric waveform, got shape {audio.shape} "
                             f"dtype {audio.dtype}")
        return prefetch_audio(audio, device=self.model.device) if self._prefetch else audio

    def _resolve(self, req: _Request) -> bool:
        """Wait for a request's prep; a failed prep fails its future.
        Returns whether the request can be scheduled."""
        if req.audio is not None:
            return True
        try:
            req.audio = req.prep.result()
        except Exception as exc:  # noqa: BLE001 - delivered to the caller
            # the stats first: a caller that saw its future fail reads them
            with self._stats_lock:
                self._stats["failed"] += 1
            _settle(req.future, exception=exc)
            return False
        req.windows = _window_count(req.audio)
        return True

    def _take_batch(self):
        """The next batch: the head of the queue sets the option group, and
        later compatible requests join until the window budget fills or the
        fill window closes; other requests stay queued, in order. Returns
        (requests, key) or `_CLOSED`."""
        with self._cv:
            while not self._pending:
                if self._closed:
                    return self._CLOSED
                if self.mesh is None:
                    self._cv.wait()
                elif not self._cv.wait(timeout=HEARTBEAT_S):
                    return self._IDLE
            if self._closed and not self._drain:
                while self._pending:
                    self._pending.popleft().future.cancel()
                return self._CLOSED
            head = self._pending.popleft()
        if not self._resolve(head):
            return [], head.key
        batch, windows = [head], head.windows
        hard_deadline = time.monotonic() + self.max_total_wait_s
        deadline = time.monotonic() + self.max_wait_s
        while windows < self.max_batch:
            with self._cv:
                # each live request is at least one window; empty clips ride free
                cands, self._pending = _scan_compatible(self._pending, head.key,
                                                        self.max_batch - windows)
                if not cands:
                    if self._closed:
                        break
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(timeout=remaining)
                    continue
            # an arrival buys the batch another max_wait_s, up to the hard cap
            deadline = min(hard_deadline, time.monotonic() + self.max_wait_s)
            leftovers = []
            for i, nxt in enumerate(cands):
                if windows >= self.max_batch:
                    leftovers = cands[i:]
                    break
                if self._resolve(nxt):
                    batch.append(nxt)
                    windows += nxt.windows
            if leftovers:
                with self._cv:
                    self._pending.extendleft(reversed(leftovers))
        return batch, head.key

    def _scheduler(self):
        prof = _serve_prof
        last_dispatch_end = None
        if self.mesh is not None:
            self.mesh.bind_thread()
        while True:
            t_fill = time.perf_counter()
            taken = self._take_batch()
            if taken is self._CLOSED:
                return
            if taken is self._IDLE:
                self._link.heartbeat()
                continue
            batch, _ = taken
            if not batch:
                continue
            prof.add("sched-fill", time.perf_counter() - t_fill)
            if last_dispatch_end is not None:
                # the scheduler's time between two transcribe_many calls
                prof.add("sched-gap", time.perf_counter() - last_dispatch_end)
            t0 = time.monotonic()
            try:
                results = self._many([r.audio for r in batch], batch[0].options)
            except Exception as exc:  # noqa: BLE001 - delivered to every request of the batch
                with self._stats_lock:
                    self._stats["failed"] += len(batch)
                    self._stats["batches"] += 1
                for r in batch:
                    _settle(r.future, exception=exc)
                continue
            done = time.monotonic()
            last_dispatch_end = time.perf_counter()
            n_windows = sum(r.windows for r in batch)
            with self._stats_lock:
                s = self._stats
                s["completed"] += len(batch)
                s["batches"] += 1
                s["windows"] += n_windows
                s["busy_s"] += done - t0
                s["max_batch_windows"] = max(s["max_batch_windows"], n_windows)
                for r in batch:
                    s["audio_seconds"] += _audio_seconds(r.audio)
                    self._latencies.append(done - r.submitted_at)
            t_settle = time.perf_counter()
            for r, res in zip(batch, results):
                _settle(r.future, result=res)
            prof.add("sched-settle", time.perf_counter() - t_settle)


# -------------------------------------------------------------------------- #
# HTTP front end (standard library only)
# -------------------------------------------------------------------------- #

def _jsonable(obj):
    """numpy and torch leaves, recursively, as JSON-serializable values."""
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        return obj.tolist()
    return obj


# the query parameters the HTTP API takes, by type: an unknown or malformed
# parameter is a 400, never a silent default
_PARAM_TYPES = {
    "language": str,
    "task": str,
    "beam_size": int,
    "best_of": int,
    "patience": float,
    "length_penalty": float,
    "sample_len": int,
    "at_time_res": float,
    "temperature": "floats",
    "word_timestamps": "bool",
    "without_timestamps": "bool",
    "initial_prompt": str,
    "tags": int,          # HTTP only: the top-k parsed tag names
    "tag_language": str,  # HTTP only: the language of the tag names
}
_BOOL_TRUE = {"1", "true", "yes", "on"}
_BOOL_FALSE = {"0", "false", "no", "off"}


def _coerce_params(query: str):
    """A request's query string as (decode_options, http_options)."""
    from urllib.parse import parse_qsl

    options, http = {}, {}
    for k, v in parse_qsl(query, keep_blank_values=True):
        spec = _PARAM_TYPES.get(k)
        if spec is None:
            raise ValueError(f"unknown parameter: {k}")
        try:
            if spec == "bool":
                lv = v.lower()
                if lv in _BOOL_TRUE:
                    val = True
                elif lv in _BOOL_FALSE:
                    val = False
                else:
                    raise ValueError(v)
            elif spec == "floats":
                parts = [float(p) for p in v.split(",") if p != ""]
                if not parts:
                    raise ValueError(v)
                val = parts[0] if len(parts) == 1 else tuple(parts)
            else:
                val = spec(v)
        except ValueError as exc:
            raise ValueError(f"bad value for {k}: {v!r}") from exc
        (http if k in ("tags", "tag_language") else options)[k] = val
    return options, http


def _decode_wav_bytes(body: bytes) -> np.ndarray:
    """A WAV request body as int16 (16-bit mono 16 kHz) or float32 mono at
    16 kHz, as `load_audio_pcm16` reads a file."""
    return decode_wav_pcm16(io.BytesIO(body), SAMPLE_RATE)


def make_http_server(service: TranscriptionService, host: str = "127.0.0.1",
                     port: int = 0, max_body_bytes: int = 512 << 20,
                     path_root: Optional[str] = None, stream_service=None):
    """A ThreadingHTTPServer bound to the service (not yet serving).

    GET /healthz: the service's stats. POST /v1/transcribe: a WAV body, or
    JSON {"path": "file"} under `path_root` (off without one; a path outside
    it is a 403); options in the query string (`_PARAM_TYPES`; `tags=k`
    adds the top-k tag names). POST /v1/stream (with `stream_service`, a
    `streaming.StreamingService`): a raw mono 16 kHz int16 PCM body,
    chunked or not; segments come back as NDJSON lines as each 30 s window
    is finalized, then a {"done": true, ...} summary. A body over
    `max_body_bytes` is a 413, unread."""
    root = os.path.realpath(path_root) if path_root else None
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from .at_post_processing import parse_at_label

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 for chunked responses on /v1/stream; every other
        # response carries Content-Length, so keep-alive works
        protocol_version = "HTTP/1.1"

        def _send(self, code: int, payload: dict, close: bool = False):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if close:
                self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(body)

        def _send_early_error(self, code: int, payload: dict):
            """An error sent before the body was read: under keep-alive the
            unread body would parse as the next request, so the connection
            is closed, and the client told so."""
            self.close_connection = True
            self._send(code, payload, close=True)

        def log_message(self, fmt, *args):  # quiet
            pass

        def do_GET(self):
            if self.path.split("?")[0] == "/healthz":
                payload = dict(status="ok", **service.stats())
                if stream_service is not None:
                    payload["stream"] = stream_service.stats()
                self._send(200, payload)
            else:
                self._send(404, {"error": "not found"})

        def _iter_request_body(self):
            """The body's pieces as they arrive (chunked or plain)."""
            te = (self.headers.get("Transfer-Encoding") or "").lower()
            total = 0
            if "chunked" in te:
                while True:
                    line = self.rfile.readline(1024)
                    if not line.endswith(b"\n"):
                        raise ValueError("chunk-size line too long")
                    size = int(line.strip().split(b";")[0], 16)
                    if size == 0:
                        while True:  # trailers, up to the blank line
                            tail = self.rfile.readline(1024)
                            if tail in (b"\r\n", b"\n", b""):
                                return
                    total += size
                    if total > max_body_bytes:
                        raise ValueError("body exceeds max_body_bytes")
                    data = self.rfile.read(size)
                    self.rfile.read(2)  # the chunk's CRLF
                    yield data
            else:
                remaining = int(self.headers.get("Content-Length", 0))
                if remaining > max_body_bytes:
                    raise ValueError("body exceeds max_body_bytes")
                while remaining > 0:
                    piece = self.rfile.read(min(65536, remaining))
                    if not piece:
                        return
                    remaining -= len(piece)
                    yield piece

        def _write_chunk(self, payload: dict):
            data = json.dumps(payload).encode() + b"\n"
            self.wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")
            self.wfile.flush()

        def _tags(self, result, http_opts):
            return _jsonable(parse_at_label(result, top_k=http_opts["tags"],
                                            language=http_opts.get("tag_language",
                                                                   "follow_asr")))

        def _do_stream(self, query: str):
            if stream_service is None:
                self._send_early_error(404, {"error": "streaming is not enabled on this "
                                                      "server"})
                return
            try:
                options, http_opts = _coerce_params(query)
            except ValueError as exc:
                self._send_early_error(400, {"error": str(exc)})
                return
            ctype = (self.headers.get("Content-Type") or "").split(";")[0]
            if ctype not in ("", "audio/pcm16", "application/octet-stream"):
                self._send_early_error(415, {"error": "stream body must be raw mono 16 kHz "
                                                      "int16 PCM (audio/pcm16)"})
                return
            try:
                sess = stream_service.open(**options)
            except (TypeError, ValueError, RuntimeError) as exc:
                self._send_early_error(400, {"error": str(exc)})
                return
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            emitted = 0
            try:
                carry = b""
                for piece in self._iter_request_body():
                    carry += piece
                    usable = len(carry) & ~1  # whole int16 samples only
                    if not usable:
                        continue
                    pcm = np.frombuffer(carry[:usable], np.int16)
                    carry = carry[usable:]
                    for seg in sess.feed(pcm):
                        emitted += 1
                        self._write_chunk(_jsonable(seg))
                result = sess.finish()
                for seg in result["segments"][emitted:]:
                    self._write_chunk(_jsonable(seg))
                summary = dict(done=True, text=result["text"], language=result["language"])
                if http_opts.get("tags"):
                    summary["audio_tags"] = self._tags(result, http_opts)
                self._write_chunk(summary)
            except Exception as exc:  # noqa: BLE001 - the headers are sent already
                # the request's framing may be lost mid-body: never reuse
                # the connection after an error
                self.close_connection = True
                try:
                    self._write_chunk({"error": str(exc)})
                except OSError:
                    pass  # the client is gone
            finally:
                try:
                    self.wfile.write(b"0\r\n\r\n")
                    self.wfile.flush()
                except OSError:
                    pass

        def do_POST(self):
            path, _, query = self.path.partition("?")
            if path == "/v1/stream":
                self._do_stream(query)
                return
            if path != "/v1/transcribe":
                self._send_early_error(404, {"error": "not found"})
                return
            try:
                options, http_opts = _coerce_params(query)
            except ValueError as exc:
                self._send_early_error(400, {"error": str(exc)})
                return
            length = int(self.headers.get("Content-Length", 0))
            if length > max_body_bytes:
                self._send_early_error(413, {"error": f"body exceeds {max_body_bytes} bytes"})
                return
            body = self.rfile.read(length)
            ctype = (self.headers.get("Content-Type") or "").split(";")[0]
            try:
                if ctype == "application/json":
                    audio = json.loads(body)["path"]
                    if root is None:
                        self._send(403, {"error": "path mode is disabled (server started "
                                                  "without a path root)"})
                        return
                    real = os.path.realpath(os.path.join(root, audio))
                    if not (real == root or real.startswith(root + os.sep)):
                        self._send(403, {"error": "path outside the served root"})
                        return
                    audio = real
                else:
                    audio = _decode_wav_bytes(body)
            except Exception as exc:  # noqa: BLE001 - a client error
                self._send(400, {"error": f"bad audio payload: {exc}"})
                return
            try:
                result = service.transcribe(audio, **options)
            except Exception as exc:  # noqa: BLE001 - surfaced as a 500
                self._send(500, {"error": str(exc)})
                return
            payload = _jsonable(result)
            if http_opts.get("tags"):
                payload["audio_tags"] = self._tags(result, http_opts)
            self._send(200, payload)

    return ThreadingHTTPServer((host, port), Handler)


def serve_http(service: TranscriptionService, host: str = "127.0.0.1", port: int = 8080,
               path_root: Optional[str] = None, stream_service=None):
    """Run the HTTP front end until interrupted."""
    server = make_http_server(service, host, port, path_root=path_root,
                              stream_service=stream_service)
    try:
        server.serve_forever()
    finally:
        server.server_close()


def main(argv=None):
    """The server on the card: `--model` is a size name with `--random`
    (seeded random bf16 weights), else a local checkpoint file for
    `load_model`. Nothing is fetched."""
    import argparse

    from . import build_model, load_model
    from .streaming import StreamingService

    parser = argparse.ArgumentParser(description="whisper-at batching transcription server "
                                                 "(PyTorch/CUDA)")
    parser.add_argument("--model", default="tiny",
                        help="a size name with --random, else a local checkpoint file")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--max-batch", type=int, default=DEFAULT_MAX_BATCH)
    parser.add_argument("--max-wait-ms", type=float, default=50.0)
    parser.add_argument("--max-total-wait-ms", type=float, default=None,
                        help="cap of the rolling batch fill (default 10x --max-wait-ms)")
    parser.add_argument("--language", default=None)
    parser.add_argument("--random", action="store_true",
                        help="seeded random weights of the --model size")
    parser.add_argument("--allow-paths", default=None, metavar="DIR",
                        help="allow the JSON {'path': ...} request mode, confined to files "
                             "under DIR (off by default)")
    parser.add_argument("--warmup", type=int, default=0, metavar="N",
                        help="before serving: build the kernels, run the batch ladder and "
                             "N concurrent streaming sessions (0 = off)")
    args = parser.parse_args(argv)

    model = (build_model(args.model, device="cuda", dtype=torch.bfloat16, seed=0)
             if args.random else load_model(args.model, device="cuda"))
    options = {"language": args.language} if args.language else {}
    waits = dict(max_wait_s=args.max_wait_ms / 1000.0,
                 max_total_wait_s=(None if args.max_total_wait_ms is None
                                   else args.max_total_wait_ms / 1000.0))
    with TranscriptionService(model, max_batch=args.max_batch, **waits, **options) as service, \
            StreamingService(model, max_batch=args.max_batch, **waits,
                             **options) as stream_service:
        if args.warmup > 0:
            t0 = time.monotonic()
            took = service.warmup()
            stream_took = stream_service.warmup(args.warmup)
            print(f"warmup: batch ladder {took}, {stream_took['sessions']} streaming sessions "
                  f"in {stream_took['seconds']}s (total {time.monotonic() - t0:.1f}s)",
                  flush=True)
        print(f"serving {args.model} on http://{args.host}:{args.port} "
              f"(max_batch={args.max_batch}, {torch.cuda.get_device_name(0)})", flush=True)
        serve_http(service, args.host, args.port, path_root=args.allow_paths,
                   stream_service=stream_service)


if __name__ == "__main__":
    main()
