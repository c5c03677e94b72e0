"""Streaming transcription: audio in as it arrives, segments out as each
30 s window is finalized.

Counterpart of `whisper_at_tpu/streaming.py`. A `StreamingTranscriber`
session takes waveform pieces of any size and runs `transcribe`'s seek loop
over them (the quality-gated temperature ladder, the seek moved by the
decoded timestamps, prompt threading, the TL-TR tags stitched into a grid
that grows with the stream). A `StreamingService` batches the windows of
many sessions, fed from their own threads, through one scheduler: their
mels, decodes, tag passes and first-window language detections each run as
one batch at the exact number of rows.

A window's mel is computed from the samples with a two-frame margin, so
every frame the decoder reads is the offline full-file mel's frame. The one
difference from the offline `transcribe` is the 8-dB floor of the log-mel:
offline it is taken under the recording's maximum, here under the window's,
so a window whose loudest frame is within 8 decades of the recording's
maximum gets the offline mel exactly.
"""

import math
import threading
import time
import warnings
from collections import deque
from concurrent.futures import Future
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from .audio import HOP_LENGTH, N_FFT, N_FRAMES, N_SAMPLES, SAMPLE_RATE, log_mel_spectrogram
from .decoding import detect_language
from .ops.mel import mel_stream_pieces, prefetch_stft_input
from .segmentation import (
    N_TAG_CLASSES,
    QualityGate,
    TagGrid,
    clear_degenerate,
    parse_window,
    segment_record,
)
from .serving import HEARTBEAT_S, MeshLink, _canonical_options, _scan_compatible, _settle
from .timing import APPEND_PUNCTUATIONS, PREPEND_PUNCTUATIONS
from .tokenizer import get_tokenizer
from .transcribe import (
    _attach_word_timings,
    _decode_windows_batched,
    _geometry,
    _resolve_language,
    _run_ladder,
    print_segment,
)
from .utils.profiling import StageProf

# the alignment margin: two whole hops (at least the STFT's 200-sample half
# window, on the recording's frame grid)
_MARGIN_FRAMES = 2
_MARGIN = _MARGIN_FRAMES * HOP_LENGTH
assert _MARGIN >= N_FFT // 2

# WHISPER_AT_TPU_STREAM_PROF=1: wall and CPU time of each stage of the
# sessions (feed-normalize, window-join, prep-h2d, decode-wait,
# parse-segments, tags-drain) and of the service's scheduler
# (sched-materialize, sched-decode, sched-tags)
_stream_prof = StageProf("WHISPER_AT_TPU_STREAM_PROF")
# tag passes a session keeps in flight before it waits for the oldest
TAGS_IN_FLIGHT = 8


def prof_snapshot(reset: bool = True) -> dict:
    """{stage: {wall_ms, cpu_ms, count, wall_us_each}} of the streaming stages."""
    return _stream_prof.snapshot(reset)


class _GrowingTagGrid(TagGrid):
    """A TagGrid over a recording whose length is not known yet."""

    def __init__(self, at_time_res: float):
        super().__init__(content_frames=1, at_time_res=at_time_res)

    def _grow(self, n: int) -> None:
        if n > self.logits.shape[0]:
            grow = np.zeros((n - self.logits.shape[0], N_TAG_CLASSES), np.float32)
            self.logits = np.concatenate([self.logits, grow], axis=0)

    def write(self, seek: int, tags: np.ndarray) -> None:
        self._grow(math.floor(seek / self.window) + tags.shape[0])
        super().write(seek, tags)

    def finalize(self, content_frames: int) -> np.ndarray:
        n = max(1, math.ceil(content_frames / self.window))
        self._grow(n)
        return self.logits[:n]


def _tags_event(tags: torch.Tensor):
    """An event after a tag pass on the card (None on the CPU), so the
    session can ask whether the logits are ready without waiting."""
    if not tags.is_cuda:
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(tags.device))
    return event


class StreamingTranscriber:
    """A transcribe-and-tag session over a live 16 kHz mono stream.

    >>> sess = StreamingTranscriber(model, language="en")
    >>> for block in microphone_blocks():        # any block sizes
    ...     for seg in sess.feed(block):         # finalized segments
    ...         print(seg["start"], seg["text"])
    >>> result = sess.finish()                   # transcribe()'s dict

    feed() runs every complete 30 s window the buffer holds and returns the
    segments it finalized; finish() runs the rest (padded with silence, as
    the offline seek loop's last window is) and returns the whole result.
    With word_timestamps=True each window's segments get word timings when
    it is finalized, as `transcribe_batched` gives them: the seek is not
    moved to the last word's end, which would re-read frames a live stream
    has already dropped.
    """

    def __init__(
        self,
        model,
        *,
        verbose: Optional[bool] = None,
        temperature: Union[float, Tuple[float, ...]] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
        compression_ratio_threshold: Optional[float] = 2.4,
        logprob_threshold: Optional[float] = -1.0,
        no_speech_threshold: Optional[float] = 0.6,
        condition_on_previous_text: bool = True,
        initial_prompt: Optional[str] = None,
        at_time_res: float = 10,
        word_timestamps: bool = False,
        prepend_punctuations: str = PREPEND_PUNCTUATIONS,
        append_punctuations: str = APPEND_PUNCTUATIONS,
        decode_executor=None,
        detect_executor=None,
        **decode_options,
    ):
        self.word_timestamps = word_timestamps
        self.prepend_punctuations = prepend_punctuations
        self.append_punctuations = append_punctuations
        if word_timestamps and decode_options.get("task") == "translate":
            warnings.warn("Word-level timestamps on translations may not be reliable.",
                          stacklevel=2)
        # set by StreamingService: window decodes (with their mel and tag
        # passes) and first-window language detection go through its
        # scheduler; None runs them in this session's thread
        self._decode_executor = decode_executor
        self._detect_executor = detect_executor
        self.model = model
        self.verbose = verbose
        self.temperature = temperature
        self.at_time_res = at_time_res
        self.condition_on_previous_text = condition_on_previous_text
        self.decode_options = dict(decode_options)
        self.gate = QualityGate(compression_ratio_threshold, logprob_threshold,
                                no_speech_threshold)
        self.grid = _GrowingTagGrid(at_time_res)

        self._tokenizer = None
        self._language = decode_options.get("language")
        self._input_stride, self._time_precision = _geometry(model)

        self._initial_prompt = initial_prompt
        self._prompt_tokens: List[int] = []
        self._thread: List[int] = []
        self._thread_live_from = 0

        self._buf = np.zeros((0,), np.float32)
        self._pending: List[np.ndarray] = []  # fed, not yet joined to _buf
        # (seek, tags on the device, event) of each window: read back when
        # ready, in seek order, and at finish()
        self._tags_in_flight: deque = deque()
        self._buf_start = 0          # absolute sample index of _buf[0]
        self._total_samples = 0      # samples received
        self._seek = 0               # absolute mel-frame seek
        self.segments: List[dict] = []
        self._finished = False

    # ------------------------------------------------------------------ #
    # public API
    # ------------------------------------------------------------------ #

    def feed(self, waveform: np.ndarray) -> List[dict]:
        """Append a waveform piece; run every complete 30 s window."""
        if self._finished:
            raise RuntimeError("session already finished")
        with _stream_prof("feed-normalize"):
            chunk = np.asarray(waveform)
            if chunk.ndim != 1:
                raise ValueError(f"expected mono 16 kHz waveform, got shape {chunk.shape}")
            if chunk.dtype == np.int16:
                chunk = chunk.astype(np.float32) / 32768.0
            elif not np.issubdtype(chunk.dtype, np.floating):
                # other PCM widths have other full scales: a bare cast would
                # feed the mel samples of +-2^31
                raise ValueError(f"unsupported waveform dtype {chunk.dtype}; feed float "
                                 "waveforms in [-1, 1] or int16 PCM")
            else:
                chunk = chunk.astype(np.float32)
            self._pending.append(chunk)
            self._total_samples += len(chunk)

        emitted: List[dict] = []
        # a window that is not the last needs samples through the end of
        # the last STFT frame it reads
        while self._total_samples >= (self._seek + N_FRAMES) * HOP_LENGTH + _MARGIN:
            emitted.extend(self._process_window(final=False))
        self._drop_consumed()
        return emitted

    def finish(self) -> dict:
        """Run the buffered tail and return transcribe()'s dict."""
        if self._finished:
            raise RuntimeError("session already finished")
        self._finished = True
        content_frames = self._total_samples // HOP_LENGTH
        while self._seek < content_frames:
            self.segments.extend(self._process_window(final=True))

        if self._tokenizer is None:
            # no window ran (an empty or sub-hop stream): the language comes
            # from the received samples' first window padded with 30 s of
            # silence, as offline
            self._join_pending()
            audio = self._buf if self._buf.size else np.zeros((1,), np.float32)
            first = log_mel_spectrogram(audio, padding=N_SAMPLES,
                                        device=self.model.device)[:, :N_FRAMES]
            self._language = _resolve_language(self.model, first, self.decode_options,
                                               self.verbose, detect_fn=self._detect_executor)
            text = ""
        else:
            text = self._tokenizer.decode(self._thread[len(self._prompt_tokens):])
        while self._tags_in_flight:
            self._write_oldest_tags()
        return dict(text=text, segments=self.segments, language=self._language,
                    at_time_res=self.at_time_res,
                    audio_tag=self.grid.finalize(content_frames))

    # ------------------------------------------------------------------ #
    # internals
    # ------------------------------------------------------------------ #

    def _join_pending(self) -> None:
        # fed pieces are joined at window boundaries only, so a feed() costs
        # its own piece, not the retained buffer
        if self._pending:
            self._buf = np.concatenate([self._buf] + self._pending)
            self._pending = []

    def _window_piece(self) -> Tuple[np.ndarray, int]:
        """(samples, lead margin frames) of the window at the seek: the
        window with a two-frame margin on each side, so every frame the
        decoder reads has its true neighbours; past the received samples,
        silence, as transcribe()'s 30 s tail."""
        self._join_pending()
        s0 = self._seek * HOP_LENGTH
        lead_frames = min(_MARGIN_FRAMES, self._seek)
        start = s0 - lead_frames * HOP_LENGTH
        end = s0 + N_FRAMES * HOP_LENGTH + _MARGIN
        piece = self._buf[start - self._buf_start:end - self._buf_start]
        if len(piece) < end - start:
            piece = np.concatenate([piece, np.zeros(end - start - len(piece), np.float32)])
        return piece, lead_frames

    def _piece_mel(self, piece: np.ndarray, lead_frames: int) -> torch.Tensor:
        """[80, N_FRAMES] mel of a window's piece, computed here: the
        service's batched mel at one row."""
        p = prefetch_stft_input(piece, 0, self.model.device)
        n_valid = torch.tensor([p.n_frames], device=p.device)
        return mel_stream_pieces(p.ready()[None], n_valid, lead_frames)[0]

    def _window_mel(self) -> torch.Tensor:
        """[80, N_FRAMES] mel of the window at the current seek."""
        return self._piece_mel(*self._window_piece())

    def _process_window(self, final: bool) -> List[dict]:
        with _stream_prof("window-join"):
            piece, lead_frames = self._window_piece()
        # the mel is made here when the session decodes inline, aligns
        # words, or detects the language from this first window; otherwise
        # the service makes it, batched with the other sessions' windows
        needs_lang_mel = (self._tokenizer is None and self._language is None
                          and self.model.is_multilingual)
        window = None
        if self._decode_executor is None or self.word_timestamps or needs_lang_mel:
            window = self._piece_mel(piece, lead_frames)
        content_frames = (self._total_samples // HOP_LENGTH if final
                          else self._seek + N_FRAMES)
        segment_size = min(N_FRAMES, content_frames - self._seek)
        time_offset = float(self._seek * HOP_LENGTH / SAMPLE_RATE)

        if self._tokenizer is None:
            self._language = _resolve_language(self.model, window, self.decode_options,
                                               self.verbose, detect_fn=self._detect_executor)
            self._tokenizer = get_tokenizer(self.model.is_multilingual, language=self._language,
                                            task=self.decode_options.get("task", "transcribe"))
            if self._initial_prompt is not None:
                self._prompt_tokens = self._tokenizer.encode(" " + self._initial_prompt.strip())
                self._thread = list(self._prompt_tokens)

        self.decode_options["prompt"] = self._thread[self._thread_live_from:]
        offset = self.grid.offset_in_window(self._seek)
        if self._decode_executor is not None:
            prepped = None
            if window is None:
                # the host prep and the start of the copy run in this
                # (client) thread; the scheduler only stacks the signals
                with _stream_prof("prep-h2d"):
                    prepped = (prefetch_stft_input(piece, 0, self.model.device), lead_frames)
            with _stream_prof("decode-wait"):
                result, tags = self._decode_executor(
                    window, dict(self.decode_options), self.temperature, self.gate,
                    piece=prepped, at_offset=offset, at_time_res=self.at_time_res)
        else:
            with _stream_prof("decode-wait"), torch.no_grad():
                result = _run_ladder(lambda opts: self.model.decode(window, opts),
                                     self.temperature, self.gate, self.decode_options)
                tags = self.model.at_forward(result.audio_features_for_at[:, offset:],
                                             self.at_time_res)
        self._tags_in_flight.append((self._seek, tags, _tags_event(tags)))

        if self.gate.is_silence(result):
            self._seek += segment_size
            return []

        window_start = self._seek
        with _stream_prof("parse-segments"):
            parse = parse_window(
                np.asarray(result.tokens, np.int64),
                timestamp_begin=self._tokenizer.timestamp_begin, time_offset=time_offset,
                segment_size=segment_size,
                segment_duration=segment_size * HOP_LENGTH / SAMPLE_RATE,
                input_stride=self._input_stride, time_precision=self._time_precision)
            # a degenerate decode (a closing timestamp pair at <|0.00|>)
            # parses to advance 0; offline that re-decodes the window once,
            # a live session would spin: move past the window instead
            self._seek += parse.advance_frames if parse.advance_frames > 0 else segment_size
            new_segments = [
                segment_record(seek=window_start, start=start, end=end, tokens=toks,
                               result=result, eot=self._tokenizer.eot,
                               tokenizer=self._tokenizer)
                for start, end, toks in parse.pieces]
        if self.word_timestamps and new_segments:
            with torch.no_grad():
                _attach_word_timings(self.model, self._tokenizer, new_segments, window,
                                     segment_size, self.prepend_punctuations,
                                     self.append_punctuations)
        clear_degenerate(new_segments)
        base_id = (self.segments[-1]["id"] + 1) if self.segments else 0
        for i, seg in enumerate(new_segments):
            seg["id"] = base_id + i
            self._thread.extend(seg["tokens"])
            if self.verbose:
                print_segment(seg)
        if not final:
            self.segments.extend(new_segments)
        if not self.condition_on_previous_text or result.temperature > 0.5:
            self._thread_live_from = len(self._thread)
        return new_segments

    def _write_oldest_tags(self) -> None:
        seek, tags, _ = self._tags_in_flight.popleft()
        self.grid.write(seek, tags.float().cpu().numpy())

    def _drop_consumed(self) -> None:
        """Release the samples no window can read again, and write the tag
        logits that are ready (in seek order), without waiting unless more
        than TAGS_IN_FLIGHT are in flight."""
        with _stream_prof("tags-drain"):
            keep_from = max(self._buf_start, self._seek * HOP_LENGTH - _MARGIN)
            if keep_from > self._buf_start:
                self._buf = self._buf[keep_from - self._buf_start:]
                self._buf_start = keep_from
            while self._tags_in_flight:
                event = self._tags_in_flight[0][2]
                ready = event is None or event.query()
                if not ready and len(self._tags_in_flight) <= TAGS_IN_FLIGHT:
                    break
                self._write_oldest_tags()


# -------------------------------------------------------------------------- #
# the service: windows of many sessions in shared batches
# -------------------------------------------------------------------------- #

class _DecodeRequest:
    __slots__ = ("window", "piece", "key", "options", "temperature", "gate", "future",
                 "at_offset", "at_time_res")

    def __init__(self, window, key, options, temperature, gate, future, piece=None,
                 at_offset=None, at_time_res=None):
        self.window = window          # [80, N_FRAMES] mel, or None with
        self.piece = piece            # (PrefetchedAudio, lead frames) instead
        self.key = key
        self.options = options
        self.temperature = temperature
        self.gate = gate
        self.future = future
        # set: the scheduler also runs the tag pass and resolves (result, tags)
        self.at_offset = at_offset
        self.at_time_res = at_time_res


class _DetectRequest:
    """A first window's language detection; all share one key, so sessions
    that start together get one batched `detect_language`."""

    __slots__ = ("window", "key", "future")
    KEY = ("__detect_language__",)

    def __init__(self, window, future):
        self.window = window          # [80, N_FRAMES] mel
        self.key = _DetectRequest.KEY
        self.future = future


class StreamingService:
    """Many live streams on one device at batch efficiency.

    Each session (`open()`) is fed from its own thread; when several
    finalize windows near the same time, the scheduler decodes them as one
    batch through `transcribe._decode_windows_batched`, with the same
    quality ladder. The windows' mels (from the prepared samples), the tag
    passes (one per offset and resolution) and first-window language
    detections are batched too, each at its exact row count. Batching never
    changes a window's result, but it needs windows without a prompt, so
    sessions run with condition_on_previous_text=False. Segmentation, tag
    stitching and word alignment stay in the session's thread.

    >>> service = StreamingService(model)
    >>> sess = service.open(language="en")      # one per client connection
    >>> segs = sess.feed(block)                 # from the client's thread
    >>> service.close()

    With a mesh (`parallel.mesh.Mesh`), every rank constructs the service
    with the same arguments; rank 0 opens the sessions and runs the
    scheduler, and before each decode or detection batch it broadcasts the
    batch's windows and options, for which every other rank makes the same
    call in its follower thread (`serving.MeshLink`, as the
    TranscriptionService does).
    """

    _CLOSED = object()
    _IDLE = object()

    def __init__(self, model, *, max_batch: int = 24, max_wait_s: float = 0.02,
                 max_total_wait_s: float = None, mesh=None, **session_defaults):
        self._link = MeshLink(mesh)
        self.mesh = self._link.mesh
        self._session_defaults = dict(session_defaults)
        self.model = model
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        # the rolling fill window's cap (see _take_batch)
        self.max_total_wait_s = (10.0 * self.max_wait_s if max_total_wait_s is None
                                 else float(max_total_wait_s))
        self._pending = deque()
        self._cv = threading.Condition()
        self._closed = False
        self._stats_lock = threading.Lock()
        self._stats = dict(sessions=0, windows=0, batches=0, max_batch_windows=0,
                           mel_batched_windows=0, tag_groups=0, detect_windows=0,
                           detect_batches=0)
        if self._link.follower:
            self._thread = threading.Thread(target=self._link.follow, args=(self._run_job,),
                                            name="wat-stream-follower", daemon=True)
        else:
            self._thread = threading.Thread(target=self._scheduler,
                                            name="wat-stream-scheduler", daemon=True)
        self._thread.start()

    def open(self, **session_options) -> StreamingTranscriber:
        """A session whose windows ride the shared batches."""
        if self._link.follower:
            raise RuntimeError(f"rank {self.mesh.rank} of the mesh opens no sessions: "
                               f"open them on rank 0")
        session_options = {**self._session_defaults, **session_options}
        if session_options.get("condition_on_previous_text"):
            raise ValueError("condition_on_previous_text=True threads a per-stream prompt "
                             "into every window and cannot be batched across sessions; "
                             "use a standalone StreamingTranscriber for that")
        session_options["condition_on_previous_text"] = False
        with self._cv:
            if self._closed:
                raise RuntimeError("StreamingService is closed")
        with self._stats_lock:
            self._stats["sessions"] += 1
        return StreamingTranscriber(self.model, decode_executor=self._decode,
                                    detect_executor=self._detect, **session_options)

    def warmup(self, n: int = 8, *, seconds: float = 32.0, **session_options) -> dict:
        """Make the first streams pay no build: on the card, compile every
        kernel, then drive n concurrent synthetic sessions of `seconds` to
        the end. Returns {"sessions": n, "seconds": wall}; their windows
        stay in the stats."""
        if self.model.device.type == "cuda":
            from .ops import cuda

            cuda.build_all()
        if self._link.follower:
            return {"sessions": 0, "seconds": 0.0}
        t = np.arange(int(SAMPLE_RATE * seconds)) / SAMPLE_RATE
        waves = [(0.3 * np.sin(2 * np.pi * (220.0 + 10 * i) * t)).astype(np.float32)
                 for i in range(int(n))]
        sessions = [self.open(**session_options) for _ in waves]
        errors = []

        def drive(sess, wave):
            try:
                sess.feed(wave)
                sess.finish()
            except Exception as exc:  # noqa: BLE001 - raised below, in the caller
                errors.append(exc)

        t0 = time.monotonic()
        threads = [threading.Thread(target=drive, args=sw) for sw in zip(sessions, waves)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errors:
            raise errors[0]
        return {"sessions": int(n), "seconds": round(time.monotonic() - t0, 3)}

    def stats(self) -> dict:
        with self._stats_lock:
            s = dict(self._stats)
        s["pending"] = len(self._pending)
        s["closed"] = self._closed
        return s

    def close(self):
        """Stop the scheduler. Batches under way finish; sessions whose
        windows are still queued get a RuntimeError from feed(). On a mesh,
        rank 0 then releases the other ranks; another rank returns once
        rank 0 has closed."""
        with self._cv:
            if self._closed and not self._thread.is_alive():
                return
            self._closed = True
            self._cv.notify_all()
        self._thread.join()
        self._link.end()
        self._link.raise_error()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------ #

    def _enqueue(self, req):
        with self._cv:
            if self._closed:
                raise RuntimeError("StreamingService is closed")
            self._pending.append(req)
            self._cv.notify()
        return req.future.result()

    def _decode(self, window, options, temperature, gate, *, piece=None, at_offset=None,
                at_time_res=None):
        """The sessions' decode executor: queue the window and wait. `window`
        is a [80, N_FRAMES] mel, or None with `piece` a (PrefetchedAudio,
        lead frames) whose mel the scheduler makes. With `at_offset` the
        call returns (result, tags), else the result."""
        temperature = (tuple(temperature) if isinstance(temperature, (list, tuple))
                       else (temperature,))
        key = (_canonical_options(options), temperature, gate.compression_ratio, gate.logprob,
               gate.no_speech)
        return self._enqueue(_DecodeRequest(window, key, options, temperature, gate, Future(),
                                            piece=piece, at_offset=at_offset,
                                            at_time_res=at_time_res))

    def _detect(self, window):
        """The sessions' detect executor: queue the first window's language
        detection and wait for its {language: probability}."""
        return self._enqueue(_DetectRequest(window, Future()))

    def _run_job(self, job) -> None:
        """A follower's part of rank 0's batch: the same decode or
        detection over the windows it sent."""
        with torch.no_grad():
            windows = job[1].to(self.mesh.device)
            if job[0] == "detect":
                detect_language(self.model, windows)
            else:
                _, _, temperature, gate, options, max_batch = job
                _decode_windows_batched(self.model, windows, temperature, gate, options,
                                        max_batch, self.mesh)

    def _run_detect_batch(self, batch):
        try:
            with torch.no_grad():
                windows = torch.stack([r.window for r in batch])
                _, probs = self._link.call(("detect", windows),
                                           lambda: detect_language(self.model, windows))
        except Exception as exc:  # noqa: BLE001 - delivered to each session
            for r in batch:
                _settle(r.future, exception=exc)
            return
        with self._stats_lock:
            self._stats["detect_windows"] += len(batch)
            self._stats["detect_batches"] += 1
        for r, p in zip(batch, probs):
            _settle(r.future, result=p)

    def _take_batch(self):
        with self._cv:
            while not self._pending:
                if self._closed:
                    return self._CLOSED
                if self.mesh is None:
                    self._cv.wait()
                elif not self._cv.wait(timeout=HEARTBEAT_S):
                    return self._IDLE
            if self._closed:
                # fail queued windows rather than leave their sessions waiting
                while self._pending:
                    _settle(self._pending.popleft().future, exception=RuntimeError(
                        "StreamingService closed while the window was queued"))
                return self._CLOSED
            head = self._pending.popleft()
        batch = [head]
        hard_deadline = time.monotonic() + self.max_total_wait_s
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch:
            with self._cv:
                cands, self._pending = _scan_compatible(self._pending, head.key,
                                                        self.max_batch - len(batch))
                if not cands:
                    if self._closed:
                        break
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(timeout=remaining)
                    continue
            batch.extend(cands)
            # an arrival buys another max_wait_s, up to the hard cap
            deadline = min(hard_deadline, time.monotonic() + self.max_wait_s)
        return batch

    def _materialize_windows(self, batch):
        """[N, 80, N_FRAMES] windows of a batch: mels that came with their
        request as they are, the others from their pieces in one
        `mel_stream_pieces` call per (length, lead) group."""
        rows = [r.window for r in batch]
        groups = {}
        for i, r in enumerate(batch):
            if r.piece is not None:
                prepped, lead = r.piece
                groups.setdefault((prepped.sig.shape[0], lead), []).append(i)
        for (_, lead), idxs in groups.items():
            sigs = torch.stack([batch[i].piece[0].ready() for i in idxs])
            n_valid = torch.tensor([batch[i].piece[0].n_frames for i in idxs],
                                   device=sigs.device)
            wins = mel_stream_pieces(sigs, n_valid, lead)
            for j, i in enumerate(idxs):
                rows[i] = wins[j]
        return torch.stack(rows), sum(len(v) for v in groups.values())

    def _batched_tags(self, batch, results):
        """Tag logits of the rows that asked (at_offset set), one
        `at_forward` per (offset, resolution) group; None elsewhere."""
        tags = [None] * len(batch)
        groups = {}
        for i, r in enumerate(batch):
            if r.at_offset is not None:
                groups.setdefault((r.at_offset, r.at_time_res), []).append(i)
        for (offset, time_res), idxs in groups.items():
            feats = torch.stack([results[i].audio_features_for_at for i in idxs])
            out = self.model.at_forward(feats[:, :, offset:], time_res)
            for j, i in enumerate(idxs):
                tags[i] = out[j]
        return tags, len(groups)

    def _scheduler(self):
        if self.mesh is not None:
            self.mesh.bind_thread()
        while True:
            batch = self._take_batch()
            if batch is self._CLOSED:
                return
            if batch is self._IDLE:
                self._link.heartbeat()
                continue
            head = batch[0]
            if isinstance(head, _DetectRequest):
                self._run_detect_batch(batch)
                continue
            try:
                with torch.no_grad():
                    with _stream_prof("sched-materialize"):
                        windows, n_mel_batched = self._materialize_windows(batch)
                    with _stream_prof("sched-decode"):
                        job = ("decode", windows, head.temperature, head.gate, head.options,
                               self.max_batch)
                        results = self._link.call(job, lambda: _decode_windows_batched(
                            self.model, windows, head.temperature, head.gate, head.options,
                            self.max_batch, self.mesh))
                    with _stream_prof("sched-tags"):
                        tags, n_tag_groups = self._batched_tags(batch, results)
            except Exception as exc:  # noqa: BLE001 - delivered to each session
                for r in batch:
                    _settle(r.future, exception=exc)
                continue
            with self._stats_lock:
                s = self._stats
                s["windows"] += len(batch)
                s["batches"] += 1
                s["max_batch_windows"] = max(s["max_batch_windows"], len(batch))
                s["mel_batched_windows"] += n_mel_batched
                s["tag_groups"] += n_tag_groups
            for r, res, tg in zip(batch, results, tags):
                _settle(r.future, result=(res, tg) if r.at_offset is not None else res)
