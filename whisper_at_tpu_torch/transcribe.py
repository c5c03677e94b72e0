"""Long-audio transcription and tagging: `transcribe_batched` and the
sequential `transcribe`.

Counterpart of `whisper_at_tpu/transcribe.py`:

  transcribe_batched  every 30 s window of the recording rides the batch
                      axis: one mel pass, one encoder + TL-TR pass and one
                      batched greedy decode per chunk of up to `max_batch`
                      windows; the temperature ladder re-decodes only the
                      windows the quality gate rejects. Windows advance at a
                      fixed 30 s stride and no text is carried from one
                      window to the next.
  transcribe          the reference's seek loop: one window at a time, the
                      seek moved by the decoded timestamps (and by the last
                      aligned word with word timestamps), the previous text
                      threaded into the next window's prompt.

  transcribe_many     the serving path: many recordings through shared
                      batches. Their windows are packed across files into
                      `transcribe_batched`'s decode, grouped by language, so
                      each file's result equals `transcribe_batched` on it.

Each takes a waveform, a WAV path or a `PrefetchedAudio`, and attaches word
timestamps on request (`timing.py`). `transcribe_batched` and
`transcribe_many` take a `parallel.mesh.Mesh`: every rank calls them with the
same audio, each dp rank decodes its share of the windows, and every rank
returns the whole result (`parallel/inference.py`).
"""

import time
import warnings
from dataclasses import replace
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from .audio import (
    FRAMES_PER_SECOND,
    HOP_LENGTH,
    N_FRAMES,
    N_SAMPLES,
    SAMPLE_RATE,
    PrefetchedAudio,
    log_mel_spectrogram,
    pad_or_trim,
    prefetch_audio,
)
from .decoding import DecodingOptions, DecodingResult, DecodingTask, decode, detect_language
from .parallel.inference import dp_share, gather_results
from .languages import LANGUAGES
from .ops.mel import WINDOW_SLACK, mel_windows_many
from .segmentation import (
    QualityGate,
    TagGrid,
    clear_degenerate,
    parse_window,
    segment_record,
    temperature_schedule,
)
from .timing import (
    APPEND_PUNCTUATIONS,
    PREPEND_PUNCTUATIONS,
    add_word_timestamps,
    add_word_timestamps_many,
)
from .tokenizer import get_tokenizer
from .utils import exact_div, format_timestamp, make_safe
from .utils.profiling import StageProf

DEFAULT_MAX_BATCH = 24  # 30 s windows per device batch
ALIGN_BATCH = 8  # windows per add_word_timestamps_many call of the batched path

# WHISPER_AT_TPU_SERVE_PROF=1: wall and CPU time of each stage of every
# transcribe_many call (frontend-mel, detect, decode, tag-dispatch, assembly,
# tag-commit, emit) and of the serving scheduler (sched-fill, sched-gap,
# sched-settle); off, each stage costs a nullcontext
_serve_prof = StageProf("WHISPER_AT_TPU_SERVE_PROF")


def print_segment(seg: dict) -> None:
    print(make_safe(f"[{format_timestamp(seg['start'])} --> "
                    f"{format_timestamp(seg['end'])}] {seg['text']}"))


def _resolve_language(model, mel_window: torch.Tensor, decode_options: dict,
                      verbose: Optional[bool], detect_fn=None) -> str:
    """Fill decode_options["language"], detecting it from the first window
    when it is unset on a multilingual model. `detect_fn` (mel window ->
    {language: probability}), when given, replaces the inline detection
    (a streaming service batches it across sessions)."""
    if decode_options.get("language") is None:
        if not model.is_multilingual:
            decode_options["language"] = "en"
        else:
            if verbose:
                print("Detecting language using up to the first 30 seconds. "
                      "Use `--language` to specify the language")
            if detect_fn is not None:
                probs = detect_fn(mel_window)
            else:
                _, probs = detect_language(model, mel_window)
            decode_options["language"] = max(probs, key=probs.get)
            if verbose is not None:
                print(f"Detected language: {LANGUAGES[decode_options['language']].title()}")
    return decode_options["language"]


def _reject_conditioning(decode_options: dict) -> None:
    if decode_options.pop("condition_on_previous_text", False):
        raise ValueError("condition_on_previous_text=True is sequential; the batched "
                         "paths decode windows in parallel")


def _geometry(model) -> Tuple[int, float]:
    """(mel frames per encoder position, seconds per timestamp token)."""
    stride = exact_div(N_FRAMES, model.dims.n_audio_ctx)
    return stride, stride * HOP_LENGTH / SAMPLE_RATE


def _mel_to_windows(mel: torch.Tensor):
    """[80, T] mel (with its 30 s tail padding) -> ([W, 80, 3000] windows,
    content frames); W is 0 (windows None) for empty audio."""
    content_frames = mel.shape[-1] - N_FRAMES
    n_windows = -(-content_frames // N_FRAMES)
    if n_windows <= 0:
        return None, content_frames
    mel = pad_or_trim(mel, n_windows * N_FRAMES)
    return mel.reshape(mel.shape[0], n_windows, N_FRAMES).transpose(0, 1), content_frames


def _batch_bucket(n: int, max_batch: int) -> int:
    """Smallest batch of the JAX package's ladder 1, 2, 4, 8, 16, max_batch
    that holds n rows: the request sizes `TranscriptionService.warmup` runs
    by default. The decode itself takes exactly its windows."""
    ladder = [b for b in (1, 2, 4, 8, 16) if b < max_batch] + [max_batch]
    return next(b for b in ladder if b >= n)


def _decode_windows_batched(model, windows: torch.Tensor, temperature, gate: QualityGate,
                            decode_options: dict, max_batch: int, mesh=None,
                            keep_features: bool = True) -> List[DecodingResult]:
    """Decode every window in chunks of max_batch; each rung of the
    temperature ladder re-decodes only the windows the gate rejected. With
    a mesh, each dp rank decodes its share of a rung's windows in chunks of
    max_batch / dp and every rank gets every result; keep_features=False
    drops the encoder output from them (only word timing reads it)."""
    n_windows = windows.shape[0]
    results: List[Optional[DecodingResult]] = [None] * n_windows
    pending = list(range(n_windows))
    per = max_batch if mesh is None else max(1, max_batch // mesh.size("dp"))
    for t, kwargs in temperature_schedule(temperature, decode_options):
        if not pending:
            break
        task = DecodingTask(model, DecodingOptions(**kwargs, temperature=t))
        mine = pending if mesh is None else dp_share(pending, mesh)
        decoded = []
        for lo in range(0, len(mine), per):
            # exactly the chunk's windows: the JAX package pads a chunk with
            # copies of its last row up to `_batch_bucket` to bound XLA
            # compiles, which an eager port does not need
            chunk = mine[lo:lo + per]
            decoded += task.run(windows[torch.tensor(chunk, device=windows.device)])
        if mesh is not None:
            if not keep_features:
                decoded = [replace(r, audio_features=None) for r in decoded]
            decoded = gather_results(decoded, mesh)
        for w, r in zip(pending, decoded):
            results[w] = r
        pending = [w for w in pending if gate.needs_fallback(results[w])]
    return results


def _on_mesh(model, mesh):
    """The mesh, checked, with the model placed on it (None: no mesh)."""
    if mesh is None:
        return None
    from .parallel.inference import place_model_on_mesh
    from .parallel.mesh import as_mesh

    mesh = as_mesh(mesh)
    place_model_on_mesh(model, mesh)
    return mesh


def _stitch_tags_dispatch(model, entries, at_time_res: float, max_batch: int):
    """Run the TL-TR head over every window's taps, grouped by pooled-frame
    grid offset and max_batch at a time; return a callback that copies the
    logits into each window's TagGrid. entries: (grid, seek, taps [L, 75, D])."""
    groups = {}
    for i, (grid, seek, _) in enumerate(entries):
        groups.setdefault(grid.offset_in_window(seek), []).append(i)
    pending = []
    for offset, idxs in groups.items():
        for lo in range(0, len(idxs), max_batch):
            chunk = idxs[lo:lo + max_batch]
            feats = torch.stack([entries[i][2] for i in chunk])
            pending.append((chunk, model.at_forward(feats[:, :, offset:], at_time_res)))

    def commit():
        for chunk, tags in pending:
            tags = tags.float().cpu().numpy()
            for row, i in enumerate(chunk):
                grid, seek, _ = entries[i]
                grid.write(seek, tags[row])

    return commit


def _assemble_windows(model, results, content_frames: int, tokenizer, gate: QualityGate,
                      input_stride: int, time_precision: float, word_timestamps: bool,
                      prepend_punctuations: str, append_punctuations: str, verbose):
    """Window results at a fixed 30 s stride -> (tokens, segments), with
    word timings attached ALIGN_BATCH windows at a time when asked."""
    all_tokens: List[int] = []
    per_window: List[Tuple[List[dict], int, int]] = []  # (segments, window, size)
    for w, result in enumerate(results):
        seek = w * N_FRAMES
        if seek >= content_frames:
            break
        if gate.is_silence(result):
            continue
        size = min(N_FRAMES, content_frames - seek)
        parse = parse_window(
            np.asarray(result.tokens, np.int64), timestamp_begin=tokenizer.timestamp_begin,
            time_offset=float(seek * HOP_LENGTH / SAMPLE_RATE), segment_size=size,
            segment_duration=size * HOP_LENGTH / SAMPLE_RATE, input_stride=input_stride,
            time_precision=time_precision)
        window_segments = []
        for start, end, toks in parse.pieces:
            seg = segment_record(seek=seek, start=start, end=end, tokens=toks,
                                 result=result, eot=tokenizer.eot, tokenizer=tokenizer)
            if seg["start"] == seg["end"] or not seg["text"].strip():
                continue
            window_segments.append(seg)
            all_tokens.extend(seg["tokens"])
        per_window.append((window_segments, w, size))

    if word_timestamps:
        # the decode pass's encoder output rides along, so the alignment
        # forward skips the encoder
        jobs = [(segs, None, size, results[w].audio_features)
                for segs, w, size in per_window if segs]
        for lo in range(0, len(jobs), ALIGN_BATCH):
            add_word_timestamps_many(window_jobs=jobs[lo:lo + ALIGN_BATCH], model=model,
                                     tokenizer=tokenizer,
                                     prepend_punctuations=prepend_punctuations,
                                     append_punctuations=append_punctuations)

    all_segments: List[dict] = []
    for window_segments, _, _ in per_window:
        for seg in window_segments:
            seg["id"] = len(all_segments)
            all_segments.append(seg)
            if verbose:
                print_segment(seg)
    return all_tokens, all_segments


def transcribe_batched(
    model,
    audio: Union[str, np.ndarray, torch.Tensor, PrefetchedAudio],
    *,
    temperature: Union[float, Tuple[float, ...]] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
    compression_ratio_threshold: Optional[float] = 2.4,
    logprob_threshold: Optional[float] = -1.0,
    no_speech_threshold: Optional[float] = 0.6,
    at_time_res: float = 10,
    max_batch: int = DEFAULT_MAX_BATCH,
    mesh=None,
    initial_prompt: Optional[str] = None,
    word_timestamps: bool = False,
    prepend_punctuations: str = PREPEND_PUNCTUATIONS,
    append_punctuations: str = APPEND_PUNCTUATIONS,
    verbose: Optional[bool] = None,
    **decode_options,
) -> dict:
    """Transcribe and tag a recording (WAV path, int16 PCM or float32 at
    16 kHz) on the model's device. Returns {"text", "segments", "language",
    "at_time_res", "audio_tag" [n_cells, 527]}; with word_timestamps every
    segment also has "words" (word, start, end, probability). With `mesh`
    (a `parallel.mesh.Mesh`), every rank calls this with the same audio and
    gets the same result; the dp ranks split the windows."""
    _reject_conditioning(decode_options)
    mesh = _on_mesh(model, mesh)
    with torch.no_grad():
        mel = log_mel_spectrogram(audio, padding=N_SAMPLES, device=model.device)
        gate = QualityGate(compression_ratio_threshold, logprob_threshold,
                           no_speech_threshold)
        language = _resolve_language(model, pad_or_trim(mel, N_FRAMES), decode_options,
                                     verbose)
        tokenizer = get_tokenizer(model.is_multilingual, language=language,
                                  task=decode_options.get("task", "transcribe"))
        input_stride, time_precision = _geometry(model)

        windows, content_frames = _mel_to_windows(mel)
        grid = TagGrid(content_frames, at_time_res)
        if windows is None:
            return dict(text="", segments=[], language=language,
                        at_time_res=at_time_res, audio_tag=grid.logits)
        if initial_prompt is not None:
            decode_options["prompt"] = tokenizer.encode(" " + initial_prompt.strip())

        results = _decode_windows_batched(model, windows, temperature, gate,
                                          decode_options, max_batch, mesh, word_timestamps)
        commit_tags = _stitch_tags_dispatch(
            model, [(grid, w * N_FRAMES, r.audio_features_for_at)
                    for w, r in enumerate(results)], at_time_res, max_batch)
        tokens, segments = _assemble_windows(
            model, results, content_frames, tokenizer, gate, input_stride, time_precision,
            word_timestamps, prepend_punctuations, append_punctuations, verbose)
        commit_tags()
    return dict(text=tokenizer.decode(tokens), segments=segments, language=language,
                at_time_res=at_time_res, audio_tag=grid.logits)


def _run_ladder(decode_one, temperature, gate: QualityGate, decode_options: dict
                ) -> DecodingResult:
    """Walk the temperature ladder until a window passes the quality gate."""
    result = None
    for t, kwargs in temperature_schedule(temperature, decode_options):
        result = decode_one(DecodingOptions(**kwargs, temperature=t))
        if not gate.needs_fallback(result):
            break
    return result


def _tag_window(model, grid: TagGrid, seek: int, result: DecodingResult,
                at_time_res: float) -> None:
    """One window's TL-TR logits, realigned and stitched into the grid."""
    offset = grid.offset_in_window(seek)
    tags = model.at_forward(result.audio_features_for_at[:, offset:], at_time_res)
    grid.write(seek, tags.float().cpu().numpy())


def _attach_word_timings(model, tokenizer, segments, mel_window, num_frames,
                         prepend_punctuations, append_punctuations,
                         audio_features=None) -> None:
    """Word timings of one window's segments (the streaming session's)."""
    add_word_timestamps(segments=segments, model=model, tokenizer=tokenizer, mel=mel_window,
                        num_frames=num_frames, prepend_punctuations=prepend_punctuations,
                        append_punctuations=append_punctuations,
                        audio_features=audio_features)


def transcribe(
    model,
    audio: Union[str, np.ndarray, torch.Tensor, PrefetchedAudio],
    *,
    verbose: Optional[bool] = None,
    temperature: Union[float, Tuple[float, ...]] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
    compression_ratio_threshold: Optional[float] = 2.4,
    logprob_threshold: Optional[float] = -1.0,
    no_speech_threshold: Optional[float] = 0.6,
    condition_on_previous_text: bool = True,
    initial_prompt: Optional[str] = None,
    word_timestamps: bool = False,
    prepend_punctuations: str = PREPEND_PUNCTUATIONS,
    append_punctuations: str = APPEND_PUNCTUATIONS,
    at_time_res: float = 10,
    **decode_options,
) -> dict:
    """Transcribe and tag a recording one 30 s window at a time, the
    reference's seek loop, on the model's device. Returns the same dict as
    `transcribe_batched`."""
    with torch.no_grad():
        # padded with 30 s of silence, so every window lies inside the mel
        mel = log_mel_spectrogram(audio, padding=N_SAMPLES, device=model.device)
        content_frames = mel.shape[-1] - N_FRAMES

        def window_at(seek: int) -> torch.Tensor:
            return pad_or_trim(mel.narrow(1, seek, min(N_FRAMES, mel.shape[-1] - seek)),
                               N_FRAMES)

        grid = TagGrid(content_frames, at_time_res)
        gate = QualityGate(compression_ratio_threshold, logprob_threshold,
                           no_speech_threshold)
        language = _resolve_language(model, window_at(0), decode_options, verbose)
        task = decode_options.get("task", "transcribe")
        tokenizer = get_tokenizer(model.is_multilingual, language=language, task=task)
        if word_timestamps and task == "translate":
            warnings.warn("Word-level timestamps on translations may not be reliable.")
        input_stride, time_precision = _geometry(model)

        prompt_tokens = (tokenizer.encode(" " + initial_prompt.strip())
                         if initial_prompt is not None else [])
        thread: List[int] = list(prompt_tokens)  # the running token context
        thread_live_from = 0  # tokens before this index are not fed as prompt
        segments: List[dict] = []
        seek = 0
        while seek < content_frames:
            window = window_at(seek)
            segment_size = min(N_FRAMES, content_frames - seek)
            time_offset = float(seek * HOP_LENGTH / SAMPLE_RATE)
            decode_options["prompt"] = thread[thread_live_from:]
            result = _run_ladder(lambda opts: decode(model, window, opts), temperature, gate,
                                 decode_options)
            _tag_window(model, grid, seek, result, at_time_res)
            if gate.is_silence(result):
                seek += segment_size
                continue

            window_start = seek
            tokens = np.asarray(result.tokens, np.int64)
            parse = parse_window(
                tokens, timestamp_begin=tokenizer.timestamp_begin, time_offset=time_offset,
                segment_size=segment_size,
                segment_duration=segment_size * HOP_LENGTH / SAMPLE_RATE,
                input_stride=input_stride, time_precision=time_precision)
            # a degenerate decode (a closing timestamp pair at the window
            # start) parses to advance 0: move past the window instead
            seek += parse.advance_frames if parse.advance_frames > 0 else segment_size
            new_segments = [
                segment_record(seek=window_start, start=start, end=end, tokens=toks,
                               result=result, eot=tokenizer.eot, tokenizer=tokenizer)
                for start, end, toks in parse.pieces]

            if word_timestamps:
                add_word_timestamps(segments=new_segments, model=model, tokenizer=tokenizer,
                                    mel=window, num_frames=segment_size,
                                    prepend_punctuations=prepend_punctuations,
                                    append_punctuations=append_punctuations,
                                    audio_features=result.audio_features)
                # move the seek to the end of the last aligned word, unless
                # the window ended on a lone timestamp
                ends = [w["end"] for seg in new_segments for w in seg["words"]]
                lone_ts_end = (len(tokens) >= 2 and tokens[-1] >= tokenizer.timestamp_begin
                               and tokens[-2] < tokenizer.timestamp_begin)
                if ends and not lone_ts_end:
                    shift = round((ends[-1] - time_offset) * FRAMES_PER_SECOND)
                    if shift > 0:
                        seek = window_start + shift

            if verbose:
                for seg in new_segments:
                    print_segment(seg)
            clear_degenerate(new_segments)
            for seg in new_segments:
                seg["id"] = len(segments)
                segments.append(seg)
                thread.extend(seg["tokens"])
            if not condition_on_previous_text or result.temperature > 0.5:
                # text sampled hot is unreliable context
                thread_live_from = len(thread)

    return dict(text=tokenizer.decode(thread[len(prompt_tokens):]), segments=segments,
                language=language, at_time_res=at_time_res, audio_tag=grid.logits)


def _fit(sig: torch.Tensor, length: int) -> torch.Tensor:
    """A prepared signal cut or zero-extended to `length` samples."""
    if sig.shape[0] >= length:
        return sig[:length]
    return torch.cat([sig, sig.new_zeros(length - sig.shape[0])])


def _frontend_many(model, audios, needs_detect: bool, max_batch: int) -> List[dict]:
    """Per file: {"windows" [W, 80, 3000] or None, "content" frames,
    "first" [80, 3000] window for detection (or None)}. Files with W
    windows share batched mel calls of up to max_batch files (which bounds
    the call's memory), their prepared signals cut to the frames the
    windows read (`ops.mel.mel_windows_many`)."""
    dev = model.device
    prepped = []
    for audio in audios:
        if isinstance(audio, PrefetchedAudio):
            if audio.padding != N_SAMPLES:
                raise ValueError(f"PrefetchedAudio was prepared with padding={audio.padding}; "
                                 f"transcribe_many needs {N_SAMPLES}")
        else:
            audio = prefetch_audio(audio, N_SAMPLES, dev)
        prepped.append(audio)

    files, groups = [], {}
    for i, p in enumerate(prepped):
        content = p.n_frames - N_FRAMES
        n_windows = -(-content // N_FRAMES) if content > 0 else 0
        files.append({"windows": None, "content": content, "first": None})
        if n_windows:
            groups.setdefault(n_windows, []).append(i)
        elif needs_detect:
            # detection reads the all-padding first window, as per file
            files[i]["first"] = pad_or_trim(
                log_mel_spectrogram(p, padding=N_SAMPLES, device=dev), N_FRAMES)
    for n_windows, group in groups.items():
        length = (n_windows * N_FRAMES + WINDOW_SLACK + 2) * HOP_LENGTH
        for lo in range(0, len(group), max_batch):
            _group_windows(files, prepped, group[lo:lo + max_batch], n_windows, length, dev)
    return files


def _group_windows(files, prepped, idxs, n_windows: int, length: int, dev) -> None:
    """One batched mel call over files of n_windows windows each."""
    rows = [_fit(prepped[i].ready().to(dev), length) for i in idxs]
    if len({r.dtype for r in rows}) > 1:
        rows = [r.float() * (1.0 / 32768.0) if r.dtype == torch.int16 else r
                for r in rows]
    n_valid = torch.tensor([prepped[i].n_frames for i in idxs], device=dev)
    wins = mel_windows_many(torch.stack(rows), n_valid, n_windows)
    for row, i in enumerate(idxs):
        files[i]["windows"] = wins[row]
        files[i]["first"] = wins[row, 0]


def transcribe_many(
    model,
    audios,
    *,
    temperature: Union[float, Tuple[float, ...]] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
    compression_ratio_threshold: Optional[float] = 2.4,
    logprob_threshold: Optional[float] = -1.0,
    no_speech_threshold: Optional[float] = 0.6,
    at_time_res: float = 10,
    max_batch: int = DEFAULT_MAX_BATCH,
    mesh=None,
    initial_prompt: Optional[str] = None,
    word_timestamps: bool = False,
    prepend_punctuations: str = PREPEND_PUNCTUATIONS,
    append_punctuations: str = APPEND_PUNCTUATIONS,
    verbose: Optional[bool] = None,
    **decode_options,
) -> List[dict]:
    """Transcribe and tag many recordings (waveforms, WAV paths or
    `PrefetchedAudio`) through shared batches on the model's device.

    One batched mel call per window count, one language-id pass over the
    first windows of every file (`max_batch` at a time) when the language
    is unset on a multilingual model, then the windows of every file of a
    language packed into `transcribe_batched`'s decode, one tag pass over
    every window, and the per-file assembly. Windows decode independently,
    so each result equals `transcribe_batched` on that file. Returns one
    `transcribe_batched`-shaped dict per input, in order. With `mesh`, as
    `transcribe_batched`: every rank the same inputs and the same results."""
    _reject_conditioning(decode_options)
    mesh = _on_mesh(model, mesh)
    prof = _serve_prof
    gate = QualityGate(compression_ratio_threshold, logprob_threshold, no_speech_threshold)
    input_stride, time_precision = _geometry(model)
    task = decode_options.get("task", "transcribe")
    needs_detect = decode_options.get("language") is None and model.is_multilingual
    fixed_language = (decode_options.get("language") if model.is_multilingual
                      else decode_options.get("language") or "en")

    with torch.no_grad():
        t0 = time.perf_counter()
        files = _frontend_many(model, audios, needs_detect, max_batch)
        prof.add("frontend-mel", time.perf_counter() - t0)

        t0 = time.perf_counter()
        for f in files:
            f["language"] = fixed_language
        if needs_detect:
            if verbose:
                print("Detecting language using up to the first 30 seconds. "
                      "Use `--language` to specify the language")
            for lo in range(0, len(files), max_batch):
                chunk = files[lo:lo + max_batch]
                _, probs = detect_language(model, torch.stack([f["first"] for f in chunk]))
                for f, p in zip(chunk, probs):
                    f["language"] = max(p, key=p.get)
                    if verbose is not None:
                        print(f"Detected language: {LANGUAGES[f['language']].title()}")
        prof.add("detect", time.perf_counter() - t0)

        t0 = time.perf_counter()
        by_language = {}
        for i, f in enumerate(files):
            by_language.setdefault(f["language"], []).append(i)
        results: List[list] = [[] for _ in files]
        for language, idxs in by_language.items():
            tokenizer = get_tokenizer(model.is_multilingual, language=language, task=task)
            opts = dict(decode_options, language=language)
            if initial_prompt is not None:
                opts["prompt"] = tokenizer.encode(" " + initial_prompt.strip())
            for i in idxs:
                files[i]["tokenizer"] = tokenizer
            # empty recordings decode nothing; their results stay []
            live = [i for i in idxs if files[i]["windows"] is not None]
            if not live:
                continue
            packed = torch.cat([files[i]["windows"] for i in live])
            decoded = _decode_windows_batched(model, packed, temperature, gate, opts,
                                              max_batch, mesh, word_timestamps)
            pos = 0
            for i in live:
                n = files[i]["windows"].shape[0]
                results[i] = decoded[pos:pos + n]
                pos += n
        prof.add("decode", time.perf_counter() - t0)

        t0 = time.perf_counter()
        entries = []
        for i, f in enumerate(files):
            f["grid"] = TagGrid(f["content"], at_time_res)
            entries += [(f["grid"], w * N_FRAMES, r.audio_features_for_at)
                        for w, r in enumerate(results[i])]
        commit_tags = _stitch_tags_dispatch(model, entries, at_time_res, max_batch)
        prof.add("tag-dispatch", time.perf_counter() - t0)

        t0 = time.perf_counter()
        assembled = [_assemble_windows(model, results[i], f["content"], f["tokenizer"], gate,
                                       input_stride, time_precision, word_timestamps,
                                       prepend_punctuations, append_punctuations, verbose)
                     for i, f in enumerate(files)]
        prof.add("assembly", time.perf_counter() - t0)

        t0 = time.perf_counter()
        commit_tags()
        prof.add("tag-commit", time.perf_counter() - t0)

    t0 = time.perf_counter()
    out = [dict(text=f["tokenizer"].decode(tokens), segments=segments,
                language=f["language"], at_time_res=at_time_res, audio_tag=f["grid"].logits)
           for f, (tokens, segments) in zip(files, assembled)]
    prof.add("emit", time.perf_counter() - t0)
    return out


from .cli import cli  # noqa: E402,F401  (re-exported as the JAX package does)
