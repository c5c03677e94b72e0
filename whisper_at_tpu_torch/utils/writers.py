"""Transcript writers: txt, vtt, srt, tsv and json, one file per audio.

Counterpart of `whisper_at_tpu/utils/writers.py`, byte for byte the same
output. Subtitles with word timings are laid out in three stages:

  1. `_word_stream`  every word of every segment, flagged when it opens one;
  2. `_CueLayout`    greedy line filling: a word joins the current line when
                     it fits in max_line_width, no pause of more than 3 s
                     precedes it (unless segments are kept) and it does not
                     open a kept segment; otherwise it opens a line, and a
                     new cue when max_line_count lines are used, after a
                     long pause or at a kept segment's start;
  3. the format's rendering, plain or once per word with that word
     underlined (`--highlight_words`).

Segments are kept as cues unless both max_line_width and max_line_count
are given.
"""

import json
import os
import re
from typing import Callable, Iterator, List, Optional, TextIO, Tuple

from . import format_timestamp


def _word_stream(segments) -> Iterator[Tuple[dict, bool]]:
    """(a copy of each word timing, whether it opens its segment)."""
    for segment in segments:
        for i, timing in enumerate(segment["words"]):
            yield dict(timing), i == 0


class _CueLayout:
    """Folds a word stream into cues of at most `max_line_count` lines of
    at most `max_line_width` characters. `feed` returns the cue a word
    closes, `flush` the last one."""

    LONG_PAUSE_S = 3.0

    def __init__(self, max_line_width: Optional[int], max_line_count: Optional[int],
                 preserve_segments: bool):
        self.width = 1000 if max_line_width is None else max_line_width
        self.count = max_line_count
        self.preserve_segments = preserve_segments
        self._cue: List[dict] = []
        self._line_len = 0
        self._lines = 1
        self._prev_start: Optional[float] = None

    def feed(self, timing: dict, starts_segment: bool) -> Optional[dict]:
        pause = (not self.preserve_segments and self._prev_start is not None
                 and timing["start"] - self._prev_start > self.LONG_PAUSE_S)
        seg_break = bool(starts_segment and self._cue and self.preserve_segments)
        self._prev_start = timing["start"]
        word = timing["word"]
        if (self._line_len > 0 and self._line_len + len(word) <= self.width
                and not pause and not seg_break):
            self._line_len += len(word)
            self._cue.append(timing)
            return None

        # the word opens a line, and perhaps a cue
        timing["word"] = word.strip()
        closed = None
        if seg_break or (self._cue and self.count is not None
                         and (pause or self._lines >= self.count)):
            closed = self._take_cue()
        elif self._line_len > 0:
            self._lines += 1
            timing["word"] = "\n" + timing["word"]
        self._line_len = len(timing["word"].strip())
        self._cue.append(timing)
        return closed

    def flush(self) -> Optional[dict]:
        return self._take_cue() if self._cue else None

    def _take_cue(self) -> dict:
        cue = {"start": self._cue[0]["start"], "end": self._cue[-1]["end"],
               "words": self._cue}
        self._cue, self._lines = [], 1
        return cue


def _layout_cues(segments, max_line_width, max_line_count,
                 preserve_segments) -> Iterator[dict]:
    layout = _CueLayout(max_line_width, max_line_count, preserve_segments)
    for timing, starts_segment in _word_stream(segments):
        cue = layout.feed(timing, starts_segment)
        if cue:
            yield cue
    cue = layout.flush()
    if cue:
        yield cue


def _underline(word: str) -> str:
    return re.sub(r"^(\s*)(.*)$", r"\1<u>\2</u>", word)


class ResultWriter:
    extension: str

    def __init__(self, output_dir: str):
        self.output_dir = output_dir

    def __call__(self, result: dict, audio_path: str, options: dict):
        stem = os.path.splitext(os.path.basename(audio_path))[0]
        path = os.path.join(self.output_dir, f"{stem}.{self.extension}")
        with open(path, "w", encoding="utf-8") as f:
            self.write_result(result, file=f, options=options)

    def write_result(self, result: dict, file: TextIO, options: dict):
        raise NotImplementedError


class WriteTXT(ResultWriter):
    extension = "txt"

    def write_result(self, result: dict, file: TextIO, options: dict):
        for segment in result["segments"]:
            print(segment["text"].strip(), file=file, flush=True)


class SubtitlesWriter(ResultWriter):
    always_include_hours: bool
    decimal_marker: str

    def ts(self, seconds: float) -> str:
        return format_timestamp(seconds, self.always_include_hours, self.decimal_marker)

    def iterate_result(self, result: dict, options: dict) -> Iterator[Tuple[str, str, str]]:
        """(start, end, text) of each subtitle block."""
        segments = result["segments"]
        if "words" not in segments[0]:
            for segment in segments:
                yield (self.ts(segment["start"]), self.ts(segment["end"]),
                       segment["text"].strip().replace("-->", "->"))
            return
        width, count = options["max_line_width"], options["max_line_count"]
        cues = _layout_cues(segments, width, count, width is None or count is None)
        for cue in cues:
            if options["highlight_words"]:
                yield from self._highlighted(cue)
            else:
                yield (self.ts(cue["start"]), self.ts(cue["end"]),
                       "".join(w["word"] for w in cue["words"]))

    def _highlighted(self, cue: dict) -> Iterator[Tuple[str, str, str]]:
        """The cue once per word with that word underlined, and the plain
        cue across the gaps between words."""
        words = [w["word"] for w in cue["words"]]
        cursor = self.ts(cue["start"])
        for i, timing in enumerate(cue["words"]):
            start, end = self.ts(timing["start"]), self.ts(timing["end"])
            if cursor != start:
                yield cursor, start, "".join(words)
            yield start, end, "".join(_underline(w) if j == i else w
                                      for j, w in enumerate(words))
            cursor = end


class WriteVTT(SubtitlesWriter):
    extension = "vtt"
    always_include_hours = False
    decimal_marker = "."

    def write_result(self, result: dict, file: TextIO, options: dict):
        print("WEBVTT\n", file=file)
        for start, end, text in self.iterate_result(result, options):
            print(f"{start} --> {end}\n{text}\n", file=file, flush=True)


class WriteSRT(SubtitlesWriter):
    extension = "srt"
    always_include_hours = True
    decimal_marker = ","

    def write_result(self, result: dict, file: TextIO, options: dict):
        for i, (start, end, text) in enumerate(self.iterate_result(result, options), start=1):
            print(f"{i}\n{start} --> {end}\n{text}\n", file=file, flush=True)


class WriteTSV(ResultWriter):
    """Start and end in integer milliseconds and the text, tab-separated,
    one segment a line."""

    extension = "tsv"

    def write_result(self, result: dict, file: TextIO, options: dict):
        print("start", "end", "text", sep="\t", file=file)
        for segment in result["segments"]:
            print(round(1000 * segment["start"]), file=file, end="\t")
            print(round(1000 * segment["end"]), file=file, end="\t")
            print(segment["text"].strip().replace("\t", " "), file=file, flush=True)


class WriteJSON(ResultWriter):
    extension = "json"

    def write_result(self, result: dict, file: TextIO, options: dict):
        out = dict(result)
        if hasattr(out.get("audio_tag"), "tolist"):  # numpy array or tensor
            out["audio_tag"] = out["audio_tag"].tolist()
        json.dump(out, file)


_WRITERS = {"txt": WriteTXT, "vtt": WriteVTT, "srt": WriteSRT, "tsv": WriteTSV,
            "json": WriteJSON}


def get_writer(output_format: str, output_dir: str) -> Callable[[dict, str, dict], None]:
    """The writer of one format, or of all five for "all"."""
    if output_format != "all":
        return _WRITERS[output_format](output_dir)
    writers = [cls(output_dir) for cls in _WRITERS.values()]

    def write_all(result: dict, audio_path: str, options: dict):
        for writer in writers:
            writer(result, audio_path, options)

    return write_all
