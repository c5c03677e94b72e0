"""The per-window result core of the transcription paths.

Counterpart of `whisper_at_tpu/segmentation.py` (framework-free; this
package keeps its own copy):

  QualityGate     the temperature-fallback and silence-skip criteria
  TagGrid         the at_time_res decision grid: window alignment offsets
                  and the stitched [n_cells, 527] tag logits
  parse_window    timestamp-token slicing of one window's tokens into
                  (start, end, tokens) pieces
  segment_record  the public per-segment result dict
  clear_degenerate  blanks empty segments of the sequential path
"""

import math
import warnings
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

N_TAG_CLASSES = 527


# --------------------------------------------------------------------------- #
# quality gates
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class QualityGate:
    """Decode-quality thresholds (reference transcribe.py:51-61,160-184).

    compression_ratio: above => too repetitive, retry hotter.
    logprob: below => low confidence, retry hotter.
    no_speech: above => silence (suppresses the retry and skips the window
    unless the logprob check overrides).
    """

    compression_ratio: Optional[float] = 2.4
    logprob: Optional[float] = -1.0
    no_speech: Optional[float] = 0.6

    def needs_fallback(self, result) -> bool:
        retry = False
        if (self.compression_ratio is not None
                and result.compression_ratio > self.compression_ratio):
            retry = True
        if self.logprob is not None and result.avg_logprob < self.logprob:
            retry = True
        if (self.no_speech is not None
                and result.no_speech_prob > self.no_speech):
            retry = False  # silence: hotter sampling won't produce speech
        return retry

    def is_silence(self, result) -> bool:
        """Window should be skipped as no-speech (transcribe.py:270-281)."""
        if self.no_speech is None:
            return False
        skip = result.no_speech_prob > self.no_speech
        if self.logprob is not None and result.avg_logprob > self.logprob:
            skip = False  # confident text overrides the VAD gate
        return skip


def temperature_schedule(temperature, decode_options: dict):
    """Yield (t, per-temperature decode options) for the fallback ladder.

    Beam/patience only apply at t == 0; best_of only at t > 0
    (transcribe.py:144-153).
    """
    temps = ([temperature] if isinstance(temperature, (int, float))
             else list(temperature))
    for t in temps:
        kwargs = dict(decode_options)
        if t > 0:
            kwargs.pop("beam_size", None)
            kwargs.pop("patience", None)
            # speculative decoding is greedy-exact only; sampling rungs
            # fall back to the plain loop
            kwargs.pop("draft_model", None)
        else:
            kwargs.pop("best_of", None)
        yield t, kwargs


# --------------------------------------------------------------------------- #
# audio-tag decision grid
# --------------------------------------------------------------------------- #


class TagGrid:
    """The at_time_res tagging grid over a whole recording.

    The TL-TR head pools encoder states to 0.4 s frames; a decision cell
    covers at_time_res seconds (at_time_res * 100 mel frames). Windows start
    at arbitrary seeks, so each window's pooled features are realigned to the
    grid by dropping the pooled frames before the next cell boundary
    (reference transcribe.py:255-263).
    """

    POOLED_FRAME = 40  # mel frames per pooled feature frame (20x conv stride)

    def __init__(self, content_frames: int, at_time_res: float):
        window = at_time_res * 100
        assert window % self.POOLED_FRAME == 0, (
            "Audio tagging resolution at_time_res must be an integer "
            "multiple of 0.4 second, e.g., 0.4, 0.8, 1.2, etc, current "
            "at_time_res={:.2f}.".format(at_time_res)
        )
        self.window = int(window)
        self.at_time_res = at_time_res
        if self.window != 1000:
            warnings.warn(
                "Current at_time_res is {:.2f} second, the audio tagging "
                "model is trained with time resolution of 10 seconds. "
                "Mismatch time resolution may cause an audio tagging "
                "performance drop, but won't impact ASR performance."
                .format(at_time_res),
                stacklevel=3,
            )
        n_cells = max(1, math.ceil(content_frames / self.window))
        self.logits = np.zeros((n_cells, N_TAG_CLASSES), np.float32)

    def offset_in_window(self, seek: int) -> int:
        """Pooled-frame offset realigning a window at `seek` to the grid."""
        return math.floor(seek % self.window / self.POOLED_FRAME)

    def write(self, seek: int, tags: np.ndarray) -> None:
        """Stitch one window's [n_seg, 527] cell logits in at `seek`."""
        first = math.floor(seek / self.window)
        last = min(self.logits.shape[0], first + tags.shape[0])
        self.logits[first:last] = tags[: last - first]


# --------------------------------------------------------------------------- #
# timestamp-token segmentation
# --------------------------------------------------------------------------- #


@dataclass
class WindowParse:
    """One window's sampled tokens sliced into timed pieces."""

    pieces: List[Tuple[float, float, np.ndarray]]  # (start_s, end_s, tokens)
    advance_frames: int  # mel frames the seek should move (sequential path)


def parse_window(
    tokens: np.ndarray,
    *,
    timestamp_begin: int,
    time_offset: float,
    segment_size: int,
    segment_duration: float,
    input_stride: int,
    time_precision: float,
) -> WindowParse:
    """Slice a window's tokens at double-timestamp boundaries.

    The decoder emits <|t0|> text <|t1|><|t2|> text <|t3|> ... — a pair of
    adjacent timestamps closes one utterance and opens the next. Rules
    (reference transcribe.py:283-332, oracle-tested):

    * pairs present: one piece per closed slice; if the window ends with a
      lone trailing timestamp, the tail is a final piece and the seek moves
      a full window, otherwise the unfinished tail is dropped and the seek
      moves to the last closing timestamp;
    * no pairs: the whole window is one piece; a lone non-initial timestamp
      anywhere sets its end time; seek moves a full window.
    """
    is_ts = tokens >= timestamp_begin
    pair_ends = np.flatnonzero(is_ts[:-1] & is_ts[1:]) + 1
    # a lone trailing timestamp needs a non-timestamp before it (a length-1
    # window of just <|ts|> does NOT count — matches the reference's
    # two-element comparison)
    ends_with_lone_ts = (
        len(tokens) >= 2 and bool(is_ts[-1]) and not bool(is_ts[-2])
    )

    if len(pair_ends) == 0:
        # one open piece spanning the window
        end = segment_duration
        ts_values = tokens[is_ts]
        if len(ts_values) > 0 and int(ts_values[-1]) != timestamp_begin:
            end = (int(ts_values[-1]) - timestamp_begin) * time_precision
        return WindowParse(
            pieces=[(time_offset, time_offset + end, tokens)],
            advance_frames=segment_size,
        )

    bounds = list(pair_ends)
    if ends_with_lone_ts:
        bounds.append(len(tokens))
    pieces = []
    lo = 0
    for hi in bounds:
        piece = tokens[lo:hi]
        t0 = (int(piece[0]) - timestamp_begin) * time_precision
        t1 = (int(piece[-1]) - timestamp_begin) * time_precision
        pieces.append((time_offset + t0, time_offset + t1, piece))
        lo = hi

    if ends_with_lone_ts:
        advance = segment_size
    else:
        closing_ts = int(tokens[lo - 1]) - timestamp_begin
        advance = closing_ts * input_stride
    return WindowParse(pieces=pieces, advance_frames=advance)


def segment_record(
    *, seek: int, start: float, end: float, tokens, result, eot: int,
    tokenizer,
) -> dict:
    """The public per-segment dict (reference transcribe.py:208-223)."""
    token_list = [int(t) for t in tokens]
    return {
        "seek": seek,
        "start": start,
        "end": end,
        "text": tokenizer.decode([t for t in token_list if t < eot]),
        "tokens": token_list,
        "temperature": result.temperature,
        "avg_logprob": result.avg_logprob,
        "compression_ratio": result.compression_ratio,
        "no_speech_prob": result.no_speech_prob,
    }


def clear_degenerate(segments: List[dict]) -> None:
    """Blank instantaneous or empty segments in place: the record stays (the
    sequential path numbers it), its text, tokens and words go."""
    for seg in segments:
        if seg["start"] == seg["end"] or seg["text"].strip() == "":
            seg["text"] = ""
            seg["tokens"] = []
            seg["words"] = []
