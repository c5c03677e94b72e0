"""Word-level timestamps from a DTW alignment of cross-attention.

Counterpart of `whisper_at_tpu/timing.py`. The window's text runs once more
through the decoder with <|notimestamps|> (`decoder_forward_with_qk`,
keeping the alignment heads' cross-attention logits); the logits are
softmaxed over the window's frames, z-normalised per head over the tokens,
median-filtered along time and averaged over heads; DTW (K6,
`ops/dtw.py`) finds the monotonic token-to-frame path through the negated
matrix; the tokens are carved into words and the times distributed over the
segments with the reference's duration heuristics.

On the card everything up to the DTW trace runs on the device; only the
scalar backtrace and the word carving run on the host. The DTW sums its
costs in float64, as the JAX package's default host DTW does.
"""

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .audio import HOP_LENGTH, SAMPLE_RATE, TOKENS_PER_SECOND
from .models.decoder import decoder_forward_with_qk
from .ops.dtw import dtw_paths
from .ops.median import median_filter
from .tokenizer import Tokenizer

PREPEND_PUNCTUATIONS = "\"'“¿([{-"
APPEND_PUNCTUATIONS = "\"'.。,，!！?？:：”)]}、"
QK_CHUNK_BYTES = 1.2e9  # qk bytes per batched alignment forward (costed at fp32)
DTW_DTYPE = torch.float64


@dataclass
class WordTiming:
    word: str
    tokens: List[int]
    start: float
    end: float
    probability: float


def dtw(x) -> np.ndarray:
    """The path [2, path_len] (text indices, time indices) through one cost
    matrix [N, M] (the JAX package's `timing.dtw`): K6 for a CUDA tensor,
    its plain version otherwise, the costs summed in float64."""
    x = torch.as_tensor(x, dtype=torch.float32)
    return dtw_paths(x[None], [x.shape[0]])[0]


def _align_dtype(model) -> torch.dtype:
    """The alignment forward's compute dtype: the model's own (bf16 weights
    compute in bf16, fp32 weights in fp32). The weight chain is fp32 either
    way."""
    w = model.decoder.token_embedding.weight
    return torch.bfloat16 if w.dtype == torch.bfloat16 else torch.float32


def _process_qk_weights(qk: torch.Tensor, num_frames: int, qk_scale: float,
                        medfilt_width: int, lens: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """qk [B, n_sel, S, F] -> head-averaged weights [B, S, num_frames // 2]:
    softmax over the window's frames, per-head z-norm over the tokens, median
    filter along the frames. `lens` ([B]) restricts each row's z-norm
    statistics to its valid positions (right-padded batches)."""
    weights = qk[..., :num_frames // 2].float() * qk_scale
    weights = torch.exp(weights - weights.amax(dim=-1, keepdim=True))
    weights = weights / weights.sum(dim=-1, keepdim=True)
    if lens is None:
        mean = weights.mean(dim=-2, keepdim=True)
        std = (weights - mean).square().mean(dim=-2, keepdim=True).sqrt()
    else:
        s = weights.shape[-2]
        valid = (torch.arange(s, device=qk.device)[None, :] < lens[:, None])[:, None, :, None]
        cnt = lens.float()[:, None, None, None]
        mean = torch.where(valid, weights, 0.0).sum(dim=-2, keepdim=True) / cnt
        var = torch.where(valid, (weights - mean).square(), 0.0).sum(dim=-2, keepdim=True) / cnt
        std = var.sqrt()
    weights = median_filter((weights - mean) / std, medfilt_width)
    return weights.mean(dim=1)


def _token_probs_from_logits(logits: torch.Tensor, toks: torch.Tensor, sl: int,
                             eot: int) -> torch.Tensor:
    """[G, S - sl - 1] probability of each next token under logits [G, S, V]:
    exp(logit[target] - logsumexp(logits[:eot])); position sl + i predicts
    text token i."""
    lg = logits[:, sl:-1, :eot]
    tgt = toks[:, sl + 1:].clamp(max=eot - 1)
    tgt_logit = lg.gather(-1, tgt[..., None])[..., 0]
    return torch.exp(tgt_logit - torch.logsumexp(lg, dim=-1))


def _alignment_from_path(path: np.ndarray, text_token_probs: Sequence[float],
                         tokenizer: Tokenizer, text_tokens: List[int]) -> List[WordTiming]:
    """Word carving and the duration heuristics on one DTW path [2, L]."""
    text_indices, time_indices = path
    words, word_tokens = tokenizer.split_to_word_tokens(list(text_tokens) + [tokenizer.eot])
    word_boundaries = np.pad(np.cumsum([len(t) for t in word_tokens[:-1]]), (1, 0))

    jumps = np.pad(np.diff(text_indices), (1, 0), constant_values=1).astype(bool)
    jump_times = time_indices[jumps] / TOKENS_PER_SECOND
    start_times = jump_times[word_boundaries[:-1]]
    end_times = jump_times[word_boundaries[1:]]
    word_probabilities = [np.mean(text_token_probs[i:j])
                          for i, j in zip(word_boundaries[:-1], word_boundaries[1:])]

    # truncate pathologically long words at window and sentence starts to
    # twice the median word duration
    word_durations = end_times - start_times
    word_durations = word_durations[word_durations.nonzero()]
    if len(word_durations) > 0:
        max_duration = np.median(word_durations) * 2
        sentence_end_marks = ".。!！?？"
        for i in range(1, len(start_times)):
            if end_times[i] - start_times[i] > max_duration:
                if words[i] in sentence_end_marks:
                    end_times[i] = start_times[i] + max_duration
                elif words[i - 1] in sentence_end_marks:
                    start_times[i] = end_times[i] - max_duration
        if len(start_times) > 0 and end_times[0] - start_times[0] > max_duration:
            if len(start_times) > 1 and end_times[1] - start_times[1] > max_duration:
                boundary = max(end_times[1] / 2, end_times[1] - max_duration)
                end_times[0] = start_times[1] = boundary
            start_times[0] = max(0, end_times[0] - max_duration)

    return [WordTiming(word, tokens, start, end, probability)
            for word, tokens, start, end, probability in zip(
                words, word_tokens, start_times, end_times, word_probabilities)]


def find_alignment(model, tokenizer: Tokenizer, text_tokens: List[int], mel: torch.Tensor,
                   num_frames: int, *, medfilt_width: int = 7, qk_scale: float = 1.0,
                   audio_features: Optional[torch.Tensor] = None) -> List[WordTiming]:
    """Word timings of one window's text. audio_features ([F, D] or
    [1, F, D]), the decode pass's encoder output, skips the encoder."""
    if len(text_tokens) == 0:
        return []
    sl = len(tokenizer.sot_sequence)
    tokens = torch.tensor([[*tokenizer.sot_sequence, tokenizer.no_timestamps, *text_tokens,
                            tokenizer.eot]], device=model.device)
    dtype = _align_dtype(model)
    if audio_features is None:
        audio_features, _ = model.embed_audio(mel, fp16=dtype == torch.bfloat16)
    elif audio_features.dim() == 2:
        audio_features = audio_features[None]
    logits, qk = decoder_forward_with_qk(model.decoder, tokens, audio_features,
                                         model.alignment_heads, model.text_heads, dtype)
    # the probabilities in float64 on the host, as the JAX package's solo path
    sampled = logits[0, sl:, :tokenizer.eot].double().cpu().numpy()
    shifted = sampled - sampled.max(axis=-1, keepdims=True)
    token_probs = np.exp(shifted) / np.exp(shifted).sum(axis=-1, keepdims=True)
    text_token_probs = token_probs[np.arange(len(text_tokens)), text_tokens].tolist()

    weights = _process_qk_weights(qk, num_frames, qk_scale, medfilt_width)[0]
    path = dtw_paths(-weights[None, sl:-1], [len(text_tokens) + 1], DTW_DTYPE)[0]
    return _alignment_from_path(path, text_token_probs, tokenizer, text_tokens)


def find_alignment_batched(model, tokenizer: Tokenizer, text_tokens_list: List[List[int]],
                           mels, num_frames_list: List[int], *, medfilt_width: int = 7,
                           qk_scale: float = 1.0, audio_features=None
                           ) -> List[List[WordTiming]]:
    """`find_alignment` for many windows: one encoder pass (none when the
    decode pass's features are given) and one alignment forward over the
    right-padded token rows; one K6 launch per group of rows sharing a
    num_frames. Token probabilities come from an fp32 log-sum-exp on the
    device. Rows with no tokens give [] and stay out of the batch.

    mels: [N, 80, 3000] windows (tensor or list); audio_features: optional
    per-row encoder outputs ([N, F, D] tensor or list of [F, D])."""
    n = len(text_tokens_list)
    out: List[List[WordTiming]] = [[] for _ in range(n)]
    live = [i for i in range(n) if len(text_tokens_list[i]) > 0]
    if not live:
        return out

    sl = len(tokenizer.sot_sequence)
    rows = [[*tokenizer.sot_sequence, tokenizer.no_timestamps, *text_tokens_list[i],
             tokenizer.eot] for i in live]
    s_max = max(len(r) for r in rows)
    if s_max > model.dims.n_text_ctx:
        raise ValueError(f"window token sequence {s_max} exceeds n_text_ctx")
    # rows at exactly s_max: the JAX package pads to 64-row buckets to bound
    # its compiles, which an eager forward has no use for
    toks = np.full((len(live), s_max), tokenizer.eot, np.int64)
    for j, r in enumerate(rows):
        toks[j, :len(r)] = r
    dev = model.device
    toks = torch.from_numpy(toks).to(dev)
    lens = np.asarray([len(r) for r in rows])

    dtype = _align_dtype(model)
    if audio_features is not None:
        audio_features = torch.stack([audio_features[i] for i in live])
    else:
        mels = torch.stack(list(mels)) if isinstance(mels, (list, tuple)) else mels
        audio_features, _ = model.embed_audio(mels[live], fp16=dtype == torch.bfloat16)

    logits, qk = decoder_forward_with_qk(model.decoder, toks, audio_features,
                                         model.alignment_heads, model.text_heads, dtype)
    text_probs = _token_probs_from_logits(logits, toks, sl, tokenizer.eot).cpu().numpy()
    del logits

    groups = {}
    for j, i in enumerate(live):
        groups.setdefault(int(num_frames_list[i]), []).append(j)
    for nf, idxs in groups.items():
        # all windows usually share one num_frames: no gather copy then
        sub = qk if len(idxs) == qk.shape[0] else qk[idxs]
        lens_g = torch.from_numpy(lens[idxs]).to(dev)
        w = _process_qk_weights(sub, nf, qk_scale, medfilt_width, lens=lens_g)
        lengths = [len(text_tokens_list[live[j]]) + 1 for j in idxs]
        paths = dtw_paths(-w[:, sl:sl + max(lengths)], lengths, DTW_DTYPE)
        for j, path in zip(idxs, paths):
            text = text_tokens_list[live[j]]
            out[live[j]] = _alignment_from_path(path, text_probs[j, :len(text)].tolist(),
                                                tokenizer, text)
    return out


def _glue(source: WordTiming, target: WordTiming, source_first: bool) -> None:
    """Move `source`'s text and tokens into `target`, emptying the source."""
    if source_first:
        target.word = source.word + target.word
        target.tokens = source.tokens + target.tokens
    else:
        target.word = target.word + source.word
        target.tokens = target.tokens + source.tokens
    source.word = ""
    source.tokens = []


def merge_punctuations(alignment: List[WordTiming], prepended: str, appended: str) -> None:
    """Fold hanging punctuation into its neighbour word, in place. Opening
    marks that stand as their own space-prefixed words glue forward
    (scanning right to left, so chains collapse); closing marks glue
    backward (left to right), never across a trailing space. Emptied
    entries stay, with word "", since their tokens count toward segments."""
    anchor = len(alignment) - 1
    for i in range(len(alignment) - 2, -1, -1):
        cur = alignment[i]
        if cur.word.startswith(" ") and cur.word.strip() in prepended:
            _glue(cur, alignment[anchor], source_first=True)
        else:
            anchor = i

    anchor = 0
    for j in range(1, len(alignment)):
        cur = alignment[j]
        if not alignment[anchor].word.endswith(" ") and cur.word in appended:
            _glue(cur, alignment[anchor], source_first=False)
        else:
            anchor = j


def _words_per_segment(alignment: List[WordTiming], tokens_per_segment: List[List[int]],
                       time_offset: float):
    """Yield each segment's word dicts, spending its token budget along the
    merged alignment (emptied entries spend budget and emit nothing)."""
    cursor = 0
    for seg_tokens in tokens_per_segment:
        budget = len(seg_tokens)
        words = []
        while cursor < len(alignment) and budget > 0:
            timing = alignment[cursor]
            if timing.word:
                words.append(dict(word=timing.word,
                                  start=round(time_offset + timing.start, 2),
                                  end=round(time_offset + timing.end, 2),
                                  probability=timing.probability))
            budget -= len(timing.tokens)
            cursor += 1
        yield words


def _text_tokens_per_segment(segments: List[dict], eot: int) -> List[List[int]]:
    return [[t for t in seg["tokens"] if t < eot] for seg in segments]


def add_word_timestamps(*, segments: List[dict], model, tokenizer: Tokenizer,
                        mel: torch.Tensor, num_frames: int,
                        prepend_punctuations: str = PREPEND_PUNCTUATIONS,
                        append_punctuations: str = APPEND_PUNCTUATIONS, **kwargs) -> None:
    """Attach "words" to every segment of one window, in place, and snap the
    segments' boundaries to their first and last words."""
    if len(segments) == 0:
        return
    per_seg = _text_tokens_per_segment(segments, tokenizer.eot)
    alignment = find_alignment(model, tokenizer, [t for seg in per_seg for t in seg],
                               mel, num_frames, **kwargs)
    _apply_alignment(segments, alignment, per_seg, prepend_punctuations, append_punctuations)


def add_word_timestamps_many(*, window_jobs: List[Tuple], model, tokenizer: Tokenizer,
                             prepend_punctuations: str = PREPEND_PUNCTUATIONS,
                             append_punctuations: str = APPEND_PUNCTUATIONS,
                             **kwargs) -> None:
    """`add_word_timestamps` for many windows through batched alignment
    forwards. window_jobs: (segments, mel_window [80, F], num_frames) or the
    same with the window's decode-pass encoder features appended (which
    skip the encoder); segments are modified in place."""
    jobs = [j for j in window_jobs if len(j[0]) > 0]
    if not jobs:
        return
    seg_tok_lists = [_text_tokens_per_segment(segments, tokenizer.eot)
                     for segments, *_ in jobs]
    tok_lists = [[t for seg in per_seg for t in seg] for per_seg in seg_tok_lists]

    # pack rows under a byte budget for the fp32-costed qk capture
    # [G, n_sel, s_max, n_audio_ctx]; a chunk pads to its longest row, so
    # rows go in length order and are costed at the chunk's max
    sl = len(tokenizer.sot_sequence)
    n_sel = max(int(np.asarray(model.alignment_heads, bool).sum()), 1)
    per_s_bytes = n_sel * model.dims.n_audio_ctx * 4
    row_lens = [len(t) + sl + 2 for t in tok_lists]
    chunks, cur, cur_max = [], [], 0
    for i in sorted(range(len(row_lens)), key=row_lens.__getitem__):
        new_max = max(cur_max, row_lens[i])
        if cur and per_s_bytes * new_max * (len(cur) + 1) > QK_CHUNK_BYTES:
            chunks.append(cur)
            cur, new_max = [], row_lens[i]
        cur.append(i)
        cur_max = new_max
    if cur:
        chunks.append(cur)

    alignments = [None] * len(jobs)
    have_feats = all(len(j) >= 4 and j[3] is not None for j in jobs)
    for idxs in chunks:
        sub = find_alignment_batched(
            model, tokenizer, [tok_lists[i] for i in idxs], [jobs[i][1] for i in idxs],
            [jobs[i][2] for i in idxs],
            audio_features=[jobs[i][3] for i in idxs] if have_feats else None, **kwargs)
        for i, a in zip(idxs, sub):
            alignments[i] = a
    for (segments, *_), alignment, per_seg in zip(jobs, alignments, seg_tok_lists):
        _apply_alignment(segments, alignment, per_seg, prepend_punctuations,
                         append_punctuations)


def _apply_alignment(segments, alignment, tokens_per_segment, prepend_punctuations,
                     append_punctuations) -> None:
    """Punctuation merge, per-segment word carving and boundary snapping."""
    merge_punctuations(alignment, prepend_punctuations, append_punctuations)
    time_offset = segments[0]["seek"] * HOP_LENGTH / SAMPLE_RATE
    for segment, words in zip(segments, _words_per_segment(alignment, tokens_per_segment,
                                                            time_offset)):
        segment["words"] = words
        if not words:
            continue
        segment["start"] = words[0]["start"]
        last = words[-1]
        if segment["end"] > last["start"] and segment["end"] + 0.5 < last["end"]:
            # the last word runs well past the timestamp-token end: keep the
            # segment's end
            last["end"] = segment["end"]
        else:
            segment["end"] = last["end"]
