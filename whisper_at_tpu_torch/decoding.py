"""Decoding: options, the logit filters as tensor ops, greedy/temperature
sampling (with best-of groups) and beam search with patience, each as a
Python loop over steps on the device.

Counterpart of `whisper_at_tpu/decoding.py`. The JAX package runs each loop
as one device program; here each step is one decoder pass and a few tensor
ops, and the host checks every few steps whether the loop has ended. The
quantization options are ported at both widths: int8 or int4 cross K/V
(`kv_bits`, K3 + K4), decoder weights (`weight_bits`; int4 through K5) and
self cache (`self_kv_bits`). Speculative greedy decoding (`draft_model`,
`spec_sample_loop`) drafts `draft_lookahead` tokens a round with a small
model and verifies them in one pass of this one, token for token greedy's.
"""

import threading
from dataclasses import dataclass, field, replace
from typing import Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from .audio import CHUNK_LENGTH
from .models.decoder import (
    CrossKV,
    decoder_forward,
    decoder_forward_rows,
    init_cache,
    precompute_cross_kv,
    project_logits,
)
from .tokenizer import Tokenizer, get_tokenizer
from .utils import compression_ratio

NEG_INF = float("-inf")
# the counts of the latest speculative decode in this thread, read as the
# module attribute `_LAST_SPEC_STATS` (rounds, commits, tokens_per_round)
_SPEC_STATS = threading.local()
PREFILL_BUCKETS = (4, 8, 16, 32, 64, 128, 224, 256)
FINISH_CHECK_EVERY = 8  # steps between host checks that every row ended


def __getattr__(name: str):
    if name == "_LAST_SPEC_STATS":
        return getattr(_SPEC_STATS, "stats", None)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


@dataclass(frozen=True)
class DecodingOptions:
    task: str = "transcribe"          # or "translate", "lang_id"
    language: Optional[str] = None    # detected from the audio when None
    temperature: float = 0.0
    sample_len: Optional[int] = None  # most tokens to sample
    best_of: Optional[int] = None
    beam_size: Optional[int] = None
    patience: Optional[float] = None
    length_penalty: Optional[float] = None
    prompt: Optional[Union[str, List[int]]] = None
    prefix: Optional[Union[str, List[int]]] = None
    suppress_tokens: Optional[Union[str, Iterable[int]]] = "-1"  # -1: non-speech set
    suppress_blank: bool = True
    without_timestamps: bool = False
    max_initial_timestamp: Optional[float] = 1.0
    fp16: bool = True                 # bfloat16 compute
    kv_quant: bool = False            # quantized cross-attention K/V (K3 + K4)
    weight_quant: bool = False        # quantized decoder matmul weights
    weight_bits: int = 8              # 8, or 4 (K5)
    self_kv_quant: bool = False       # quantized self-attention cache
    self_kv_bits: int = 8
    kv_layout: Optional[str] = None   # "fused" or "heads": both decode through K3/K4
    kv_bits: int = 8
    draft_model: Optional[object] = None
    draft_lookahead: int = 8


@dataclass
class DecodingResult:
    audio_features: object
    audio_features_for_at: object  # the pooled encoder taps for tagging
    language: str
    language_probs: Optional[Dict[str, float]] = None
    tokens: List[int] = field(default_factory=list)
    text: str = ""
    avg_logprob: float = np.nan
    no_speech_prob: float = np.nan
    temperature: float = np.nan
    compression_ratio: float = np.nan
    spec_stats: Optional[dict] = None  # speculative decoding's counts (the call's)


def apply_logit_filters(logits: torch.Tensor, t: Union[int, torch.Tensor],
                        prev1: torch.Tensor, prev2: torch.Tensor, last_ts: torch.Tensor,
                        suppress_mask: torch.Tensor, *, eot: int, ts_begin: int,
                        blank_token: int, max_initial_ts_index: Optional[int],
                        suppress_blank: bool, with_ts_rules: bool,
                        return_margin: bool = False):
    """Suppress-blank, suppress-tokens and the timestamp rules on [B, V]
    logits at sampled step t: a Python int (every row at the same step), or
    a [B] tensor (the speculative loop's rows, each at its own step).
    prev1/prev2 are the tokens sampled at steps t-1 and t-2 (ignored before
    they exist); last_ts is each row's latest sampled timestamp token, or
    -1. With return_margin, also each row's margin of the last rule, the
    timestamps' log-sum-exp minus the best text logit [B] (inf without the
    timestamp rules): how far the choice between text and a timestamp is
    from flipping."""
    idx = torch.arange(logits.shape[-1], device=logits.device)[None, :]
    at_start = t == 0
    per_row = isinstance(at_start, torch.Tensor)

    def at_start_fill(x, cond):
        if per_row:
            return x.masked_fill(at_start[:, None] & cond, NEG_INF)
        return x.masked_fill(cond, NEG_INF) if at_start else x

    if suppress_blank:
        logits = at_start_fill(logits, (idx == blank_token) | (idx == eot))
    logits = logits + suppress_mask[None, :]
    if not with_ts_rules:
        if return_margin:
            return logits, torch.full(logits.shape[:1], float("inf"), device=logits.device)
        return logits

    logits = logits.masked_fill(idx == ts_begin - 1, NEG_INF)  # <|notimestamps|>
    last_was = (prev1 >= ts_begin) & (t >= 1)
    penult_was = (prev2 >= ts_begin) | (t < 2)
    # timestamps come in pairs, except directly before EOT
    logits = logits.masked_fill((last_was & penult_was)[:, None] & (idx >= ts_begin), NEG_INF)
    logits = logits.masked_fill((last_was & ~penult_was)[:, None] & (idx < eot), NEG_INF)
    # timestamps never go back in time
    cut = torch.where(last_was & ~penult_was, last_ts, last_ts + 1)
    logits = logits.masked_fill(
        (last_ts >= 0)[:, None] & (idx >= ts_begin) & (idx < cut[:, None]), NEG_INF)
    logits = at_start_fill(logits, idx < ts_begin)
    if max_initial_ts_index is not None:
        logits = at_start_fill(logits, idx > ts_begin + max_initial_ts_index)
    # if the timestamps together are likelier than any text token, sample a
    # timestamp (the softmax normaliser cancels, so raw logits compare)
    ts_mass = torch.logsumexp(logits.masked_fill(idx < ts_begin, NEG_INF), dim=-1)
    max_text = logits.masked_fill(idx >= ts_begin, NEG_INF).amax(dim=-1)
    out = logits.masked_fill((ts_mass > max_text)[:, None] & (idx < ts_begin), NEG_INF)
    return (out, ts_mass - max_text) if return_margin else out


def _prefill(params, cross: CrossKV, buf: torch.Tensor, *, pad: int, sot_slot: int,
             prefill: int, n_head: int, compute_dtype, no_speech_id: Optional[int],
             self_kv_quant: bool, self_kv_bits: int):
    """The prefill pass of a sampling loop over buf [B, total]: its self
    cache, the no-speech probabilities [B] at the SOT slot and the logits
    [B, V] of the last prompt slot. Rows of a group (beams, best-of samples)
    share their audio row of `cross`."""
    b, total = buf.shape
    group = b // cross.k.shape[1]
    d = params.width
    cache = init_cache(len(params.blocks), b, total, d, compute_dtype, n_head,
                       quantize=self_kv_quant, bits=self_kv_bits, device=buf.device)
    hidden = decoder_forward(params, buf[:, :prefill], cross, cache, 0, pad, n_head,
                             compute_dtype, group=group)
    if no_speech_id is not None:
        sot_logits = project_logits(params, hidden[:, sot_slot:sot_slot + 1])[:, 0]
        no_speech = torch.softmax(sot_logits, dim=-1)[:, no_speech_id]
    else:
        no_speech = torch.full((b,), float("nan"), device=buf.device)
    return cache, no_speech, project_logits(params, hidden[:, -1:])[:, 0]


def greedy_sample_loop(params, cross, buf: torch.Tensor, *, pad: int, sot_slot: int,
                       suppress_mask: torch.Tensor, temperature: float,
                       generator: Optional[torch.Generator], prefill: int, max_steps: int,
                       n_head: int, compute_dtype, eot: int, ts_begin: int,
                       blank_token: int, no_speech_id: Optional[int],
                       max_initial_ts_index: Optional[int], suppress_blank: bool,
                       with_ts_rules: bool, self_kv_quant: bool = False,
                       self_kv_bits: int = 8):
    """Sample up to max_steps tokens into buf [B, total] (slots from
    `prefill` on), greedily at temperature 0. Returns (buf, sum_logprobs [B],
    no_speech_probs [B], steps run); rows keep EOT once they emit it."""
    b = buf.shape[0]
    group = b // cross.k.shape[1]
    cache, no_speech, logits = _prefill(
        params, cross, buf, pad=pad, sot_slot=sot_slot, prefill=prefill, n_head=n_head,
        compute_dtype=compute_dtype, no_speech_id=no_speech_id, self_kv_quant=self_kv_quant,
        self_kv_bits=self_kv_bits)

    sum_lp = torch.zeros(b, device=buf.device)
    last_ts = torch.full((b,), -1, dtype=buf.dtype, device=buf.device)
    finished = torch.zeros(b, dtype=torch.bool, device=buf.device)
    t = 0
    while t < max_steps:
        if t and t % FINISH_CHECK_EVERY == 0 and bool(finished.all()):
            break
        slot = prefill + t
        filtered = apply_logit_filters(
            logits, t, buf[:, slot - 1], buf[:, max(slot - 2, 0)], last_ts,
            suppress_mask, eot=eot, ts_begin=ts_begin, blank_token=blank_token,
            max_initial_ts_index=max_initial_ts_index, suppress_blank=suppress_blank,
            with_ts_rules=with_ts_rules)
        if temperature == 0:
            token = filtered.argmax(dim=-1)
        else:
            probs = torch.softmax(filtered / max(temperature, 1e-6), dim=-1)
            token = torch.multinomial(probs, 1, generator=generator)[:, 0]
        logprob = filtered.gather(1, token[:, None])[:, 0] - torch.logsumexp(filtered, dim=-1)
        sum_lp = sum_lp + logprob * (~finished)
        token = torch.where(finished, torch.full_like(token, eot), token)
        buf[:, slot] = token
        last_ts = torch.where((token >= ts_begin) & ~finished, token, last_ts)
        finished = finished | (token == eot)
        t += 1
        if t < max_steps:
            hidden = decoder_forward(params, token[:, None], cross, cache, slot, pad,
                                     n_head, compute_dtype, group=group)
            logits = project_logits(params, hidden)[:, 0]
    return buf, sum_lp, no_speech, t


def spec_sample_loop(params, cross, draft_params, draft_cross, buf: torch.Tensor, *,
                     pad: int, sot_slot: int, suppress_mask: torch.Tensor, prefill: int,
                     max_steps: int, lookahead: int, n_head: int, n_head_draft: int,
                     compute_dtype, eot: int, ts_begin: int, blank_token: int,
                     no_speech_id: Optional[int], max_initial_ts_index: Optional[int],
                     suppress_blank: bool, with_ts_rules: bool, **_):
    """Greedy decoding by draft and verify: each round the draft model
    proposes `lookahead` (L) tokens a row, one verifier pass over
    [last correction, d1..dL] (S = L + 1 query rows, K4 at G = L + 1 on
    quantized cross K/V) scores them all, and each row commits its agreeing
    drafts and one correction of its own. Every committed token is the
    verifier's filtered argmax given the committed prefix, so the tokens are
    greedy's whatever the draft; the draft sets only how many a round
    commits.

    Round invariants (cp = a row's next slot to commit):
      - the verifier's cache is valid over [pad, cp-1); the token at cp-1
        (the last correction) leads the verify pass;
      - the draft's cache is valid over [pad, cp-2]; its first pass each
        round re-ingests slots {cp-2, cp-1} (a recompute where the slot was
        valid, a repair after a full accept or a correction);
      - both caches hold total + L + 1 slots (cache_ctx), so no pass writes
        past them.
    A row stops at EOT or after max_steps tokens. The rounds run in a Python
    loop whose stop test is read on the host once a round: one device sync
    a round (L + 1 decoder passes and the acceptance's small tensor ops),
    which the greedy loop pays once every FINISH_CHECK_EVERY steps.

    Returns (buf [B, total] with the committed tokens from `prefill` on,
    sum_logprobs [B], no_speech_probs [B], {"rounds", "commits",
    "tokens_per_round"})."""
    dev = buf.device
    b, total = buf.shape
    L = lookahead
    cache_ctx = total + L + 1
    filt = dict(eot=eot, ts_begin=ts_begin, blank_token=blank_token,
                max_initial_ts_index=max_initial_ts_index, suppress_blank=suppress_blank,
                with_ts_rules=with_ts_rules)

    def caches(p, heads):
        return init_cache(len(p.blocks), b, cache_ctx, p.width,
                          compute_dtype, heads, device=dev)

    v_cache, d_cache = caches(params, n_head), caches(draft_params, n_head_draft)
    hidden = decoder_forward(params, buf[:, :prefill], cross, v_cache, 0, pad, n_head,
                             compute_dtype)
    if no_speech_id is not None:
        sot_logits = project_logits(params, hidden[:, sot_slot:sot_slot + 1])[:, 0]
        no_speech = torch.softmax(sot_logits, dim=-1)[:, no_speech_id]
    else:
        no_speech = torch.full((b,), float("nan"), device=dev)
    logits0 = project_logits(params, hidden[:, -1:])[:, 0]
    decoder_forward(draft_params, buf[:, :prefill], draft_cross, d_cache, 0, pad,
                    n_head_draft, compute_dtype)
    if max_steps < 1:
        return buf, torch.zeros(b, device=dev), no_speech, dict(
            rounds=0, commits=0, tokens_per_round=0.0)

    def commit_logprob(f):
        a = f.argmax(dim=-1)
        return a, f.gather(1, a[:, None])[:, 0] - torch.logsumexp(f, dim=-1)

    # the first token is the verifier's own
    zeros = torch.zeros(b, dtype=buf.dtype, device=dev)
    c0, sum_lp = commit_logprob(apply_logit_filters(
        logits0, zeros, zeros, zeros, torch.full_like(zeros, -1), suppress_mask, **filt))
    buf[:, prefill] = c0
    cp = torch.full((b,), prefill + 1, dtype=buf.dtype, device=dev)
    last_ts = torch.where(c0 >= ts_begin, c0, -1)
    finished = c0 == eot
    rounds, commits = 0, torch.full((), b, dtype=torch.long, device=dev)
    while bool((~finished & (cp - prefill < max_steps)).any()):  # the round's host sync
        tminus1 = buf.gather(1, (cp - 1)[:, None])[:, 0]
        tminus2 = buf.gather(1, (cp - 2)[:, None])[:, 0]

        # draft: re-ingest {cp-2, cp-1}, then propose L tokens
        dh = decoder_forward_rows(draft_params, torch.stack([tminus2, tminus1], dim=1),
                                  draft_cross, d_cache, cp - 2, pad, n_head_draft,
                                  compute_dtype)
        dlogits = project_logits(draft_params, dh[:, -1:])[:, 0]
        p1, p2, lts = tminus1, tminus2, last_ts
        drafts = []
        for i in range(L):
            d = apply_logit_filters(dlogits, cp - prefill + i, p1, p2, lts, suppress_mask,
                                    **filt).argmax(dim=-1)
            drafts.append(d)
            if i + 1 < L:  # the last draft's own pass would feed nothing
                dh = decoder_forward_rows(draft_params, d[:, None], draft_cross, d_cache,
                                          cp + i, pad, n_head_draft, compute_dtype)
                dlogits = project_logits(draft_params, dh)[:, 0]
            lts = torch.where(d >= ts_begin, d, lts)
            p1, p2 = d, p1
        drafts = torch.stack(drafts, dim=1)                          # [B, L]

        # verify: one pass over [c, d1..dL]
        vh = decoder_forward_rows(params, torch.cat([tminus1[:, None], drafts], dim=1), cross,
                                  v_cache, cp - 1, pad, n_head, compute_dtype)
        vlogits = project_logits(params, vh)                         # [B, L+1, V]

        # accept: the agreeing drafts and one correction a row
        remaining = max_steps - (cp - prefill)
        open_i = ~finished & (remaining > 0)
        p1, p2, lts = tminus1, tminus2, last_ts
        ncommit = torch.zeros_like(cp)
        for i in range(L + 1):
            a, lp = commit_logprob(apply_logit_filters(
                vlogits[:, i], cp - prefill + i, p1, p2, lts, suppress_mask, **filt))
            slot = torch.clamp(cp + i, max=total - 1)[:, None]
            buf.scatter_(1, slot, torch.where(open_i, a, buf.gather(1, slot)[:, 0])[:, None])
            sum_lp = sum_lp + lp * open_i
            lts = torch.where(open_i & (a >= ts_begin), a, lts)
            finished = finished | (open_i & (a == eot))
            ncommit = ncommit + open_i
            p1, p2 = a, p1
            if i < L:
                open_i = open_i & (drafts[:, i] == a) & (a != eot) & (i + 1 < remaining)
        cp = cp + ncommit
        last_ts = lts
        rounds += 1
        commits = commits + ncommit.sum()
    commits = int(commits)
    return buf, sum_lp, no_speech, dict(rounds=rounds, commits=commits,
                                        tokens_per_round=commits / max(rounds, 1))


def _beam_topk(filtered: torch.Tensor, k: int):
    """The k largest of each row of [B, V] logits, equal values in index
    order (as `lax.top_k` orders them; the step-0 mask and the suppressed
    tokens make many values equal at -inf)."""
    values, index = torch.sort(filtered, dim=-1, descending=True, stable=True)
    return values[:, :k], index[:, :k]


def beam_sample_loop(params, cross, buf: torch.Tensor, *, pad: int, sot_slot: int,
                     suppress_mask: torch.Tensor, prefill: int, max_steps: int,
                     beam_size: int, max_candidates: int, n_head: int, compute_dtype,
                     eot: int, ts_begin: int, blank_token: int, no_speech_id: Optional[int],
                     max_initial_ts_index: Optional[int], suppress_blank: bool,
                     with_ts_rules: bool, self_kv_quant: bool = False,
                     self_kv_bits: int = 8):
    """Beam search with patience over buf [A*K, total] (K = beam_size rows
    per audio, the prompt repeated), the JAX package's tensorized
    bookkeeping step for step: each beam proposes its top K+1
    continuations, the candidates of an audio are sorted by score (stably),
    EOT candidates fill a finished buffer of max_candidates rows, the first
    K others become the new beams and every self-cache tensor is reordered
    along its row axis. At step 0 only beam 0 proposes (the beams share
    their prefix).

    The loop ends when every audio's finished buffer is full or after
    max_steps. The host looks every FINISH_CHECK_EVERY steps; a step taken
    after the end changes nothing, so the result is the JAX loop's.
    Returns (finished tokens [A, C, total], finished scores [A, C],
    finished counts [A], final beams [A*K, total], their sum logprobs
    [A*K], no-speech probabilities [A*K], steps run), all on the device."""
    dev = buf.device
    bk, total = buf.shape
    k = beam_size
    n_cand = k * (k + 1)
    a = bk // k
    c_cap = max_candidates
    group = bk // cross.k.shape[1]
    cache, no_speech, logits = _prefill(
        params, cross, buf, pad=pad, sot_slot=sot_slot, prefill=prefill, n_head=n_head,
        compute_dtype=compute_dtype, no_speech_id=no_speech_id, self_kv_quant=self_kv_quant,
        self_kv_bits=self_kv_bits)

    # the finished buffer; its extra row c_cap takes the candidates that
    # do not fit (the JAX scatter drops them)
    fin_tokens = torch.zeros((a, c_cap + 1, total), dtype=buf.dtype, device=dev)
    fin_scores = torch.full((a, c_cap + 1), NEG_INF, device=dev)
    fin_count = torch.zeros(a, dtype=torch.long, device=dev)
    sum_lp = torch.zeros(bk, device=dev)
    last_ts = torch.full((bk,), -1, dtype=buf.dtype, device=dev)
    n_steps = torch.zeros((), dtype=torch.long, device=dev)
    step0_mask = torch.where(torch.arange(n_cand, device=dev) < k + 1, 0.0, NEG_INF)
    pos = torch.arange(n_cand, device=dev).expand(a, n_cand)
    audio_base = (torch.arange(a, device=dev) * k)[:, None]
    t = 0
    while t < max_steps:
        ended = (fin_count >= c_cap).all()
        if t and t % FINISH_CHECK_EVERY == 0 and bool(ended):
            break
        running = ~ended  # the JAX loop's condition, on the device
        slot = prefill + t
        filtered = apply_logit_filters(
            logits, t, buf[:, slot - 1], buf[:, max(slot - 2, 0)], last_ts,
            suppress_mask, eot=eot, ts_begin=ts_begin, blank_token=blank_token,
            max_initial_ts_index=max_initial_ts_index, suppress_blank=suppress_blank,
            with_ts_rules=with_ts_rules)
        # rank on the raw logits, normalize only the K+1 winners
        top_raw, top_tok = _beam_topk(filtered, k + 1)
        top_lp = top_raw - torch.logsumexp(filtered, dim=-1, keepdim=True)
        cand = (sum_lp[:, None] + top_lp).reshape(a, n_cand)
        cand_tok = top_tok.reshape(a, n_cand)
        if t == 0:
            cand = cand + step0_mask
        order = torch.argsort(-cand, dim=1, stable=True)
        s_scores = cand.gather(1, order)
        s_toks = cand_tok.gather(1, order)
        s_src = order // (k + 1)  # source beam of each candidate
        valid = torch.isfinite(s_scores)
        is_eot = (s_toks == eot) & valid

        # new beams: the first K non-EOT candidates in score order
        keep = valid & ~is_eot
        sel = torch.argsort(torch.where(keep, pos, pos + n_cand), dim=1, stable=True)[:, :k]
        new_tok = s_toks.gather(1, sel).reshape(-1)
        new_score = s_scores.gather(1, sel).reshape(-1)
        flat_src = (audio_base + s_src.gather(1, sel)).reshape(-1)

        # finished buffer: EOT candidates appended until it is full, each
        # its source beam's row with EOT at this slot
        fpos = fin_count[:, None] + torch.cumsum(is_eot, dim=1) - 1
        fpos = torch.where(is_eot & (fpos < c_cap), fpos, c_cap)
        src_rows = buf.reshape(a, k, total).gather(1, s_src[:, :, None].expand(a, n_cand, total))
        src_rows[:, :, slot] = eot
        fin_tokens.scatter_(1, fpos[:, :, None].expand(a, n_cand, total), src_rows)
        fin_scores.scatter_(1, fpos, s_scores)
        fin_count = torch.clamp(fin_count + is_eot.sum(dim=1), max=c_cap)

        # reorder the state along the beam axis
        new_buf = buf.index_select(0, flat_src)
        new_buf[:, slot] = new_tok
        buf = torch.where(running, new_buf, buf)
        sum_lp = torch.where(running, new_score, sum_lp)
        n_steps = n_steps + running.long()
        last_ts = last_ts.index_select(0, flat_src)
        last_ts = torch.where(new_tok >= ts_begin, new_tok, last_ts)
        cache.select_rows(flat_src)
        t += 1
        if t < max_steps:
            hidden = decoder_forward(params, new_tok[:, None], cross, cache, slot, pad,
                                     n_head, compute_dtype, group=group)
            logits = project_logits(params, hidden)[:, 0]
    return (fin_tokens[:, :c_cap], fin_scores[:, :c_cap], fin_count, buf, sum_lp,
            no_speech, n_steps)


class MaximumLikelihoodRanker:
    """Highest sum logprob under length normalisation, or under the GNMT
    length penalty ((5 + length) / 6) ** alpha when one is given."""

    def __init__(self, length_penalty: Optional[float]):
        self.length_penalty = length_penalty

    def rank(self, tokens: List[List[List[int]]], sum_logprobs: List[List[float]]) -> List[int]:
        def scores(logprobs, lengths):
            result = []
            for logprob, length in zip(logprobs, lengths):
                if self.length_penalty is None:
                    penalty = length
                else:
                    penalty = ((5 + length) / 6) ** self.length_penalty
                # an empty sample ranks below any other instead of dividing by 0
                result.append(logprob / penalty if penalty != 0 else -np.inf)
            return result

        lengths = [[len(t) for t in s] for s in tokens]
        return [int(np.argmax(scores(p, l))) for p, l in zip(sum_logprobs, lengths)]


def _prefill_bucket(n: int) -> int:
    return next((b for b in PREFILL_BUCKETS if n <= b), n)


class DecodingTask:
    def __init__(self, model, options: DecodingOptions):
        self.model = model
        self.options = self._verify_options(options)
        self.spec_stats: Optional[dict] = None
        tokenizer = get_tokenizer(model.is_multilingual, language=options.language or "en",
                                  task=options.task)
        self.tokenizer: Tokenizer = tokenizer
        self.n_group = options.beam_size or options.best_of or 1
        self.n_ctx = model.dims.n_text_ctx
        self.sample_len = options.sample_len or self.n_ctx // 2
        self.sot_sequence = (tokenizer.sot_sequence_including_notimestamps
                             if options.without_timestamps else tokenizer.sot_sequence)
        self.initial_tokens: Tuple[int, ...] = self._get_initial_tokens()
        self.sot_index = self.initial_tokens.index(tokenizer.sot)
        self.sequence_ranker = MaximumLikelihoodRanker(options.length_penalty)
        self.with_ts_rules = not options.without_timestamps
        self.blank_token = tokenizer.encode(" ")[0]
        self.max_initial_ts_index = None
        if self.with_ts_rules and options.max_initial_timestamp:
            precision = CHUNK_LENGTH / model.dims.n_audio_ctx  # 0.02 s
            self.max_initial_ts_index = round(options.max_initial_timestamp / precision)
        mask = np.zeros(model.dims.n_vocab, np.float32)
        if options.suppress_tokens:
            mask[list(self._get_suppress_tokens())] = NEG_INF
        self.suppress_mask = torch.from_numpy(mask).to(model.device)

    def _verify_options(self, options: DecodingOptions) -> DecodingOptions:
        if options.beam_size is not None and options.best_of is not None:
            raise ValueError("beam_size and best_of can't be given together")
        if options.temperature == 0 and options.best_of is not None:
            raise ValueError("best_of with greedy sampling (T=0) is not compatible")
        if options.patience is not None and options.beam_size is None:
            raise ValueError("patience requires beam_size to be given")
        if options.length_penalty is not None and not 0 <= options.length_penalty <= 1:
            raise ValueError("length_penalty (alpha) should be a value between 0 and 1")
        for name in ("kv_bits", "weight_bits", "self_kv_bits"):
            if getattr(options, name) not in (8, 4):
                raise ValueError(f"{name} must be 8 or 4")
        if options.draft_model is not None:
            if options.temperature != 0:
                raise ValueError("draft_model requires temperature == 0 "
                                 "(speculative decoding is greedy-exact)")
            if options.beam_size is not None or options.best_of is not None:
                raise ValueError("draft_model is incompatible with beam_size/best_of")
            if options.self_kv_quant:
                raise ValueError("draft_model is incompatible with self_kv_quant (the "
                                 "per-row-position pass keeps a plain self cache)")
            if options.draft_model.dims.n_vocab != self.model.dims.n_vocab:
                raise ValueError("draft model must share the verifier's vocabulary")
            if options.draft_lookahead < 1:
                raise ValueError("draft_lookahead must be >= 1")
        if options.kv_layout not in (None, "fused", "heads"):
            raise ValueError(f"kv_layout must be 'fused' or 'heads', got {options.kv_layout!r}")
        return options

    def _get_initial_tokens(self) -> Tuple[int, ...]:
        tokens = list(self.sot_sequence)
        if prefix := self.options.prefix:
            ids = (self.tokenizer.encode(" " + prefix.strip())
                   if isinstance(prefix, str) else list(prefix))
            tokens += ids[-(self.n_ctx // 2 - self.sample_len):]
        if prompt := self.options.prompt:
            ids = (self.tokenizer.encode(" " + prompt.strip())
                   if isinstance(prompt, str) else list(prompt))
            tokens = [self.tokenizer.sot_prev] + ids[-(self.n_ctx // 2 - 1):] + tokens
        return tuple(tokens)

    def _get_suppress_tokens(self) -> Tuple[int, ...]:
        chosen = self.options.suppress_tokens
        if isinstance(chosen, str):
            chosen = [int(t) for t in chosen.split(",")]
        chosen = list(chosen or [])
        if -1 in chosen:
            chosen = [t for t in chosen if t >= 0] + list(self.tokenizer.non_speech_tokens)
        tok = self.tokenizer
        chosen += [tok.transcribe, tok.translate, tok.sot, tok.sot_prev, tok.sot_lm]
        if tok.no_speech is not None:
            chosen.append(tok.no_speech)
        return tuple(sorted(set(chosen)))

    def _detect_language(self, audio_features, buf, pad):
        languages = [self.options.language] * audio_features.shape[0]
        probs = None
        if self.options.language is None or self.options.task == "lang_id":
            lang_tokens, probs = detect_language_from_features(
                self.model, audio_features, self.tokenizer, self.options.fp16)
            languages = [max(p, key=p.get) for p in probs]
            if self.options.language is None:
                buf[:, pad + self.sot_index + 1] = lang_tokens
        return languages, probs

    def _loop_args(self, pad: int, prefill: int, max_steps: int, compute_dtype) -> dict:
        """The keyword arguments both sampling loops take."""
        options, tokenizer = self.options, self.tokenizer
        return dict(
            pad=pad, sot_slot=pad + self.sot_index, suppress_mask=self.suppress_mask,
            prefill=prefill, max_steps=max_steps, n_head=self.model.text_heads,
            compute_dtype=compute_dtype, eot=tokenizer.eot, ts_begin=tokenizer.timestamp_begin,
            blank_token=self.blank_token, no_speech_id=tokenizer.no_speech,
            max_initial_ts_index=self.max_initial_ts_index,
            suppress_blank=bool(options.suppress_blank), with_ts_rules=self.with_ts_rules,
            self_kv_quant=options.self_kv_quant, self_kv_bits=options.self_kv_bits)

    def run(self, mel: torch.Tensor) -> List[DecodingResult]:
        options, tokenizer, model = self.options, self.tokenizer, self.model
        n_audio = mel.shape[0]
        compute_dtype = model.compute_dtype(options.fp16)
        audio_features, at_features = model.embed_audio(mel, options.fp16)

        prefill = _prefill_bucket(len(self.initial_tokens))
        pad = prefill - len(self.initial_tokens)
        # the pad slots are masked and take no position: they do not count
        # against the n_ctx + 1 slots of the reference's token budget
        total = min(prefill + self.sample_len, self.n_ctx + 1 + pad)
        buf = torch.zeros((n_audio, total), dtype=torch.long, device=mel.device)
        buf[:, pad:prefill] = torch.tensor(self.initial_tokens, device=mel.device)

        languages, language_probs = self._detect_language(audio_features, buf, pad)
        if options.task == "lang_id":
            return [DecodingResult(audio_features=f, audio_features_for_at=a, language=lang,
                                   language_probs=p)
                    for f, a, lang, p in zip(audio_features, at_features, languages,
                                             language_probs)]

        # a group (beams, best-of samples) repeats the token rows only; the
        # cross K/V keep one row per audio and the group folds into the
        # cross-attention's query axis
        n_group = self.n_group
        buf = buf.repeat_interleave(n_group, dim=0)
        params = model.decoder_params_decode(options.weight_quant, options.weight_bits)
        cross = precompute_cross_kv(params, audio_features, model.text_heads,
                                    compute_dtype, quantize=options.kv_quant,
                                    bits=options.kv_bits)
        loop_args = self._loop_args(pad, prefill, total - prefill, compute_dtype)
        if options.beam_size is not None:
            tokens, logprobs, no_speech = self._run_beam(params, cross, buf, loop_args)
        else:
            if options.draft_model is not None:
                buf, sum_lp, no_speech = self._run_spec(mel, compute_dtype, params, cross,
                                                        buf, loop_args)
            else:
                generator = None
                if options.temperature > 0:
                    generator = torch.Generator(device=mel.device)
                    generator.manual_seed(int(np.random.randint(0, 2**31 - 1)))
                buf, sum_lp, no_speech, _ = greedy_sample_loop(
                    params, cross, buf, temperature=options.temperature,
                    generator=generator, **loop_args)
            sampled = buf[:, prefill:].cpu().numpy()
            sum_lp = sum_lp.cpu().numpy()
            rows = [self._until_eot(row) for row in sampled]
            tokens = [rows[i * n_group:(i + 1) * n_group] for i in range(n_audio)]
            logprobs = [[float(lp) for lp in sum_lp[i * n_group:(i + 1) * n_group]]
                        for i in range(n_audio)]
            no_speech = no_speech.float().cpu().numpy()[::n_group]

        selected = self.sequence_ranker.rank(tokens, logprobs)
        results = []
        for i, pick in enumerate(selected):
            text = tokenizer.decode(tokens[i][pick]).strip()
            results.append(DecodingResult(
                audio_features=audio_features[i], audio_features_for_at=at_features[i],
                language=languages[i], tokens=tokens[i][pick], text=text,
                avg_logprob=logprobs[i][pick] / (len(tokens[i][pick]) + 1),
                no_speech_prob=float(no_speech[i]), temperature=options.temperature,
                compression_ratio=compression_ratio(text), spec_stats=self.spec_stats))
        return results

    def _run_spec(self, mel, compute_dtype, params, cross, buf, loop_args: dict):
        """Speculative greedy decoding (`spec_sample_loop`): the draft model
        runs its own encoder over the same mel, and decodes on its plain
        fused weights and plain cross K/V. Returns the loop's buf, sum
        logprobs and no-speech probabilities; its counts go to
        `self.spec_stats` and `_LAST_SPEC_STATS`."""
        draft, options = self.options.draft_model, self.options
        draft_features, _ = draft.embed_audio(mel, options.fp16)
        draft_params = draft.decoder_params_decode()
        draft_cross = precompute_cross_kv(draft_params, draft_features,
                                          draft.text_heads, compute_dtype)
        buf, sum_lp, no_speech, self.spec_stats = spec_sample_loop(
            params, cross, draft_params, draft_cross, buf,
            lookahead=options.draft_lookahead, n_head_draft=draft.text_heads,
            **loop_args)
        _SPEC_STATS.stats = self.spec_stats
        return buf, sum_lp, no_speech

    def _until_eot(self, row: np.ndarray) -> List[int]:
        """A row of sampled tokens up to its first EOT (all of it if none)."""
        row = np.append(row, self.tokenizer.eot)
        return row[:int(np.argmax(row == self.tokenizer.eot))].tolist()

    def _run_beam(self, params, cross, buf, loop_args: dict):
        """Beam search, then the JAX package's host-side finalisation: the
        finished sequences, topped up from the final beams in score order
        when fewer than beam_size finished. Returns (tokens, sum logprobs)
        per audio and candidate, and the no-speech probability per audio."""
        beam_size = self.options.beam_size
        max_candidates = round(beam_size * (self.options.patience or 1.0))
        if max_candidates <= 0:
            raise ValueError(f"Invalid beam size ({beam_size}) or patience "
                             f"({self.options.patience})")
        out = beam_sample_loop(params, cross, buf, beam_size=beam_size,
                               max_candidates=max_candidates, **loop_args)
        fin_tokens, fin_scores, fin_count, beams, beam_lp, no_speech, n_steps = (
            x.float().cpu().numpy() if x.dtype.is_floating_point else x.cpu().numpy()
            for x in out)
        n_steps = int(n_steps)
        prefill = loop_args["prefill"]

        def slice_row(row) -> List[int]:
            return self._until_eot(row[prefill:prefill + n_steps])

        tokens, logprobs = [], []
        for i in range(fin_count.shape[0]):
            seqs = [slice_row(fin_tokens[i, c]) for c in range(int(fin_count[i]))]
            scores = [float(fin_scores[i, c]) for c in range(int(fin_count[i]))]
            if len(seqs) < beam_size:
                group_lp = beam_lp[i * beam_size:(i + 1) * beam_size]
                for j in np.argsort(group_lp)[::-1]:
                    seqs.append(slice_row(beams[i * beam_size + int(j)]))
                    scores.append(float(group_lp[int(j)]))
                    if len(seqs) >= beam_size:
                        break
            tokens.append(seqs)
            logprobs.append(scores)
        return tokens, logprobs, no_speech[::beam_size]


def detect_language_from_features(model, audio_features: torch.Tensor,
                                  tokenizer: Tokenizer, fp16: bool = True):
    """One start-of-transcript step -> (language tokens [B], probability dicts)."""
    n = audio_features.shape[0]
    sot = torch.full((n, 1), tokenizer.sot, dtype=torch.long, device=audio_features.device)
    logits = model.logits(sot, audio_features, fp16=fp16)[:, 0]
    lang_ids = torch.tensor(tokenizer.all_language_tokens, device=logits.device)
    mask = torch.full_like(logits[0], NEG_INF)
    mask[lang_ids] = 0.0
    masked = logits + mask
    probs = torch.softmax(masked, dim=-1)[:, lang_ids].cpu().numpy()
    codes = tokenizer.all_language_codes
    return masked.argmax(dim=-1), [
        {c: float(p) for c, p in zip(codes, row)} for row in probs]


def detect_language(model, mel: torch.Tensor, tokenizer: Optional[Tokenizer] = None):
    """Spoken language of mel [80, 3000] or [B, 80, 3000] (or encoded
    features [B, 1500, D]): (language tokens, probability dicts)."""
    if tokenizer is None:
        tokenizer = get_tokenizer(model.is_multilingual)
    if tokenizer.language is None or tokenizer.language_token not in tokenizer.sot_sequence:
        raise ValueError("This model doesn't have language tokens so it can't perform lang id")
    single = mel.dim() == 2
    if single:
        mel = mel[None]
    if tuple(mel.shape[-2:]) != (model.dims.n_audio_ctx, model.dims.n_audio_state):
        mel, _ = model.embed_audio(mel)
    tokens, probs = detect_language_from_features(model, mel, tokenizer)
    return (tokens[0], probs[0]) if single else (tokens, probs)


def decode(model, mel: torch.Tensor, options: DecodingOptions = DecodingOptions(),
           **kwargs) -> Union[DecodingResult, List[DecodingResult]]:
    """Decode 30 s mel window(s): [80, 3000] or [B, 80, 3000]."""
    single = mel.dim() == 2
    if single:
        mel = mel[None]
    if kwargs:
        options = replace(options, **kwargs)
    results = DecodingTask(model, options).run(mel)
    return results[0] if single else results
