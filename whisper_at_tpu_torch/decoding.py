"""Decoding: options, the logit filters as tensor ops, and greedy/temperature
sampling as a Python loop over steps on the device.

Counterpart of `whisper_at_tpu/decoding.py` (greedy path). The JAX package
runs the whole loop as one device program; here each step is one decoder
pass and a few tensor ops, and the host checks every few steps whether
every row has finished. Beam search, best-of sampling, speculative
decoding and the int4 options are not ported yet and raise
NotImplementedError.
"""

from dataclasses import dataclass, field, replace
from typing import Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from .audio import CHUNK_LENGTH
from .models.decoder import decoder_forward, init_cache, precompute_cross_kv, project_logits
from .tokenizer import Tokenizer, get_tokenizer
from .utils import compression_ratio

NEG_INF = float("-inf")
PREFILL_BUCKETS = (4, 8, 16, 32, 64, 128, 224, 256)
FINISH_CHECK_EVERY = 8  # steps between host checks that every row ended


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
    kv_quant: bool = False            # int8 cross-attention K/V (K3 + K4)
    weight_quant: bool = False        # int8 decoder matmul weights
    weight_bits: int = 8
    self_kv_quant: bool = False       # int8 self-attention cache
    self_kv_bits: int = 8
    kv_layout: Optional[str] = None   # only the fused K3/K4 layout is ported
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


def apply_logit_filters(logits: torch.Tensor, t: int, prev1: torch.Tensor,
                        prev2: torch.Tensor, last_ts: torch.Tensor,
                        suppress_mask: torch.Tensor, *, eot: int, ts_begin: int,
                        blank_token: int, max_initial_ts_index: Optional[int],
                        suppress_blank: bool, with_ts_rules: bool) -> torch.Tensor:
    """Suppress-blank, suppress-tokens and the timestamp rules on [B, V]
    logits at sampled step t. prev1/prev2 are the tokens sampled at steps
    t-1 and t-2 (ignored before they exist); last_ts is each row's latest
    sampled timestamp token, or -1."""
    idx = torch.arange(logits.shape[-1], device=logits.device)[None, :]
    at_start = t == 0
    if suppress_blank and at_start:
        logits = logits.masked_fill((idx == blank_token) | (idx == eot), NEG_INF)
    logits = logits + suppress_mask[None, :]
    if not with_ts_rules:
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
    if at_start:
        logits = logits.masked_fill(idx < ts_begin, NEG_INF)
        if max_initial_ts_index is not None:
            logits = logits.masked_fill(idx > ts_begin + max_initial_ts_index, NEG_INF)
    # if the timestamps together are likelier than any text token, sample a
    # timestamp (the softmax normaliser cancels, so raw logits compare)
    ts_mass = torch.logsumexp(logits.masked_fill(idx < ts_begin, NEG_INF), dim=-1)
    max_text = logits.masked_fill(idx >= ts_begin, NEG_INF).amax(dim=-1)
    return logits.masked_fill((ts_mass > max_text)[:, None] & (idx < ts_begin), NEG_INF)


def greedy_sample_loop(params, cross, buf: torch.Tensor, *, pad: int, sot_slot: int,
                       suppress_mask: torch.Tensor, temperature: float,
                       generator: Optional[torch.Generator], prefill: int, max_steps: int,
                       n_head: int, compute_dtype, eot: int, ts_begin: int,
                       blank_token: int, no_speech_id: Optional[int],
                       max_initial_ts_index: Optional[int], suppress_blank: bool,
                       with_ts_rules: bool, self_kv_quant: bool = False):
    """Sample up to max_steps tokens into buf [B, total] (slots from
    `prefill` on), greedily at temperature 0. Returns (buf, sum_logprobs [B],
    no_speech_probs [B], steps run); rows keep EOT once they emit it."""
    b, total = buf.shape
    group = b // cross.k.shape[1]
    d = params.token_embedding.weight.shape[1]
    cache = init_cache(len(params.blocks), b, total, d, compute_dtype, n_head,
                       quantize=self_kv_quant, device=buf.device)
    hidden = decoder_forward(params, buf[:, :prefill], cross, cache, 0, pad, n_head,
                             compute_dtype, group=group)
    if no_speech_id is not None:
        sot_logits = project_logits(params, hidden[:, sot_slot:sot_slot + 1])[:, 0]
        no_speech = torch.softmax(sot_logits, dim=-1)[:, no_speech_id]
    else:
        no_speech = torch.full((b,), float("nan"), device=buf.device)
    logits = project_logits(params, hidden[:, -1:])[:, 0]

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


def _prefill_bucket(n: int) -> int:
    return next((b for b in PREFILL_BUCKETS if n <= b), n)


class DecodingTask:
    def __init__(self, model, options: DecodingOptions):
        self.model = model
        self.options = self._verify_options(options)
        tokenizer = get_tokenizer(model.is_multilingual, language=options.language or "en",
                                  task=options.task)
        self.tokenizer: Tokenizer = tokenizer
        self.n_ctx = model.dims.n_text_ctx
        self.sample_len = options.sample_len or self.n_ctx // 2
        self.sot_sequence = (tokenizer.sot_sequence_including_notimestamps
                             if options.without_timestamps else tokenizer.sot_sequence)
        self.initial_tokens: Tuple[int, ...] = self._get_initial_tokens()
        self.sot_index = self.initial_tokens.index(tokenizer.sot)
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

    @staticmethod
    def _verify_options(options: DecodingOptions) -> DecodingOptions:
        if options.beam_size is not None or options.patience is not None:
            raise NotImplementedError("beam search is not ported yet")
        if options.best_of is not None:
            raise NotImplementedError("best_of sampling is not ported yet")
        if options.draft_model is not None:
            raise NotImplementedError("speculative decoding is not ported yet")
        if options.kv_bits != 8 or options.weight_bits != 8 or options.self_kv_bits != 8:
            raise NotImplementedError("only 8-bit quantization is ported")
        if options.kv_layout not in (None, "fused"):
            raise NotImplementedError("only the fused cross-KV layout is ported")
        if options.length_penalty is not None and not 0 <= options.length_penalty <= 1:
            raise ValueError("length_penalty (alpha) should be a value between 0 and 1")
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

    def run(self, mel: torch.Tensor) -> List[DecodingResult]:
        options, tokenizer, model = self.options, self.tokenizer, self.model
        n_audio = mel.shape[0]
        compute_dtype = model.compute_dtype(options.fp16)
        audio_features, at_features = model.embed_audio(mel, options.fp16)

        prefill = _prefill_bucket(len(self.initial_tokens))
        total = min(prefill + self.sample_len, self.n_ctx + 1)
        pad = prefill - len(self.initial_tokens)
        buf = torch.zeros((n_audio, total), dtype=torch.long, device=mel.device)
        buf[:, pad:prefill] = torch.tensor(self.initial_tokens, device=mel.device)

        languages, language_probs = self._detect_language(audio_features, buf, pad)
        if options.task == "lang_id":
            return [DecodingResult(audio_features=f, audio_features_for_at=a, language=lang,
                                   language_probs=p)
                    for f, a, lang, p in zip(audio_features, at_features, languages,
                                             language_probs)]

        params = model.decoder_params_decode(options.weight_quant, options.weight_bits)
        cross = precompute_cross_kv(params, audio_features, model.dims.n_text_head,
                                    compute_dtype, quantize=options.kv_quant)
        generator = None
        if options.temperature > 0:
            generator = torch.Generator(device=mel.device)
            generator.manual_seed(int(np.random.randint(0, 2**31 - 1)))
        buf, sum_lp, no_speech, _ = greedy_sample_loop(
            params, cross, buf, pad=pad, sot_slot=pad + self.sot_index,
            suppress_mask=self.suppress_mask, temperature=options.temperature,
            generator=generator, prefill=prefill, max_steps=total - prefill,
            n_head=model.dims.n_text_head, compute_dtype=compute_dtype,
            eot=tokenizer.eot, ts_begin=tokenizer.timestamp_begin,
            blank_token=self.blank_token, no_speech_id=tokenizer.no_speech,
            max_initial_ts_index=self.max_initial_ts_index,
            suppress_blank=bool(options.suppress_blank), with_ts_rules=self.with_ts_rules,
            self_kv_quant=options.self_kv_quant)

        sampled = buf[:, prefill:].cpu().numpy()
        sum_lp = sum_lp.cpu().numpy()
        no_speech = no_speech.float().cpu().numpy()
        results = []
        for i in range(n_audio):
            row = np.append(sampled[i], tokenizer.eot)
            tokens = row[:int(np.argmax(row == tokenizer.eot))].tolist()
            text = tokenizer.decode(tokens).strip()
            results.append(DecodingResult(
                audio_features=audio_features[i], audio_features_for_at=at_features[i],
                language=languages[i], tokens=tokens, text=text,
                avg_logprob=float(sum_lp[i]) / (len(tokens) + 1),
                no_speech_prob=float(no_speech[i]), temperature=options.temperature,
                compression_ratio=compression_ratio(text)))
        return results


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
