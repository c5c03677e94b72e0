"""The comparison that decides `correct`.

Once the window has closed and the program's state is freed, a sample of
the windows the timed calls transcribed, drawn from the seed, is worked out
again by the plain float32 reference (`reference/`) from the same audio and
the same weights, with the decoder's int8 codes the configuration states
worked out again there (`decoder_quant`), and these numbers are read:

  tag_err        the widest gap between the program's TL-TR logits of the
                 sampled windows (`audio_tag`) and the reference's, over
                 the reference's largest magnitude there
  no_speech_err  the widest gap between the log of a window's
                 `no_speech_prob` as the program returned it and the
                 reference's (the decoder's prefill over the cross K/V)
  token_gap      the widest gap by which a served token's logit lies below
                 the reference's best allowed logit at its position (the
                 reference run once over each prompt with its served tokens)
  logprob_err    the widest gap between a window's `avg_logprob` as the
                 program returned it and the reference's over the same
                 tokens
  missing        sampled windows for which no answer came back

A number is compared when `limits/<cell>.json` gives it a limit; the
readings each limit was set from are in PERF.md.

The control goes through the same comparison: `reference_as_program`
answers the sampled windows with the reference one precision lower, in the
form of the program's results.
"""

import json
import os
from typing import Dict, List

import numpy as np
import torch

from .reference import Reference, allowed_mask, log_mel, mel_window, served_token_gaps

N_FRAMES = 3000
TAG_CELL_FRAMES = 1000  # at_time_res 10 s
ENCODE_BLOCK = 4  # windows the reference encodes at once


def decoder_quant(config: dict) -> Dict[str, int]:
    """The decoder's quantization the configuration states, for the
    reference: bits of the weights, the cross K/V and the self cache."""
    program = config["program"]
    quant = {}
    if program.get("weight_quant"):
        quant["weight_bits"] = program.get("weight_bits", 8)
    if program.get("kv_quant"):
        quant["kv_bits"] = program.get("kv_bits", 8)
    if program.get("self_kv_quant"):
        quant["self_kv_bits"] = program.get("self_kv_bits", 8)
    return quant


def load_limits(root: str, cell: str) -> Dict[str, float]:
    with open(os.path.join(root, "limits", f"{cell}.json")) as f:
        return json.load(f)["limits"]


def sample_windows(calls: List[dict], n: int, seed: int) -> List[tuple]:
    """n (call, file, window) triples drawn from the seed among every window
    the calls transcribed (all of them when there are fewer)."""
    every = [(c, f, w) for c, call in enumerate(calls)
             for f, n_win in enumerate(call["windows"]) for w in range(n_win)]
    rng = np.random.default_rng(int(seed) % (1 << 63))
    pick = rng.choice(len(every), size=min(n, len(every)), replace=False)
    return sorted(every[i] for i in pick)


def _answer(result: dict, w: int):
    """(tokens, the tokens their positions follow, avg_logprob,
    no_speech_prob) of window w's segment, or None. The positions follow
    the tokens themselves unless the segment names its `context` (the
    control's answers follow the program's tokens)."""
    for seg in result["segments"]:
        if seg["seek"] == w * N_FRAMES:
            return (seg["tokens"], seg.get("context", seg["tokens"]), seg["avg_logprob"],
                    seg["no_speech_prob"])
    return None


def _sampled_blocks(calls: List[dict], pool, items: List[tuple], device):
    """(block of items, their mel windows [n, 80, 3000]) in blocks of
    ENCODE_BLOCK, each recording's mel worked out once."""
    mels = {}
    for lo in range(0, len(items), ENCODE_BLOCK):
        block = items[lo:lo + ENCODE_BLOCK]
        wins = []
        for c, f, w in block:
            key = (calls[c]["pool"], f)
            if key not in mels:
                mels[key] = log_mel(pool[calls[c]["pool"]][f], device)
            wins.append(mel_window(mels[key], w))
        yield block, torch.stack(wins)


def _cells_of(w: int, n_cells: int, n_seg: int) -> slice:
    first = w * N_FRAMES // TAG_CELL_FRAMES
    return slice(first, min(n_cells, first + n_seg))


def readings(window: dict, pool, sd, config: dict, mix: dict, seed: int, device
             ) -> Dict[str, float]:
    """The numbers of a closed loop's window: `compare` over its calls."""
    return compare(window["calls"], pool, sd, config, mix["check_windows"], seed, device)


def compare(calls: List[dict], pool, sd, config: dict, n_windows: int, seed: int,
            device, detail: bool = False) -> Dict[str, float]:
    """Read the numbers over a seeded sample of the calls' windows against
    the float32 reference on `sd`. calls: [{"pool": pool index, "windows":
    [windows per file], "results": [result dict per file]}]; pool: the
    recordings of each pool entry. With `detail`, also the per-window
    readings under "per_window"."""
    ref = Reference(sd, config["dims"], config["at_mode"], decoder_quant(config))
    tok = config["tokens"]
    prompt = list(tok["prompt_en_transcribe_notimestamps"])
    allowed = allowed_mask(config["dims"]["n_vocab"], tok["suppress"], tok["suppress_from"],
                           device)
    items = sample_windows(calls, n_windows, seed)
    tag_num = tag_den = 0.0
    per = {"logprob_diff": [], "gap": [], "gaps_nonzero": [], "no_speech_diff": []}
    missing = 0
    for block, mel in _sampled_blocks(calls, pool, items, device):
        features, taps = ref.encode(mel)
        tags = ref.tags(taps)
        for j, (c, f, w) in enumerate(block):
            result = calls[c]["results"][f]
            grid = np.asarray(result["audio_tag"])
            cells = _cells_of(w, grid.shape[0], tags.shape[1])
            want = tags[j, :cells.stop - cells.start].cpu().numpy()
            tag_num = max(tag_num, float(np.abs(grid[cells] - want).max()))
            tag_den = max(tag_den, float(np.abs(want).max()))
            answer = _answer(result, w)
            if answer is None:
                missing += 1
                continue
            served, context, avg_logprob, no_speech = answer
            row = torch.tensor([prompt + list(context)], device=device)
            logits = ref.logits(row, features[j:j + 1])[0]
            at = logits[len(prompt) - 1:len(prompt) - 1 + len(served)]
            gaps, logprobs = served_token_gaps(at, torch.tensor(list(served), device=device),
                                               allowed, tok["suppress_at_first"])
            per["gap"].append(float(gaps.max()))
            per["gaps_nonzero"].append(int((gaps > 0).sum()))
            per["logprob_diff"].append(float(avg_logprob)
                                       - float(logprobs.sum()) / (len(served) + 1))
            ns_ref = torch.log_softmax(logits[0], dim=-1)[tok["no_speech"]]
            per["no_speech_diff"].append(float(np.log(max(no_speech, 1e-38)) - float(ns_ref)))
    out = {"tag_err": tag_num / max(tag_den, 1e-30),
           "no_speech_err": max(map(abs, per["no_speech_diff"]), default=0.0),
           "token_gap": max(per["gap"], default=0.0),
           "logprob_err": max(map(abs, per["logprob_diff"]), default=0.0),
           "missing": float(missing), "windows": float(len(items))}
    if detail:
        out["per_window"] = per
    return out


def reference_as_program(calls: List[dict], pool, sd, config: dict, n_windows: int,
                         seed: int, device, matmul_bits: str = "fp8") -> List[dict]:
    """The control with the reference put in the program's place, one
    precision below the bf16 the configuration states (`Reference(...,
    matmul_bits="fp8")`: float8 e4m3 operands), answering the windows that
    `compare` samples from `calls` with the same seed, in the form of the
    program's results: the TL-TR logits of their tag cells, the no-speech
    probability of the prefill, and at each position of the program's
    prompt and served tokens the token the control puts first (`context`:
    the program's tokens those positions follow) with its avg_logprob.
    Hand the result to `compare` in the program's place."""
    low = Reference(sd, config["dims"], config["at_mode"], decoder_quant(config),
                    matmul_bits=matmul_bits)
    tok = config["tokens"]
    prompt = list(tok["prompt_en_transcribe_notimestamps"])
    allowed = allowed_mask(config["dims"]["n_vocab"], tok["suppress"], tok["suppress_from"],
                           device)
    first = torch.as_tensor(list(tok["suppress_at_first"]), device=device)
    out = [{"pool": call["pool"], "windows": call["windows"],
            "results": [{"audio_tag": np.zeros_like(np.asarray(r["audio_tag"])),
                         "segments": []} for r in call["results"]]} for call in calls]
    items = sample_windows(calls, n_windows, seed)
    for block, mel in _sampled_blocks(calls, pool, items, device):
        features, taps = low.encode(mel)
        tags = low.tags(taps).cpu().numpy()
        for j, (c, f, w) in enumerate(block):
            result = out[c]["results"][f]
            cells = _cells_of(w, result["audio_tag"].shape[0], tags.shape[1])
            result["audio_tag"][cells] = tags[j, :cells.stop - cells.start]
            answer = _answer(calls[c]["results"][f], w)
            if answer is None:
                continue
            served = list(answer[0])
            row = torch.tensor([prompt + served], device=device)
            logits = low.logits(row, features[j:j + 1])[0]
            at = logits[len(prompt) - 1:len(prompt) - 1 + len(served)]
            mask = allowed[None, :].repeat(at.shape[0], 1)
            mask[0, first] = False
            picks = at.masked_fill(~mask, float("-inf")).argmax(dim=-1)
            _, logprobs = served_token_gaps(at, picks, allowed, tok["suppress_at_first"])
            no_speech = torch.log_softmax(logits[0], dim=-1)[tok["no_speech"]]
            result["segments"].append({
                "seek": w * N_FRAMES, "tokens": picks.tolist(), "context": served,
                "avg_logprob": float(logprobs.sum()) / (len(served) + 1),
                "no_speech_prob": float(torch.exp(no_speech))})
    return out


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each compared number beside its limit, with whether it holds."""
    return {name: {"value": readings[name], "limit": limit,
                   "ok": bool(readings[name] <= limit)}
            for name, limit in limits.items()}
