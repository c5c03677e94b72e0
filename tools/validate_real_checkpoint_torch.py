#!/usr/bin/env python3
"""Validate the PyTorch port against real released checkpoints, end to end.

The port of `tools/validate_real_checkpoint.py`, with the same flags, stages,
printed lines and failure names, plus `--device` (default `cuda`, as the
port's command line). It checks the reference's parity contract (transcripts
identical to OpenAI Whisper, AudioSet tag logits from the released TL-TR
heads) on weights the user puts in place: nothing is fetched.

  stage 1  load        an official name read from --download-root, or a
                       local --checkpoint / --at-checkpoint pair -> model
  stage 2  activations the port on --device against the fp32 torch oracle
                       (tests/oracle_torch.py) on one mel window: encoder
                       features, TL-TR tag logits, decoder logits over the
                       start-of-transcript prefix
  stage 3  transcribe  the sequential transcribe; --expect substring check
                       through the port's EnglishTextNormalizer
  stage 4  batched     transcribe_batched on the plain cross K/V; tags
                       finite over 527 classes, the top 3 by parse_at_label
  stage 5  quant       int8 cross K/V + int8 weights, the int4 cross-K/V
                       opt-in, and the int8 cross K/V from the kernel (K3)
                       against its plain version on the same card tensors:
                       tokens identical (K3's codes are bitwise)
  stage 5b reference   the literal reference package (only when
                       --reference-package is given and holds one) runs the
                       port's own state dict on the same audio: tokens and
                       tag logits
  stage 5c draft       (--draft SIZE) speculative tokens against plain
                       greedy's, and the tokens a round
  stage 6  goldens     transcript and tag goldens to an .npz (--out)

Each stage is a function that returns its failures (and what it measured),
so another script can call the stages one by one.

Usage:
  python3 tools/validate_real_checkpoint_torch.py --model tiny \\
      --download-root ~/.cache/whisper --audio clip.wav \\
      --expect "and so my fellow americans" --out goldens_tiny.npz
  python3 tools/validate_real_checkpoint_torch.py --checkpoint tiny.pt \\
      --at-checkpoint tiny_ori.pth --audio clip.wav [--device cpu]
"""

import argparse
import contextlib
import functools
import importlib.util
import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SOT_MULTILINGUAL = [50258, 50259, 50359, 50364]
SOT_ENGLISH = [50257, 50362]


def _load_by_path(name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tests", name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def load_oracle():
    """tests/oracle_torch.py: the reference Whisper-AT math in fp32 torch on
    the CPU, over the JAX parameter layout. Its `_unstack` takes a layer of
    the stacked blocks with `jax.tree.map`; it is given a dict walk of its
    own, so the oracle runs where JAX is not installed."""
    oracle = _load_by_path("oracle_torch")
    oracle._unstack = lambda stacked, i: _tree_map(lambda a: np.asarray(a)[i], stacked)
    return oracle


# --------------------------------------------------------------------------- #
# the port's state dict -> the JAX parameter layout (the inverse of
# whisper_at_tpu_torch/convert.py::from_jax_params)
# --------------------------------------------------------------------------- #

def _arr(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def _linear(sd: dict, prefix: str) -> dict:
    out = {"w": _arr(sd[prefix + ".weight"]).T.copy()}
    if prefix + ".bias" in sd:
        out["b"] = _arr(sd[prefix + ".bias"])
    return out


def _ln(sd: dict, prefix: str) -> dict:
    return {"scale": _arr(sd[prefix + ".weight"]), "bias": _arr(sd[prefix + ".bias"])}


def _block(sd: dict, prefix: str) -> dict:
    out = {}
    for attn in ("attn", "cross_attn"):
        if f"{prefix}.{attn}.query.weight" not in sd:
            continue
        out[attn] = {p: _linear(sd, f"{prefix}.{attn}.{p}")
                     for p in ("query", "key", "value", "out")}
        out[attn + "_ln"] = _ln(sd, f"{prefix}.{attn}_ln")
    out["mlp"] = {"fc1": _linear(sd, prefix + ".mlp.0"), "fc2": _linear(sd, prefix + ".mlp.2")}
    out["mlp_ln"] = _ln(sd, prefix + ".mlp_ln")
    return out


def _stack(sd: dict, prefix: str) -> dict:
    n = 1 + max(int(k[len(prefix) + 1:].split(".")[0]) for k in sd if k.startswith(prefix + "."))
    layers = [_block(sd, f"{prefix}.{i}") for i in range(n)]

    def zip_trees(trees):
        return {k: zip_trees([t[k] for t in trees]) if isinstance(trees[0][k], dict)
                else np.stack([t[k] for t in trees]) for k in trees[0]}
    return zip_trees(layers)


def to_jax_params(state_dict: Dict[str, torch.Tensor]) -> dict:
    """The JAX package's parameter tree (fp32 numpy) of a port state dict:
    linear weights [in, out], conv weights [3, in, out], layer norms
    {scale, bias}, the blocks of each stack on a leading layer axis."""
    sd = state_dict
    enc = {conv: {"w": _arr(sd[f"encoder.{conv}.weight"]).transpose(2, 1, 0).copy(),
                  "b": _arr(sd[f"encoder.{conv}.bias"])} for conv in ("conv1", "conv2")}
    enc["positional_embedding"] = _arr(sd["encoder.positional_embedding"])
    enc["blocks"] = _stack(sd, "encoder.blocks")
    enc["ln_post"] = _ln(sd, "encoder.ln_post")
    dec = {"token_embedding": _arr(sd["decoder.token_embedding.weight"]),
           "positional_embedding": _arr(sd["decoder.positional_embedding"]),
           "blocks": _stack(sd, "decoder.blocks"), "ln": _ln(sd, "decoder.ln")}
    head = {"time_tr": _block(sd, "at_model.time_tr"),
            "layer_tr": _block(sd, "at_model.layer_tr"),
            "mlp_ln": _ln(sd, "at_model.mlp_layer.0"),
            "mlp": _linear(sd, "at_model.mlp_layer.1")}
    if "at_model.down_layer.1.weight" in sd:
        head["down_ln"] = _ln(sd, "at_model.down_layer.0")
        head["down"] = _linear(sd, "at_model.down_layer.1")
    return {"encoder": enc, "decoder": dec, "at_model": head}


# --------------------------------------------------------------------------- #
# printing and the tokens each window decoded
# --------------------------------------------------------------------------- #

def stage(name: str) -> None:
    print(f"\n=== stage: {name} ===", flush=True)


def check(ok, msg: str) -> bool:
    print(("PASS  " if ok else "FAIL  ") + msg, flush=True)
    return bool(ok)


@contextlib.contextmanager
def window_tokens():
    """The tokens of every window each `DecodingTask.run` in the block
    decoded, in order (a list, filled as the block runs)."""
    from whisper_at_tpu_torch.decoding import DecodingTask

    tokens, run = [], DecodingTask.run

    def keeping(self, mel):
        results = run(self, mel)
        tokens.extend(list(r.tokens) for r in results)
        return results

    DecodingTask.run = keeping
    try:
        yield tokens
    finally:
        DecodingTask.run = run


@contextlib.contextmanager
def plain_k3():
    """Within the block the decoder quantizes its cross K/V with K3's plain
    PyTorch version instead of the kernel (int8 entry)."""
    from whisper_at_tpu_torch.models import decoder
    from whisper_at_tpu_torch.ops import kv_quant

    kernel = decoder.project_quantize_kv
    decoder.project_quantize_kv = functools.partial(kv_quant.project_quantize_kv_plain, bits=8)
    try:
        yield
    finally:
        decoder.project_quantize_kv = kernel


def _normalized(text: str) -> str:
    from whisper_at_tpu_torch.normalizers import EnglishTextNormalizer

    return EnglishTextNormalizer()(text)


# --------------------------------------------------------------------------- #
# the stages: each returns (failures, what it measured)
# --------------------------------------------------------------------------- #

def load_stage(model_name: Optional[str], checkpoint: Optional[str],
               at_checkpoint: Optional[str], download_root: Optional[str], fp32: bool,
               device: str) -> Tuple[List[str], tuple]:
    """Stage 1: (failures, (model, its name))."""
    import whisper_at_tpu_torch as wat

    stage("load")
    dtype = torch.float32 if fp32 else None
    if model_name is not None:
        model = wat.load_model(model_name, device=device, download_root=download_root,
                               dtype=dtype)
        name = model_name
    else:
        model = wat.load_model(checkpoint, device=device, at_checkpoint=at_checkpoint,
                               dtype=dtype)
        name = os.path.basename(checkpoint)
    d = model.dims
    failures = []
    if not check(True, f"loaded {name}: {d.n_audio_layer}L audio / {d.n_text_layer}L text / "
                       f"{d.n_audio_state}d on {model.device}"):
        failures.append("load")
    return failures, (model, name)


def activations_stage(model, audio: np.ndarray, fp16: bool, atol: float,
                      rel: Optional[float] = None) -> Tuple[List[str], dict]:
    """Stage 2: the port's encoder features, TL-TR tag logits and decoder
    logits over the SOT prefix, on the model's device in its compute dtype,
    against the fp32 oracle on the CPU. A check passes when its largest
    difference is under `atol`; with `rel`, also when it is within `rel`
    times the oracle's largest magnitude (the bound for a bf16 path).
    Returns {check: (largest difference, oracle's largest magnitude)}."""
    from whisper_at_tpu_torch.audio import N_FRAMES, N_SAMPLES, log_mel_spectrogram, pad_or_trim
    from whisper_at_tpu_torch.models.decoder import (
        decoder_forward,
        init_cache,
        precompute_cross_kv,
        project_logits,
    )

    stage("activations (fp32 torch oracle)")
    oracle = load_oracle()
    d = model.dims
    dtype = model.compute_dtype(fp16)
    params32 = to_jax_params(model.state_dict())
    mel = pad_or_trim(log_mel_spectrogram(audio[:N_SAMPLES], device=model.device), N_FRAMES)
    with torch.no_grad():
        feats, taps = model.embed_audio(mel[None], fp16)
        tags = model.at_forward(taps, 10)
        sot = SOT_MULTILINGUAL if model.is_multilingual else SOT_ENGLISH
        tokens = torch.tensor([sot], device=model.device)
        params = model.decoder_params_decode()
        cross = precompute_cross_kv(params, feats, model.text_heads, dtype)
        cache = init_cache(len(params.blocks), 1, len(sot), params.width, dtype,
                           model.text_heads, device=model.device)
        hidden = decoder_forward(params, tokens, cross, cache, 0, 0, model.text_heads, dtype)
        logits = project_logits(params, hidden)[0]

        mel_np = mel.float().cpu().numpy()
        o_feats, o_taps = oracle.encoder(params32["encoder"], mel_np[None], d.n_audio_head)
        o_feats = o_feats.numpy()
        o_tags = oracle.at_head(params32["at_model"], o_taps[0].numpy(), model.at_mode, 10,
                                label_dim=int(tags.shape[-1])).numpy()
        o_logits = oracle.decoder_logits(params32["decoder"], np.asarray([sot]), o_feats,
                                         d.n_text_head).numpy()[0]
    diffs = {}
    failures = []
    for key, name, ours, ref in (
            ("encoder", "encoder feats", feats[0], o_feats[0]),
            ("tags", "TL-TR tag logits", tags[0], o_tags),
            ("decoder", "decoder logits", logits, o_logits)):
        err = float(np.abs(ours.float().cpu().numpy() - ref).max())
        scale = float(np.abs(ref).max())
        diffs[key] = (err, scale)
        ok = err < atol or (rel is not None and err <= rel * scale)
        bound = f" (or within {rel:g} x {scale:.3g} = {rel * scale:.3g})" if rel else ""
        if not check(ok, f"{name} max|Δ|={err:.2e} (atol {atol:g}{bound})"):
            failures.append(f"activations:{key}")
    return failures, diffs


def sequential_stage(model, audio: np.ndarray, fp16: bool, language: Optional[str],
                     expect: Optional[str], **options) -> Tuple[List[str], dict]:
    """Stage 3: the sequential transcribe; returns its result."""
    from whisper_at_tpu_torch import transcribe

    stage("sequential transcribe")
    result = transcribe(model, audio, fp16=fp16, language=language, verbose=None, **options)
    print(f"text: {result['text']!r}")
    failures = []
    if expect is not None:
        if not check(_normalized(expect) in _normalized(result["text"]),
                     f"transcript contains {expect!r}"):
            failures.append("transcribe:expect")
    return failures, result


def batched_stage(model, audio: np.ndarray, fp16: bool, language: Optional[str],
                  expect: Optional[str], **options) -> Tuple[List[str], dict]:
    """Stage 4: transcribe_batched on the plain cross K/V; returns its
    result with the tokens of each window under "window_tokens"."""
    from whisper_at_tpu_torch import parse_at_label, transcribe_batched

    stage("batched transcribe (the card's batched path)")
    with window_tokens() as tokens:
        batched = transcribe_batched(model, audio, fp16=fp16, language=language,
                                     kv_quant=False, weight_quant=False, **options)
    batched["window_tokens"] = tokens
    print(f"text: {batched['text']!r}")
    failures = []
    tags = np.asarray(batched["audio_tag"])
    if not check(np.isfinite(tags).all() and tags.shape[-1] == 527,
                 f"tag logits finite, shape {tags.shape}"):
        failures.append("batched:tags")
    for seg in parse_at_label(batched, language="en", top_k=3)[:3]:
        print("  tags@{}: {}".format(seg.get("time"), [t[0] for t in seg.get("audio tags", [])]))
    if expect is not None:
        if not check(_normalized(expect) in _normalized(batched["text"]),
                     "batched transcript contains the expected text"):
            failures.append("batched:expect")
    return failures, batched


def quant_stage(model, audio: np.ndarray, fp16: bool, language: Optional[str],
                reference_text: str, **options) -> Tuple[List[str], dict]:
    """Stage 5: int8 cross K/V and weights, K3 against its plain version
    (int8, on the card), and the int4 cross-K/V opt-in, each text against
    `reference_text` (stage 4's). Returns {"int8", "int4": texts; "tokens":
    each call's window tokens ("int8", "int8-plain" on the card, "int4")}."""
    from whisper_at_tpu_torch import transcribe_batched

    stage("int8 KV+weight quantization parity")
    failures = []
    tokens = {}

    def call(label, **kw):
        with window_tokens() as toks:
            result = transcribe_batched(model, audio, fp16=fp16, language=language,
                                        kv_quant=True, weight_quant=True, **kw, **options)
        tokens[label] = toks
        return result["text"]

    int8 = call("int8")
    if not check(int8 == reference_text, "int8 tokens identical to bf16 tokens"):
        close = _normalized(int8) == _normalized(reference_text)
        check(close, "  (normalized texts still match)")
        failures.append("quant:tokens" if not close else "quant:raw-only")

    # the cross K/V from K3 against its plain version: the same codes bit
    # for bit, so the same tokens; on the CPU the wrapper runs the plain
    # version itself, and the pair is one path
    if model.device.type == "cuda":
        with plain_k3():
            call("int8-plain")
        if not check(tokens["int8-plain"] == tokens["int8"],
                     "K3 kernel tokens identical to its plain version's"):
            failures.append("quant:impl-ab")
    else:
        print("(on the CPU K3's wrapper runs its plain version: kernel and plain version "
              "are one path here, not compared)")

    int4 = call("int4", kv_bits=4)
    if not check(int4 == reference_text, "int4 cross-KV tokens identical to bf16 tokens"):
        close = _normalized(int4) == _normalized(reference_text)
        check(close, "  (normalized texts still match)")
        failures.append("quant:int4" if not close else "quant:int4-raw")
    return failures, {"int8": int8, "int4": int4, "tokens": tokens}


def reference_stage(model, audio: np.ndarray, language: Optional[str],
                    reference_package: Optional[str]) -> Optional[List[str]]:
    """Stage 5b: the literal reference package on the port's own state dict
    (its names are the reference checkpoints'), fp32 on the CPU, against
    the port's fp32 sequential transcribe. None when no package is given or
    none is found where it points."""
    from whisper_at_tpu_torch import transcribe

    if reference_package is None:
        print("\n(no --reference-package given; skipping differential stage)")
        return None
    ref_pkg = os.path.join(reference_package, "whisper_at")
    if not os.path.isdir(ref_pkg):
        print(f"\n(reference package not found at {ref_pkg}; skipping differential stage)")
        return None
    stage("reference-package differential")
    refpkg = _load_by_path("refpkg")
    refpkg.REF_ROOT = reference_package
    refpkg.REF_PKG = ref_pkg
    d = model.dims
    state = {k: v.detach().to("cpu", torch.float32) for k, v in model.state_dict().items()}
    ref_model = refpkg.build_reference_model(vars(d), state,
                                             at_low_compute=model.at_mode != "tl_tr_1_8")
    failures = []
    kw = dict(language=language, fp16=False, temperature=0.0, verbose=None)
    with torch.no_grad():
        ref = ref_model.transcribe(audio, **kw)
    mine = transcribe(model, audio, **kw)
    ref_toks = [list(s["tokens"]) for s in ref["segments"]]
    my_toks = [list(s["tokens"]) for s in mine["segments"]]
    if not check(ref_toks == my_toks,
                 "fp32 transcript tokens identical to the literal reference"):
        failures.append("reference:tokens")
        print(f"  reference: {ref['text']!r}")
        print(f"  ours     : {mine['text']!r}")
    rtag, mtag = np.asarray(ref["audio_tag"]), np.asarray(mine["audio_tag"])
    err = float(np.abs(rtag - mtag).max()) if rtag.shape == mtag.shape else float("inf")
    if not check(err < 1e-2, f"tag logits vs reference max|Δ|={err:.2e}"):
        failures.append("reference:tags")
    return failures


def draft_stage(model, draft, audio: np.ndarray, fp16: bool, language: Optional[str],
                label: str, **options) -> Tuple[List[str], dict]:
    """Stage 5c: speculative decoding with `draft` against plain greedy;
    returns the speculative loop's counts (`decoding._LAST_SPEC_STATS`)."""
    from whisper_at_tpu_torch import decoding, transcribe_batched

    stage(f"speculative decode (draft={label})")
    kw = {"fp16": fp16, "language": language, "temperature": 0.0, **options}
    spec = transcribe_batched(model, audio, draft_model=draft, **kw)
    stats = dict(decoding._LAST_SPEC_STATS or {})
    plain = transcribe_batched(model, audio, **kw)
    failures = []
    if not check(spec["text"] == plain["text"], "speculative tokens identical to plain greedy"):
        failures.append("spec:tokens")
    print(f"  acceptance: {stats.get('tokens_per_round', float('nan')):.2f} tokens/round over "
          f"{stats.get('rounds')} rounds (>=3 on real speech makes speculation the latency "
          "default)")
    return failures, stats


def goldens_stage(path: str, model_name: str, batched: dict) -> List[str]:
    """Stage 6: the transcript and tag goldens, with the JAX tool's keys."""
    stage("record goldens")
    np.savez_compressed(
        path,
        model=model_name,
        text=batched["text"],
        language=batched["language"],
        audio_tag=np.asarray(batched["audio_tag"]),
        segment_starts=np.asarray([s["start"] for s in batched["segments"]], np.float64),
        segment_texts=np.asarray([s["text"] for s in batched["segments"]], object),
    )
    print(f"wrote {path}")
    return []


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default=None,
                    help="official model name, read from --download-root (never fetched)")
    ap.add_argument("--checkpoint", default=None, help="local Whisper .pt")
    ap.add_argument("--at-checkpoint", default=None, help="local TL-TR head .pth")
    ap.add_argument("--download-root", default=None)
    ap.add_argument("--audio", required=True, help="a real speech file")
    ap.add_argument("--expect", default=None,
                    help="substring the (normalized) transcript must contain")
    ap.add_argument("--language", default=None)
    ap.add_argument("--out", default=None, help="write goldens .npz here")
    ap.add_argument("--fp32", action="store_true",
                    help="run transcription in fp32 (default bf16)")
    ap.add_argument("--skip-activations", action="store_true")
    ap.add_argument("--skip-quant", action="store_true")
    ap.add_argument("--reference-package", default=None,
                    help="path to the literal reference checkout for the differential stage "
                         "(which runs only when this is given)")
    ap.add_argument("--skip-reference", action="store_true",
                    help="skip the reference-package differential (the reference runs on "
                         "torch CPU, slow for large models)")
    ap.add_argument("--draft", default=None,
                    help="official size for the speculative-decode stage (e.g. base), read "
                         "from --download-root: token parity + measured acceptance")
    ap.add_argument("--atol", type=float, default=2e-2,
                    help="activation tolerance vs the fp32 torch oracle")
    ap.add_argument("--device", default="cuda",
                    help="where the port runs (default cuda; the oracle runs on the CPU)")
    args = ap.parse_args(argv)
    if args.model is None and args.checkpoint is None:
        ap.error("need --model or --checkpoint")

    import whisper_at_tpu_torch as wat
    from whisper_at_tpu_torch.audio import load_audio

    fp16 = not args.fp32
    failures, (model, model_name) = load_stage(args.model, args.checkpoint, args.at_checkpoint,
                                               args.download_root, args.fp32, args.device)
    audio = load_audio(args.audio)
    print(f"audio: {len(audio) / 16000:.1f}s @ 16 kHz")

    if not args.skip_activations:
        failures += activations_stage(model, audio, fp16, args.atol)[0]
    failed, result = sequential_stage(model, audio, fp16, args.language, args.expect)
    failures += failed
    failed, batched = batched_stage(model, audio, fp16, args.language, args.expect)
    failures += failed
    if not args.skip_quant:
        failures += quant_stage(model, audio, fp16, args.language, batched["text"])[0]
    if not args.skip_reference:
        failures += reference_stage(model, audio, args.language or result["language"],
                                    args.reference_package) or []
    if args.draft is not None:
        draft = wat.load_model(args.draft, device=args.device, download_root=args.download_root,
                               dtype=torch.float32 if args.fp32 else None)
        failures += draft_stage(model, draft, audio, fp16, args.language, args.draft)[0]
    if args.out:
        failures += goldens_stage(args.out, model_name, batched)

    print("\n" + ("ALL STAGES PASSED" if not failures else f"FAILURES: {failures}"))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
