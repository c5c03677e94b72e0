"""Speculative decoding's round costs in the PyTorch port, and the
speculative call against greedy.

A round of `decoding.spec_sample_loop` is L draft passes (one re-ingests
two slots, L - 1 take one token) and one verifier pass over L + 1 tokens,
so at a mean of a tokens committed a row a round the decode runs

    speedup(a) = a * T_step / (L * T_draft + T_verify)

times greedy's speed. This tool times each term directly, one decoder pass
and its logits projection at a time over the decode's own weights, cross
K/V and cache: T_step (the verifier's greedy step, one token a row),
T_draft (the draft's step) and T_verify(L + 1) (the verify pass, K4 at
G = L + 1 on quantized cross K/V), then the end-to-end `decode` calls:
greedy, the model as its own draft (every draft agrees) and the given draft
(random weights agree about never: the loop's overhead bound).

Runs on the card by default; `--cpu` runs it on the CPU at whatever size
is asked. Imports no JAX.

    python3 tools/profile_spec_torch.py --size large-v1 --draft tiny --batch 24
    python3 tools/profile_spec_torch.py --size tiny --draft tiny --cpu --tokens 16
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def timed(fn, dev, iters: int) -> float:
    """Best seconds of `iters` calls of fn (after one warm-up)."""
    fn()
    best = float("inf")
    for _ in range(iters):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


def pass_times(model, draft, mel, opts: dict, lookahead: int, iters: int) -> dict:
    """T_step, T_draft and T_verify(L + 1) in seconds: one decoder pass and
    its logits projection, on the options' decode weights and cross K/V (the
    draft's plain ones), each as the loop runs it."""
    from whisper_at_tpu_torch.models.decoder import (
        decoder_forward,
        decoder_forward_rows,
        init_cache,
        precompute_cross_kv,
        project_logits,
    )

    dev = mel.device
    dtype = model.compute_dtype(opts.get("fp16", True))
    b, pad, ctx = mel.shape[0], 0, 4 + opts["sample_len"] + lookahead + 1
    out = {}
    for name, m, quant, rows in (("step", model, True, 1), ("draft", draft, False, 1),
                                 ("verify", model, True, lookahead + 1)):
        params = m.decoder_params_decode(quant and opts.get("weight_quant", False))
        feats, _ = m.embed_audio(mel, opts.get("fp16", True))
        cross = precompute_cross_kv(params, feats, m.dims.n_text_head, dtype,
                                    quantize=quant and opts.get("kv_quant", False))
        cache = init_cache(len(params.blocks), b, ctx, m.dims.n_text_state, dtype,
                           m.dims.n_text_head, device=dev)
        tokens = torch.full((b, 4), 50258, device=dev)
        decoder_forward(params, tokens, cross, cache, 0, pad, m.dims.n_text_head, dtype)
        toks = torch.full((b, rows), 440, device=dev)
        write_pos = torch.full((b,), 4, device=dev)
        heads = m.dims.n_text_head
        if name != "step":  # the loop's draft and verify passes are per-row passes
            fn = lambda: project_logits(params, decoder_forward_rows(  # noqa: E731
                params, toks, cross, cache, write_pos, pad, heads, dtype))
        else:
            fn = lambda: project_logits(params, decoder_forward(  # noqa: E731
                params, toks, cross, cache, 4, pad, heads, dtype))
        out[name] = timed(fn, dev, iters)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--size", default="large-v1")
    parser.add_argument("--draft", default="tiny")
    parser.add_argument("--batch", type=int, default=24)
    parser.add_argument("--tokens", type=int, default=96)
    parser.add_argument("--lookahead", type=int, default=8)
    parser.add_argument("--iters", type=int, default=3)
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    parser.add_argument("--no-quant", dest="quant", action="store_false",
                        help="decode on bf16 weights and cross K/V (no K3, K4)")
    args = parser.parse_args(argv)

    sys.path.insert(0, ROOT)
    import whisper_at_tpu_torch as wat
    from whisper_at_tpu_torch import decoding

    dev = torch.device("cpu" if args.cpu else "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("profile_spec_torch: no CUDA device; pass --cpu", file=sys.stderr)
            return 2
        import chip_smoke

        print(chip_smoke.card_line(), flush=True)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    model = wat.build_model(args.size, device=dev, dtype=dtype, seed=0)
    draft = wat.build_model(args.draft, device=dev, dtype=dtype, seed=1)
    mel = torch.from_numpy((0.4 * np.random.default_rng(0).standard_normal(
        (args.batch, 80, 3000))).astype(np.float32)).to(dev)
    L = args.lookahead
    opts = dict(language="en", temperature=0.0, sample_len=args.tokens,
                fp16=dev.type == "cuda", kv_quant=args.quant, weight_quant=args.quant)

    with torch.no_grad():
        t = pass_times(model, draft, mel, opts, L, args.iters)
        print(f"{args.size} batch {args.batch} on {dev.type}: T_step {t['step'] * 1e3:.3f} ms, "
              f"T_draft ({args.draft}) {t['draft'] * 1e3:.3f} ms "
              f"({t['draft'] / t['step']:.3f}x), T_verify({L + 1}) {t['verify'] * 1e3:.3f} ms "
              f"({t['verify'] / t['step']:.3f}x a step)", flush=True)

        def run(**kw):
            return wat.decode(model, mel, wat.DecodingOptions(**opts, **kw))

        greedy = timed(run, dev, args.iters)
        print(f"greedy: {greedy * 1e3:.1f} ms for {args.tokens} tokens a row", flush=True)
        for label, d in (("self", model), (args.draft, draft)):
            spec = timed(lambda: run(draft_model=d, draft_lookahead=L), dev, args.iters)
            stats = decoding._LAST_SPEC_STATS
            print(f"spec (draft={label}): {spec * 1e3:.1f} ms = {greedy / spec:.3f}x greedy; "
                  f"{stats['rounds']} rounds, {stats['commits']} commits, "
                  f"{stats['tokens_per_round']:.2f} tokens a round "
                  f"({stats['tokens_per_round'] / args.batch:.2f} a row)", flush=True)
    t_round = L * t["draft"] + t["verify"]
    print(f"implied speedup(a) = a * {t['step'] * 1e3:.3f} / {t_round * 1e3:.3f} ms "
          f"(a = tokens committed a row a round):", flush=True)
    for a in (1, 2, 4, 6, L + 1):
        print(f"  a = {a}: {a * t['step'] / t_round:.2f}x", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
