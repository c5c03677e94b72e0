"""Per-step logit divergence of the port's quantized decode options from full
precision, on the card.

    python3 tools/quant_divergence_torch.py [--size large-v1] [--steps 96] [--seed 0]
        [--out build/quant_divergence_torch.json]

The port of `tools/quant_divergence.py`, importing only the port. It decodes
one 30 s window of the benchmark's signal class (a 220 Hz tone with noise,
as int16 PCM) greedily in bf16 with every option off, then teacher-forces
that token stream through each int8 and int4 variant of the fused cross-K/V
layout (the only one the port has) and reports, per variant, the largest
logit difference, the mean and largest total variation between the two
next-token distributions, and the steps whose argmax differs. Weights are
random, from a seeded generator, so the figures describe the arithmetic,
not speech.

Prints the card's name and power limit, one table row per variant and one
JSON object (also written to --out). Needs one NVIDIA GPU.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import card_line, synth_audio  # noqa: E402

VARIANTS = {
    "cross-kv-int8": dict(kv_quant=True),
    "weights-int8": dict(weight_quant=True),
    "self-kv-int8": dict(self_kv_quant=True),
    "all-int8": dict(kv_quant=True, weight_quant=True, self_kv_quant=True),
    "cross-kv-int4": dict(kv_quant=True, kv_bits=4),
    "weights-int4": dict(weight_quant=True, weight_bits=4),
    "self-kv-int4": dict(self_kv_quant=True, self_kv_bits=4),
    "int4kv+int8rest": dict(kv_quant=True, kv_bits=4, weight_quant=True, self_kv_quant=True),
    "all-int4": dict(kv_quant=True, kv_bits=4, weight_quant=True, weight_bits=4,
                     self_kv_quant=True, self_kv_bits=4),
}


def run_stream(model, feats, sot_seq, steps: int, forced=None, kv_quant=False, kv_bits=8,
               weight_quant=False, weight_bits=8, self_kv_quant=False, self_kv_bits=8):
    """Logits [steps, V] (fp32, on the host) of a decode from the SOT
    sequence, fed its own argmax or, when given, the `forced` tokens; and
    the argmax of each step."""
    from whisper_at_tpu_torch.models.decoder import (
        decoder_forward, init_cache, precompute_cross_kv, project_logits)

    dims, dtype = model.dims, torch.bfloat16
    params = model.decoder_params_decode(weight_quant, weight_bits)
    cross = precompute_cross_kv(params, feats, dims.n_text_head, dtype, quantize=kv_quant,
                                bits=kv_bits)
    cache = init_cache(dims.n_text_layer, 1, dims.n_text_ctx, dims.n_text_state, dtype,
                       dims.n_text_head, quantize=self_kv_quant, bits=self_kv_bits,
                       device=feats.device)
    tokens = torch.tensor([sot_seq], device=feats.device)
    pos, logits, chosen = 0, [], []
    for i in range(steps):
        hidden = decoder_forward(params, tokens, cross, cache, pos, 0, dims.n_text_head, dtype)
        step = project_logits(params, hidden[:, -1:])[0, 0]
        logits.append(step.float().cpu().numpy())
        chosen.append(int(step.argmax()))
        pos += tokens.shape[1]
        nxt = chosen[-1] if forced is None else forced[i]
        tokens = torch.tensor([[nxt]], device=feats.device)
    return np.stack(logits), chosen


def softmax(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--size", default="large-v1")
    parser.add_argument("--steps", type=int, default=96)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default="build/quant_divergence_torch.json")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import whisper_at_tpu_torch as wat
    from whisper_at_tpu_torch.audio import N_FRAMES
    from whisper_at_tpu_torch.ops import cuda
    from whisper_at_tpu_torch.tokenizer import get_tokenizer

    card = card_line()
    print(card, flush=True)
    cuda.build_all()
    model = wat.build_model(args.size, device="cuda", dtype=torch.bfloat16, seed=args.seed)
    sot_seq = list(get_tokenizer(model.is_multilingual, language="en",
                                 task="transcribe").sot_sequence)
    mel = wat.log_mel_spectrogram(synth_audio(30, args.seed), device="cuda")
    feats, _ = model.embed_audio(wat.pad_or_trim(mel, N_FRAMES)[None])

    with torch.no_grad():
        ref_logits, ref_tokens = run_stream(model, feats, sot_seq, args.steps)
        ref_probs = softmax(ref_logits)
        summary = {"card": card, "size": args.size, "steps": args.steps, "dtype": "bf16",
                   "seed": args.seed, "variants": {}}
        print(f"{'variant':16} {'max|dlogit|':>11} {'mean TV':>9} {'max TV':>8} "
              f"{'argmax flips':>12} {'first flip':>10}", flush=True)
        for name, options in VARIANTS.items():
            logits, argmax = run_stream(model, feats, sot_seq, args.steps, forced=ref_tokens,
                                        **options)
            dlogit = np.abs(logits - ref_logits).max(axis=-1)
            tv = 0.5 * np.abs(softmax(logits) - ref_probs).sum(axis=-1)
            flips = [i for i in range(args.steps) if argmax[i] != ref_tokens[i]]
            row = {"max_abs_dlogit": float(dlogit.max()), "mean_tv": float(tv.mean()),
                   "max_tv": float(tv.max()), "argmax_flips": len(flips),
                   "first_flip_step": flips[0] if flips else None}
            summary["variants"][name] = row
            print(f"{name:16} {row['max_abs_dlogit']:11.4f} {row['mean_tv']:9.5f} "
                  f"{row['max_tv']:8.5f} {len(flips):12d} {str(row['first_flip_step']):>10}",
                  flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
