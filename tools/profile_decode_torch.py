"""Decode-loop composition: per-layer marginals against the byte bound.

    python3 tools/profile_decode_torch.py [--size large-v1] [--batch 8]
        [--steps 96] [--kv-bits 8|4] [--layout fused|heads] [--iters 3]
    python3 tools/profile_decode_torch.py --size tiny --cpu        # smoke

The port of tools/profile_decode.py. It times the decode loop as the
headline runs it (int8 decoder weights, quantized cross K/V at --kv-bits
from K3, the int8 self cache, K4 in every layer's cross-attention): an
8-token prefill, then --steps single-token steps, over the full layer stack
with the logits, without them, and over the first half and quarter of the
layers (truncated stacks of the same decode-form parameters and cross K/V).
The per-layer marginal is the difference of two stacks over their layer
difference; the fixed remainder is the full stack minus its layers'
marginal. `--layout` is kept for the JAX tool's command lines and is an
alias: the port has one cross-K/V layout (its kv_layout="heads" decodes
through it too), so either value times the same loop, and the header says
so.

The speed-of-light line counts the bytes a step must read in int8 (the
weights, the cross K/V at --kv-bits, the self cache at its 128 slots, the
bf16 embedding) over the memory rate of the device kind (3.35 TB/s for an
H100; none is assumed for another kind). Beside it, one profiled call of the
full loop gives the device's busy time and idle share. Each time is the
best of --iters rounds, the stacks timed in turn within a round, with the
device synchronized (`timed` of tools/profile_torch_headline.py).
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from profile_torch_headline import device_busy, idle_line, timed, tool_model  # noqa: E402

from chip_smoke import PEAK_BYTES, SEED, card_line  # noqa: E402

# the memory rate of each device kind the speed-of-light line knows, by a
# substring of torch.cuda.get_device_name()
HBM_BYTES_PER_S = {"H100": PEAK_BYTES}
TOTAL, PREFILL = 128, 8  # the self cache's slots and the prefill's tokens, as the JAX tool's


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", default="large-v1")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=96)
    ap.add_argument("--layout", default="fused", choices=["fused", "heads"],
                    help="an alias kept from the JAX tool: the port has one cross-K/V "
                         "layout, which both values time")
    ap.add_argument("--kv-bits", type=int, default=8, choices=(8, 4))
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--cpu", action="store_true", help="fp32 on the CPU (a smoke)")
    return ap.parse_args(argv)


def memory_rate(device: torch.device):
    """(bytes/s, kind) of the device, or (None, kind) for a kind not known."""
    if device.type != "cuda":
        return None, "cpu"
    kind = torch.cuda.get_device_name(device)
    return next((r for k, r in HBM_BYTES_PER_S.items() if k in kind), None), kind


def step_bytes(dims, batch: int, kv_bits: int) -> dict:
    """Bytes one int8 decode step reads, as the JAX tool counts them."""
    ly, d, h, ta = dims.n_text_layer, dims.n_text_state, dims.n_text_head, dims.n_audio_ctx
    return {"weights": ly * (d * 3 * d + 3 * d * d + 8 * d * d),
            "crossKV": 2 * ly * batch * h * ta * (d // h) * kv_bits // 8,
            "selfKV": 2 * ly * batch * h * TOTAL * (d // h),
            "emb": dims.n_vocab * d * 2}


def run(model, fp16: bool, args) -> dict:
    """Print and return the loop's times, marginals and bound."""
    from whisper_at_tpu_torch.models.decoder import (
        CrossKV,
        Parts,
        decoder_forward,
        init_cache,
        precompute_cross_kv,
        project_logits,
    )

    dims, dev = model.dims, model.device
    dtype = model.compute_dtype(fp16)
    b, steps, nh = args.batch, args.steps, model.text_heads
    params = model.decoder_params_decode(True)  # int8 weights
    gen = np.random.default_rng(SEED)
    xa = torch.from_numpy(gen.standard_normal(
        (b, dims.n_audio_ctx, dims.n_audio_state)).astype(np.float32)).to(dev, dtype)
    with torch.no_grad():
        cross = precompute_cross_kv(params, xa, nh, dtype, quantize=True, bits=args.kv_bits)

    def stack(n_layer):
        """The first n_layer layers of the decode-form parameters and cross K/V."""
        p = Parts(token_embedding=params.token_embedding,
                  positional_embedding=params.positional_embedding,
                  blocks=torch.nn.ModuleList(list(params.blocks)[:n_layer]), ln=params.ln,
                  width=params.width)
        c = CrossKV(cross.k[:n_layer], cross.v[:n_layer], cross.k_scale[:n_layer],
                    cross.v_scale[:n_layer], cross.bias, cross.bits)
        return p, c

    def run_steps(n_layer, with_logits):
        p, c = stack(n_layer)
        with torch.no_grad():
            cache = init_cache(n_layer, b, TOTAL, params.width, dtype, nh, quantize=True,
                               device=dev)
            tok0 = torch.zeros((b, PREFILL), dtype=torch.long, device=dev)
            h = decoder_forward(p, tok0, c, cache, 0, 0, nh, dtype)[:, -1:]
            tokv = torch.full((b, 1), 100, dtype=torch.long, device=dev)
            acc = torch.zeros((), dtype=torch.float32, device=dev)
            for t in range(steps):
                h = decoder_forward(p, tokv, c, cache, PREFILL + t, 0, nh, dtype)
                acc += project_logits(p, h)[:, 0].sum() if with_logits else h.float().sum()
            return acc

    n = dims.n_text_layer
    rows = [(f"{n}L + logits", n, True), (f"{n}L no logits", n, False),
            (f"{n // 2}L no logits", n // 2, False), (f"{n // 4}L no logits", n // 4, False)]
    # the stacks timed in turn, --iters rounds after a warm-up round, the
    # best of each kept: the host-bound loop drifts by more than a layer's
    # cost between calls, and turns spread the drift over every stack
    for _, n_layer, with_logits in rows:
        timed(lambda: run_steps(n_layer, with_logits))
    samples = {label: [] for label, _, _ in rows}
    for _ in range(args.iters):
        for label, n_layer, with_logits in rows:
            samples[label].append(timed(lambda: run_steps(n_layer, with_logits))[1])
    times = {label: min(ts) for label, ts in samples.items()}
    for label, dt in times.items():
        print(f"{label}: {dt * 1000:.1f} ms total, {dt / steps * 1e3:.3f} ms/step (all "
              f"{[round(t * 1e3, 1) for t in samples[label]]} ms)", flush=True)

    full, half, quarter = (times[r[0]] for r in rows[1:])
    per_layer = (full - quarter) / (n - n // 4) / steps
    fixed = full / steps - n * per_layer
    logits = (times[rows[0][0]] - full) / steps
    print(f"per-layer marginal {per_layer * 1e3:.4f} ms/step ({n // 4}L to {n}L; {n // 2}L to "
          f"{n}L: {(full - half) / (n - n // 2) / steps * 1e3:.4f}), fixed remainder "
          f"{fixed * 1e3:.4f} ms/step, logits {logits * 1e3:.4f} ms/step", flush=True)

    nbytes = step_bytes(dims, b, args.kv_bits)
    print(", ".join(f"{k} {v / 1e6:.0f} MB" for k, v in nbytes.items()) + " per step",
          flush=True)
    rate, kind = memory_rate(dev)
    sol = None
    if rate is None:
        print(f"speed-of-light: no memory rate known for {kind}", flush=True)
    else:
        sol = sum(nbytes.values()) / rate
        print(f"speed-of-light @{rate / 1e9:.0f} GB/s ({kind}): {sol * 1e3:.3f} ms/step, "
              f"{100 * sol / (times[rows[0][0]] / steps):.2f}% of the full loop's step",
              flush=True)
    busy = device_busy(lambda: run_steps(n, True))
    print(f"{rows[0][0]}, one profiled call: {idle_line(busy)}", flush=True)
    return dict(times=times, per_layer_s=per_layer, fixed_s=fixed, logits_s=logits,
                bytes=nbytes, bound_s=sol, busy_s=busy["busy_s"],
                idle_share=busy["idle_share"])


def main(argv=None) -> int:
    args = parse_args(argv)
    print("card: none (CPU run)" if args.cpu else card_line(), flush=True)
    model, fp16 = tool_model(args.size, args.cpu)
    print(f"{args.size}: batch {args.batch}, {args.steps} steps after an {PREFILL}-token "
          f"prefill, int8 weights and self cache, int{args.kv_bits} cross K/V in the port's one "
          f"layout (--layout {args.layout} is an alias), best of {args.iters}", flush=True)
    run(model, fp16, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
