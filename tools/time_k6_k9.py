"""K6's and K9's points for this checkout's package and another's, in turns,
in one process.

    python3 tools/time_k6_k9.py [--parent DIR] [--rounds N]

DIR is the root of another checkout of this repository (for the parent
commit, a `git archive` unpacked under `build/`). Both packages'
`whisper_at_tpu_torch` are imported and their kernels built, each into its
own `build/kernels/` (`tools/time_k3.py`'s `load`), and made the current
one in turn. The order is parent, this, this, parent, N times.

K6 (the DTW trace) is timed in float64 and float32 at the words call's
chunks before the alignment rows lost their 64-row padding ([4, 97, 1500]:
four windows a chunk) and after ([6, 97, 1500]), and at the longest text a
window holds ([1, 448, 1500]), each beside its chain floor
(`chip_smoke.k6_floor_ms`, from this package's measured step latency);
this package's K6 also at M = 500 beside 1500 for 31, 97 and 448 rows: the
slope is the time of a step, what is left at M = 0 the warps' start lags
and fixed costs.
K9 (split-S flash decode) is timed cold, as `chip_smoke.k9_points` does:
at batch 24 and at one audio row, eager over K/V sets used in turn and in a
CUDA graph. Before the timing, the packages' K6 traces are compared bit
for bit, and their K9 outputs held against the plain version and against
each other. Prints the card's name and power limit, one line a point and
turn, and a summary line a point. Needs one NVIDIA GPU; loads no JAX.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from time_k3 import PKG, activate, load  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_TEXT = 97  # DTW rows of a words-call window: 96 text tokens + 1
K6_POINTS = (("words chunk before the repair", 4, N_TEXT),
             ("words chunk after the repair", 6, N_TEXT),
             ("longest text", 1, 448))


def inputs(chip_smoke, torch):
    """K6's matrices and K9's K/V in K3's layout, from one seeded generator."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(chip_smoke.SEED)
    k6 = {}
    for label, g, n in K6_POINTS:
        x = torch.randn((g, n, chip_smoke.DTW_FRAMES), generator=gen, device=dev)
        k6[label] = (x, torch.full((g,), n, dtype=torch.int32, device=dev))
    a, s_pad, h = chip_smoke.BATCH, 1536, chip_smoke.H
    kq, vq = (torch.randint(-127, 128, (a, s_pad, h * chip_smoke.DH), generator=gen,
                            device=dev, dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand((a, h, s_pad), generator=gen, device=dev) * 0.02 for _ in range(2))

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    return k6, (kq, ks, vq, vs), randn


def compare(card: str, chip_smoke, torch, this: dict, parent: dict, k6, kv, randn) -> None:
    """K6's traces of both packages bit for bit (float64 and float32); K9 of
    each against the plain version (`chip_smoke.k9_compare`) and the two
    against each other within two bf16 roundings (1e-5 + 2^-6 |parent|)."""
    traces, outs = {}, {}
    q = randn(chip_smoke.BATCH * chip_smoke.H, chip_smoke.DH)
    for label, mods in (("this", this), ("parent", parent)):
        activate(mods)
        dtw, fd = mods[PKG + ".ops.dtw"], mods[PKG + ".ops.flash_decode"]
        traces[label] = [dtw.dtw_trace(x, n, acc) for x, n in k6.values()
                         for acc in (torch.float64, torch.float32)]
        err, tol = chip_smoke.k9_compare(q, *kv, chip_smoke.H, chip_smoke.T_ENC)
        print(f"K9 of {label} against the plain version: max_abs_err={err:.3e} ({tol}) "
              f"[{card}]", flush=True)
        outs[label] = fd.flash_decode_cross(q, *kv, chip_smoke.H, chip_smoke.T_ENC)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(traces["this"], traces["parent"]))
    print(f"K6 traces at {[list(x.shape) for x, _ in k6.values()]}, float64 and float32, "
          f"this package against the parent's: {'bitwise equal' if same else 'DIFFERENT'} "
          f"[{card}]", flush=True)
    ref = outs["parent"].float()
    diff = (outs["this"].float() - ref).abs()
    worst = float((diff / (1e-5 + 2 ** -6 * ref.abs())).max())
    print(f"K9 this against the parent's at [{chip_smoke.BATCH} x {chip_smoke.H}, 64]: max "
          f"|diff| {float(diff.max()):.3e}, {worst:.3f} of 1e-5 + 2^-6 |parent| [{card}]",
          flush=True)
    if not same or worst > 1.0:
        raise SystemExit("K6's traces or K9's outputs differ between the packages")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", help="root of the other checkout whose package is timed")
    parser.add_argument("--rounds", type=int, default=1,
                        help="times the order parent, this, this, parent is run")
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import chip_smoke
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    card = chip_smoke.card_line()
    print(card, flush=True)
    this = load(ROOT)
    step_ns = chip_smoke.k6_step_ns()  # this package's measuring kernel
    print("K6 step latency: " + ", ".join(
        f"{str(acc).split('.')[-1]} {'across rows' if cross else 'along a row'} {ns:.3f} ns"
        for (acc, cross), ns in step_ns.items()) + f" [{card}]", flush=True)
    parent = load(os.path.abspath(args.parent)) if args.parent else None
    k6, kv, randn = inputs(chip_smoke, torch)
    order = [("this", this)]
    if parent is not None:
        compare(card, chip_smoke, torch, this, parent, k6, kv, randn)
        order = [("parent", parent), ("this", this), ("this", this), ("parent", parent)]
    seen = {}
    for _ in range(args.rounds):
        for label, mods in order:
            activate(mods)
            dtw = mods[PKG + ".ops.dtw"]
            print(f"-- {label}", flush=True)
            for point, (x, n) in k6.items():
                for acc in (torch.float64, torch.float32):
                    ms = chip_smoke.time_ms(lambda: dtw.dtw_trace(x, n, acc), 20)
                    floor = chip_smoke.k6_floor_ms(int(n.max()), x.shape[2], acc, step_ns)
                    key = f"K6 {list(x.shape)} {str(acc).split('.')[-1]} ({point})"
                    seen.setdefault(key, {}).setdefault(label, []).append(ms)
                    print(f"{key}: {ms:.4f} ms; chain floor {floor:.4f} ms "
                          f"({100 * floor / ms:.1f}%) [{card}]", flush=True)
            if label == "this":  # a step's time and the fixed part, from two widths
                for g, n_rows in ((6, 31), (6, N_TEXT), (1, 448)):
                    ms = {}
                    for m in (500, chip_smoke.DTW_FRAMES):
                        x = torch.randn((g, n_rows, m), device="cuda")
                        n = torch.full((g,), n_rows, dtype=torch.int32, device="cuda")
                        ms[m] = chip_smoke.time_ms(lambda: dtw.dtw_trace(x, n), 20)
                    step = (ms[chip_smoke.DTW_FRAMES] - ms[500]) / (chip_smoke.DTW_FRAMES - 500)
                    print(f"K6 [{g}, {n_rows}, M] float64: {ms[500]:.4f} ms at M = 500, "
                          f"{ms[chip_smoke.DTW_FRAMES]:.4f} at {chip_smoke.DTW_FRAMES}: "
                          f"{step * 1e6:.2f} ns a step, {ms[500] - 500 * step:.4f} ms at M = 0 "
                          f"(the warps' start lags and the rest) [{card}]", flush=True)
            for a, p in chip_smoke.k9_points(randn, kv).items():
                for mode in ("ms", "graph"):
                    key = f"K9 A={a} cold {'eager' if mode == 'ms' else 'graph'}"
                    seen.setdefault(key, {}).setdefault(label, []).append(p[mode])
                    print(f"{key}: {p[mode]:.4f} ms over {p['sets']} K/V sets; "
                          f"{100 * p['bound'][0] / p[mode]:.1f}% of the {p['bound'][0]:.4f} ms "
                          f"bound [{card}]", flush=True)
    for key, by in seen.items():
        print(f"{key}: " + "; ".join(f"{label} " + ", ".join(f"{t:.4f}" for t in times)
                                     for label, times in by.items()) + f" ms [{card}]",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
