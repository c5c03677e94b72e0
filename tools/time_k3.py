"""K3's and K2's points for this checkout's package and another's, in turns,
in one process.

    python3 tools/time_k3.py [--parent DIR] [--rounds N]

DIR is the root of another checkout of this repository (for the parent
commit, a `git archive` unpacked under `build/`). Both packages'
`whisper_at_tpu_torch` are imported, each with its own kernels built into
its own `build/kernels/`, and made the current one in turn by swapping
their modules in `sys.modules`; this repository's `chip_smoke.k3_points`
(K3 and K3-int4 as `precompute_cross_kv` meets them, at [24, 1500, 1280]
and one audio row) and `chip_smoke.k2_points` (K2 beside the unfused
chain) then time the current package's kernels. The order is parent, this,
this, parent, N times. Before the timing, K2's outputs of both packages
are compared bit for bit, and K3's codes and scales held against each
other at [24, 1500, 1280] (the product's sums may round in another order).
Without --parent only this package is timed. Prints the card's name and
power limit and one line a point. Needs one NVIDIA GPU.
"""

import argparse
import importlib
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "whisper_at_tpu_torch"


def _ours() -> list:
    return [n for n in sys.modules if n == PKG or n.startswith(PKG + ".")]


def load(root: str) -> dict:
    """Import root's package (every ops module) and build its kernels;
    returns its modules."""
    for name in _ours():
        del sys.modules[name]
    sys.path.insert(0, root)
    try:
        pkg = importlib.import_module(PKG)
        importlib.import_module(f"{PKG}.ops")
    finally:
        sys.path.remove(root)
    where = os.path.dirname(os.path.dirname(os.path.abspath(pkg.__file__)))
    if where != root:
        raise SystemExit(f"imported {PKG} from {where}, not {root}")
    mods = {n: sys.modules[n] for n in _ours()}
    print(f"package {root}: kernel build {mods[PKG + '.ops.cuda'].build_all():.1f} s",
          flush=True)
    return mods


def activate(mods: dict) -> None:
    for name in _ours():
        del sys.modules[name]
    sys.modules.update(mods)


def compare(card: str, this: dict, parent: dict) -> None:
    """K2 bit for bit and K3's codes and scales, this package against the
    parent's, on the same inputs."""
    import chip_smoke
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(chip_smoke.SEED)
    d, f = chip_smoke.D, 4 * chip_smoke.D

    def uniform(*shape, scale):
        return ((torch.rand(shape, generator=gen, device=dev) * 2 - 1) * scale).to(
            torch.bfloat16)

    args = (uniform(chip_smoke.BATCH, chip_smoke.T_ENC, d, scale=3 ** 0.5),
            1 + uniform(d, scale=0.1), uniform(d, scale=0.1), uniform(f, d, scale=d ** -0.5),
            uniform(f, scale=d ** -0.5), uniform(d, f, scale=f ** -0.5),
            uniform(d, scale=f ** -0.5))
    xa, layers = chip_smoke.k3_inputs(gen, dev)
    outs = {}
    for label, mods in (("this", this), ("parent", parent)):
        enc_mlp, kv_quant = mods[PKG + ".ops.enc_mlp"], mods[PKG + ".ops.kv_quant"]
        outs[label] = ([enc_mlp.enc_mlp(*args), enc_mlp.enc_mlp(args[0][:1], *args[1:])],
                       [kv_quant.project_quantize_kv(xa, *layers[0]),
                        kv_quant.project_quantize_kv4(xa, *layers[0])])
    torch.cuda.synchronize()
    k2_equal = all(torch.equal(a, b) for a, b in zip(outs["this"][0], outs["parent"][0]))
    print(f"K2 outputs at [24, 1500, 1280] and [1, 1500, 1280], this package against the "
          f"parent's: {'bitwise equal' if k2_equal else 'DIFFERENT'} [{card}]", flush=True)
    unpack4 = this[PKG + ".models.layers"].unpack4
    for bits, ours, theirs in zip((8, 4), outs["this"][1], outs["parent"][1]):
        codes = (lambda t: unpack4(t).int()) if bits == 4 else (lambda t: t.int())
        diff = torch.cat([(codes(ours[i]) - codes(theirs[i])).abs().flatten() for i in (0, 2)])
        scales = max(float(((ours[i] - theirs[i]).abs() / theirs[i].clamp_min(1e-30)).max())
                     for i in (1, 3))
        print(f"K3{'-int4' if bits == 4 else ''} at [24, 1500, 1280] against the parent's: "
              f"codes differ by up to {int(diff.max())} on {float((diff > 0).float().mean()):.2e}"
              f" of entries, scales by rel {scales:.2e} [{card}]", flush=True)
    if not k2_equal:
        raise SystemExit("K2's outputs changed")


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
    parent = load(os.path.abspath(args.parent)) if args.parent else None
    order = [("this", this)]
    if parent is not None:
        compare(card, this, parent)
        order = [("parent", parent), ("this", this), ("this", this), ("parent", parent)]
    for _ in range(args.rounds):
        for label, mods in order:
            activate(mods)
            print(f"-- {label}", flush=True)
            chip_smoke.k3_points(card)
            chip_smoke.k2_points(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
