"""K8's cold points (`chip_smoke.k8_points`) for one checkout's package.

    python3 tools/time_k8.py [--package DIR]

DIR is the root of a checkout of this repository (default: this one). Its
`whisper_at_tpu_torch` is imported first and its kernels built; then this
repository's `chip_smoke.k8_points` times that package's K8 and K8-int8
beside the unfused MLP they replace, cold, at 24, 96 and 120 rows of
large-v1, and prints the card's name and power limit and one line a point.
To compare two versions, run both in one call on one card, in turns (for
a parent unpacked by `git archive` under `build/`: parent, this, this,
parent). Needs one NVIDIA GPU.
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--package", default=ROOT,
                        help="root of the checkout whose whisper_at_tpu_torch is timed")
    args = parser.parse_args(argv)
    package = os.path.abspath(args.package)
    sys.path.insert(0, package)
    import whisper_at_tpu_torch
    from whisper_at_tpu_torch.ops import cuda

    where = os.path.dirname(os.path.dirname(os.path.abspath(whisper_at_tpu_torch.__file__)))
    if where != package:
        raise SystemExit(f"imported whisper_at_tpu_torch from {where}, not {package}")
    sys.path.remove(package)
    sys.path.insert(0, ROOT)
    import chip_smoke
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    card = chip_smoke.card_line()
    print(card, flush=True)
    print(f"package {package}: kernel build {cuda.build_all():.1f} s", flush=True)
    chip_smoke.k8_points(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
