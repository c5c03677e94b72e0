"""Run one cell of the port's benchmark on the card.

    python3 portbench/run.py --workload large-v1.archive --seed 7 --seconds 40 --trace 0

From the root of a checkout. Prints one JSON line last on standard output:
{"correct", "attempted", "failed", "metrics", "device"[, "breakdown"],
"checks"}, the compared numbers with their limits also as the last lines
of standard error. With --trace 0 the metrics are the cell's end-to-end
metrics, with --trace 1 its per-layer metrics. Exits 1 without printing a
result when there is no CUDA device, when the cell needs more devices
than there are, or when JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    # a library that the program uses must not load JAX behind its back
    os.environ.setdefault("USE_FLAX", "0")
    sys.path.insert(0, ROOT)
    import torch

    from portbench import bench

    chips = bench.load_cell(ROOT, args.workload)["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {chips} CUDA device(s), found {n}: no result", file=sys.stderr)
        return 1
    result = bench.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                            device="cuda", t0=T0)
    loaded = bench.forbidden_modules()
    if loaded:
        print(f"JAX or the JAX package was loaded: {loaded}: no result", file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
