"""The readings that a cell's correctness limits are set from.

    python3 portbench/readings.py --workload large-v1.archive --seeds 11-22 \\
        [--control] [--faults] [--windows N] [--out build/readings.jsonl]

For each seed, in one process on the card: the cell's weights and pool,
one call of its entry with the configuration's options (a sound run of the
program), and with --control one call with the configuration's control
options on top (the program's own lower-precision path: int4 cross K/V,
weights and self cache) and the reference put in the program's place in
float8 (`check.reference_as_program`); with --faults one call with each
fault of `faults.py` planted. Each is compared as a run's window calls are
(`check.compare`, the cell's sample size or --windows) and judged against
the cell's limits (`limits/<cell>.json`): `correct` beside each. One JSON
line per seed, with each window's readings. Not run by the benchmark's runs.
"""

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def seeds_of(text: str):
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="e.g. 11-22 or 5,9,13")
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--out", default=None)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--windows", type=int, default=None,
                        help="windows compared (default: the mix's check_windows)")
    parser.add_argument("--no-reference-control", action="store_true",
                        help="with --control, leave out the float8 reference")
    parser.add_argument("--faults", action="store_true",
                        help="also one call with each fault of faults.py planted")
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import pytest
    import torch

    from portbench import bench, check, generator
    from portbench.faults import FAULTS
    from portbench.weights import make_weights

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("needs a CUDA device", file=sys.stderr)
            return 1
        from whisper_at_tpu_torch.ops import cuda as kernels

        kernels.build_all()
    spec = bench.load_cell(ROOT, args.workload)
    config, mix = spec["config"], spec["mix"]
    call = generator.load_entry(spec["dir"], mix["entry"]).call
    limits = check.load_limits(spec["dir"], args.workload)
    dtype = torch.bfloat16 if config["program"].get("fp16", True) else torch.float32
    options = generator.call_options(mix, config)
    runs = [("program", options)]
    if args.control:
        runs.append(("control", dict(options, **config["control"])))
    out = open(args.out, "a") if args.out else None
    for seed in seeds_of(args.seeds):
        t0 = time.perf_counter()
        sd = make_weights(config["dims"], seed, device, dtype)
        model = bench.build_model(config, sd, device)
        files = generator.make_call_audio(mix, seed, 0, device)
        line = {"workload": args.workload, "seed": seed}
        calls = {}
        for label, opts in runs:
            results = call(model, files, opts)
            calls[label] = [{"pool": 0, "windows": generator.windows_of(files),
                             "results": results}]
        for name, plant in sorted(FAULTS.items()) if args.faults else []:
            with pytest.MonkeyPatch.context() as mp:
                plant(mp)
                results = call(model, files, options)
            calls[f"fault_{name}"] = [{"pool": 0, "windows": generator.windows_of(files),
                                       "results": results}]
        del model
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        n_windows = args.windows or mix["check_windows"]
        if args.control and not args.no_reference_control:
            calls["control_reference_fp8"] = check.reference_as_program(
                calls["program"], [files], sd, config, n_windows, seed, device)
        for label, c in calls.items():
            line[label] = check.compare(c, [files], sd, config, n_windows, seed, device,
                                        detail=True)
            line[label]["correct"] = all(j["ok"] for j in
                                         check.judge(line[label], limits).values())
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        del sd, calls
        gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
