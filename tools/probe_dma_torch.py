"""HBM streaming-bandwidth probe on an NVIDIA GPU: does the depth of
outstanding copies, or the copy mechanism, move the ceiling?

The PyTorch/CUDA counterpart of `tools/probe_dma.py` (the JAX probe for the
TPU), over the same int8 buffer (`--mb` MiB in chunks of `--chunk-kb` KiB,
the same numpy draw) and the same function: the int32 column sums of every
chunk's first 8 KB, plus the XOR of every 32-bit word
(`whisper_at_tpu_torch/ops/probe_dma.py`). One row per variant:

  library  torch.sum(x, dtype=int32) over the whole buffer (the JAX
           probe's `xla` row: one library stream to compare with)
  plain    the plain PyTorch version of the kernels' function
  auto     P1: a grid over chunks, 16-byte loads through registers
  cp-N     P2: a persistent ring of N stages filled by cp.async (N = 2, 4, 8)
  tma-N    P2: the same ring filled by TMA bulk copies and mbarriers

Each row: the best time of `--iters` calls after a warm-up, each call
timed by CUDA events between calls queued back to back (a call already in
flight ahead of them, so the host's launch cost stays off the device's
clock); GB/s; the share of the H100's 3.35 TB/s; the ring's stage bytes;
all the times. The default buffer (512 MiB) is over ten times the 50 MB L2
cache, so every pass streams from device memory. Every kernel's sums and
XOR word are checked bit for bit against the plain version on the same
device, and the plain version against numpy on the host; a mismatch
raises.

Usage (one NVIDIA GPU):  python3 tools/probe_dma_torch.py [--mb 512] [--chunk-kb 1024] [--iters 5]
CPU smoke, plain versions only, host times (no device figures):
                         python3 tools/probe_dma_torch.py --cpu [--mb 8] [--chunk-kb 256]
`chip_smoke.py` calls `probe` at the defaults.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import PEAK_BYTES, card_line  # noqa: E402
from whisper_at_tpu_torch.ops import probe_dma as pd  # noqa: E402

VARIANTS = ("library", "plain", "auto") + tuple(
    f"{short}-{n}" for short in ("cp", "tma") for n in pd.RING_DEPTHS)
ENGINE = {"cp": "cp_async", "tma": "tma"}
CPU_MB = 8  # --mb default with --cpu


def variant(name: str, x: torch.Tensor, chunk_rows: int):
    """(the call of a variant, its kernel or None, its stage bytes or None)."""
    if name == "library":
        return lambda: torch.sum(x, dtype=torch.int32), None, None
    if name == "plain":
        return lambda: pd.stream_plain(x, chunk_rows), None, None
    if name == "auto":
        return lambda: pd.stream_auto(x, chunk_rows), pd.KERNEL_AUTO, None
    short, depth = name.split("-")
    nbuf, engine = int(depth), ENGINE[short]
    return (lambda: pd.stream_ring(x, chunk_rows, nbuf, engine),
            pd.RING_KERNELS[engine],
            pd.stage_bytes(chunk_rows, nbuf))


def timed(fn, iters: int, on_card: bool):
    """(the last call's result, the ms of each of `iters` calls after one
    warm-up call): CUDA events on the card, the host clock on the CPU."""
    fn()
    if not on_card:
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            out = fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return out, times
    torch.cuda.synchronize()
    fn()  # in flight while the timed calls are queued behind it
    events = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
    events[0].record()
    for i in range(iters):
        out = fn()
        events[i + 1].record()
    torch.cuda.synchronize()
    return out, [events[i].elapsed_time(events[i + 1]) for i in range(iters)]


def _differs(out, ref) -> int:
    """The largest absolute difference of two (sums, xor) pairs."""
    return max(int((a.long() - b.long()).abs().max()) for a, b in zip(out, ref))


def probe(x: torch.Tensor, chunk_rows: int, iters: int = 5, report=print) -> dict:
    """Every variant over x int8 [rows, 128] (on the card, or on the CPU
    where only plain versions run), checked and timed; one line per row to
    `report`. Returns {variant: row} with row keys ms (best), times, gbs and
    share (None on the CPU), stage_bytes, kernel (None for library and
    plain) and err (the kernel's largest difference from the plain
    version, 0 or the call raised)."""
    on_card = x.is_cuda
    nbytes = x.numel()
    host = x.cpu().numpy()
    n_chunks = host.shape[0] // chunk_rows
    np_sums = host.reshape(n_chunks, chunk_rows, pd.LANES)[:, :pd.SLIVER_ROWS].astype(
        np.int32).sum(axis=(0, 1))
    np_xor = np.bitwise_xor.reduce(host.reshape(-1).view(np.int32))
    ref = None
    rows = {}
    for name in VARIANTS:
        fn, kernel, stage = variant(name, x, chunk_rows)
        out, times = timed(fn, iters, on_card)
        err = None
        if name == "library":
            if int(out) != int(host.sum(dtype=np.int32)):
                raise AssertionError(f"library: torch.sum gives {int(out)}, numpy "
                                     f"{int(host.sum(dtype=np.int32))}")
        elif name == "plain":
            ref = out
            if not (np.array_equal(out[0].cpu().numpy()[0], np_sums)
                    and int(out[1]) == int(np_xor)):
                raise AssertionError("plain: sums or XOR word differ from numpy's")
        else:
            err = _differs(out, ref)
            if err:
                raise AssertionError(f"{name}: sums or XOR word differ from the plain "
                                     f"version's by up to {err}")
        best = min(times)
        row = dict(ms=best, times=times, stage_bytes=stage, kernel=kernel, err=err,
                   gbs=nbytes / best / 1e6 if on_card else None,
                   share=nbytes / best * 1e3 / PEAK_BYTES if on_card else None)
        rows[name] = row
        stage_txt = f"stage {stage:6d} B" if stage else "stage      - "
        if on_card:
            report(f"{name:8s} best {best:8.4f} ms {row['gbs']:8.1f} GB/s "
                   f"{row['share']:6.1%} of 3.35 TB/s  {stage_txt}  "
                   f"all {[round(t, 4) for t in times]}")
        else:
            report(f"{name:8s} best {best:8.3f} ms on the CPU (host clock)  {stage_txt}  "
                   f"all {[round(t, 3) for t in times]}")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mb", type=int, default=None,
                    help=f"buffer size, MiB (512; {CPU_MB} with --cpu)")
    ap.add_argument("--chunk-kb", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU (no device figures)")
    args = ap.parse_args(argv)
    if args.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda")
    else:
        raise SystemExit("probe_dma_torch: no CUDA device (use --cpu for the plain versions)")
    mb = args.mb if args.mb is not None else CPU_MB if args.cpu else 512
    rows, chunk_rows, n_chunks = pd.probe_geometry(mb, args.chunk_kb)
    if device.type == "cuda":
        print(card_line(), flush=True)
    print(f"buffer {rows * pd.LANES} B int8 [{rows}, {pd.LANES}], {n_chunks} chunks of "
          f"{chunk_rows * pd.LANES} B, {args.iters} timed calls a variant", flush=True)
    x = pd.make_buffer(rows).to(device)
    probe(x, chunk_rows, args.iters, report=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
