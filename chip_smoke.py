"""On-card smoke test of the PyTorch/CUDA port (whisper_at_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It (1) builds every hand-written CUDA kernel of the port from
`whisper_at_tpu_torch/csrc` (one nvcc per source, all at once), (2) holds
each kernel against its plain PyTorch version at the shapes its path gives
it (the headline workload: large-v1, batch 24, bf16; K5 at the decode
loop's four weight shapes with 24 and 96 rows; the DTW at the word timing's
matrix sizes) and times both; K2 also beside the unfused chain it
replaces, at the headline's rows and at one audio row (`k2_points`), with
the kernel before its redesign as recorded (K2_BEFORE); K2-partial at the
tensor-parallel widths F 2560 and 1280, each rank's slice against its plain
version and the ranks summed against K2 (`k2_partial_row`); K3 and K3-int4
on a rank's [640, 1280] and [320, 1280] weights beside the whole layer
(`k3_tp_points`); K3 and K3-int4 as
`precompute_cross_kv` meets them, a CUDA graph of one launch a layer over
32 layers' weight pairs on one xa, at batch 24 and at one audio row, each
also held against its plain version at both (`k3_points`; K3_BEFORE as
recorded). The decode
loop's own operands are timed cold, as the loop meets them after the
other layers': K5 and its
torch.matmul yardstick as a CUDA graph of one greedy step's 192 products
over 32 layers' weights with the L2 flushed before each replay (K5 also
hot, labelled); K8 and K8-int8 the same way, a CUDA graph of one call per
layer over 32 layers' own weight pairs, at 24, 96 and 120 rows beside the
unfused MLP they replace (`k8_points`, hot figures beside, labelled); K4,
K10 and their int4 entries over K/V sets used in
turn, eager and in CUDA graphs, at the greedy step, a beam step and the
speculative verify pass (G = 9) at batch 24 and at the sequential call's
single audio row (`cross_decode_points`), each K4 point printed beside K10
on the same
bytes, the bound, the split of the positions K4 chose and the kernel
before its redesign as recorded (K4_BEFORE). Then it drives the port's paths at
large-v1 full width with random weights from a seeded generator over
synthesized int16 audio, each with the kernels' launch counts reset just
before and read just after, and checks its output:
(3) the headline `transcribe_batched` call (K1-K4);
(4) the int4 call: the headline with int4 cross K/V, weights and self
    cache (K1, K2, K3-int4, K4-int4, K5; the int8 entries unused);
(5) the beam call: the headline with beam_size=5, its windows forced to
    full-length text (`full_text_opts`; K1-K4, K4 at G = 5 on the steps);
(6) the headline call with word timestamps, full-length text
    (`words_opts`; K1-K4 and K6);
(7) the sequential `transcribe` with word timestamps over 60 s (K1-K4, K6);
(8) the switches calls, the JAX package's alternative kernels: (a) the
    headline with WHISPER_AT_TPU_ENC_ATTN=flash, WHISPER_AT_TPU_CROSS_DECODE
    =stream and `models.decoder.FUSED_MLP` (K7, K2, K3, K8-int8, K10; not
    K1 or K4), (b) the same switches with int4 cross K/V, bf16 weights and
    the int8 self cache (K7, K2, K3-int4, K8, K10-int4; not K4-int4);
(10) the serving path: 72 files of 8-25 s through one
    `TranscriptionService` (three batches of 24, half the files prefetched
    to the card, the rest prefetched by its prep pool), token for token
    against a direct `transcribe_many`, then two WAV POSTs to its HTTP front
    end (K1-K4; `serving_check`);
(11) live streaming: 8 sessions of one `StreamingService`, 90 s each in
    250 ms blocks from their own threads, one with word timestamps (K1-K4,
    K6; `streaming_check`);
(12) the training path (`training_check`): 96 synthesized 10 s clips as
    WAVs, `research.feature_extract.extract_feature_set` at n_frames 1000
    (T = 500 encoder positions) in chunks of 24 into `feat_as_smoke` (K1
    and K2 once a layer a chunk, 128 each; K3 and K4 never; two clips held
    against the plain attention and MLP; a second call writes nothing), then
    TL-TR `lw_tr_1_8` at `recipes/run_as_full_train.sh`'s settings (lr 5e-5,
    batch 48, mixup 0.5, time masks 10, label smoothing 0.1, balanced
    sampling) for 2 epochs with validation, `wa_model` and its validation,
    a resumed third epoch, one step in fp32 beside bf16, and the step's
    time against its bound;
(13) the command line (`cli_check`): the model saved as a reference `.pt`,
    then `whisper_at_tpu_torch.cli.cli` in this process with its defaults
    (beam 5) over one 60 s WAV sequentially with highlighted word
    timestamps (K1, K2, K6) and over three WAVs of 20-70 s with
    `--batched True` (K1, K2); never K3 or K4. Each file's txt, vtt, srt,
    tsv and json parse and agree, every time lies in the 30 s window it was
    decoded from, the json carries the tags;
(14) speculative decoding (`spec_check`): the headline's windows at 96
    full-length tokens without the int8 self cache, greedy, with a random
    tiny draft and with the model as its own draft (K1-K4, K4 at G = 9 on
    the verify passes); each draft call's rows equal greedy's or differ
    first at a near tie, within twice the measured rounding noise between a
    verify pass and the single steps over the same prefix;
(15) the mesh phase (`mesh_check`): the headline's options over its first 8
    windows, first a 1 x 1 mesh over NCCL in this process, token for token
    and tag for tag the mesh-free call's; then this script twice more as
    two ranks sharing the card over gloo (`--mesh-rank`): dp 2
    (`transcribe_batched`, `transcribe_many`), pp 2 and sp 2 (the
    encoder), tp 2 (K1 and K4 at 10 heads, K2-partial at F 2560, K3 at N
    640, launched in each rank); every window equal to the mesh-free
    call's or differing first at a decision margin within twice the
    measured rounding noise, encoder, taps and tags within 2^-5 of the
    reference's largest magnitude, rates labelled two ranks sharing one
    card;
(16) the research paths (`research_check`): (a) the ESC-50 probe:
    `examples/esc50_probe_torch.make_clips`' 40 clips of 5 s through
    `extract_features(n_frames=500)` pooled over time ([40, 32, 1280]; K1
    and K2 32 times a clip, never K3 or K4), then `layer_wise_probe` at
    1000 epochs in float64 on the card and on the CPU, the fold accuracies
    and epoch counts equal, the largest coefficient difference printed
    beside the CPU tests' 1e-9; (b) `generate_noisy_set` over
    `examples/noise_robustness_torch.make_corpus`' 3 utterances x 2 noise
    classes x SNRs -10 / 0 / 10 (18 files), `transcribe_noisy_set` at its
    defaults (K1, K2; the default decode runs on the plain cross K/V, never
    K3 or K4), the WER a SNR and the class matrix; (c) `evaluate_audioset`
    over 4 clips of 10 s with a 527-row label csv, the gates off and every
    window decoded in full at T = 0, each prediction row equal to the
    clip's own `transcribe`, mAP again from the saved arrays. (b) alone
    gives the random decoder an end-of-text preference (`eot_preference`,
    undone after), so that each decode of its ladder ends after its first
    timestamp, as a trained decoder ends a window with nothing to say (the
    cut is printed);
(9) the streaming probe: `tools/probe_dma_torch.py`'s `probe` at the JAX
    probe's defaults (512 MiB int8 in 1 MiB chunks, the same numpy draw):
    P1 and P2 (cp.async and TMA rings at depths 2, 4, 8), each bitwise
    equal to the plain version in its sums and XOR word, beside torch.sum.
Each path's kernel inputs are also recorded (`Recorder`) and every kernel
is held against its plain version on them: K1-K5, K7, K8, K10 and the int4
entries at each shape the path gave them (K8 also against a repeat of the
same call, bit for bit), K6 on every call (bit for bit in float64 and
float32, beside its chain floor: `k6_step_ns` measures one step of its
dependent chain). K9 has no path (nothing in the JAX package calls it): it
is held against its plain version on the headline's own cross-K/V at one
query row per head, at batch 24 and one audio row, and timed cold there
over K/V sets used in turn (`k9_points`, K9_BEFORE as recorded).

Printed, in order: the card's name and power limit (nvidia-smi), the build
time, one line per kernel check (K5 one per weight shape and row count),
one line per path (throughput, launch counts, peak memory, the seek loop's
window count) with its held kernel inputs, the serving and streaming
phases' throughput beside the headline's, latency percentiles and stage
profiles (WHISPER_AT_TPU_SERVE_PROF, WHISPER_AT_TPU_STREAM_PROF), the int4
call's, the beam call's and the two switches calls' throughput side by
side, the extraction's and the training's lines, the probe's rows (GB/s
and share of 3.35 TB/s), then a JSON line with every kernel's numbers and, last, the `{"ok": true,
"device": ...}` line. Any failed phase raises and exits non-zero before the
result lines. Without a CUDA card it exits non-zero at once.
`tools/profile_torch_headline.py` takes its audio and options from here.
"""

import contextlib
import ctypes
import functools
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# published dense peaks of one H100 SXM (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# headline workload: large-v1 at full width, 24 windows of 30 s per batch
SIZE = "large-v1"
BATCH = 24
T_ENC = 1500
D = 1280
H = 20
DH = 64
TOKENS = 96
SEED = 0
# the options of the headline workload's transcribe_batched call
HEADLINE_OPTS = dict(language="en", temperature=0.0, sample_len=TOKENS, fp16=True,
                     max_batch=BATCH, logprob_threshold=None,
                     compression_ratio_threshold=None, no_speech_threshold=None,
                     kv_quant=True, weight_quant=True, self_kv_quant=True,
                     at_time_res=10)
# the int4 call: every int4 decode option (the headline-int4all-optin row)
INT4_OPTS = dict(HEADLINE_OPTS, kv_bits=4, weight_bits=4, self_kv_bits=4)
BEAM = 5
# speculative decoding's lookahead (the default) and K4's query rows a head
# on its verify pass
SPEC_LOOKAHEAD = 8
SPEC_G = SPEC_LOOKAHEAD + 1
# K5's weight shapes at large-v1, (K, N): qkv, attention out / cross query /
# cross out (one shape), fc1, fc2; its rows: a greedy step, the prefill
W4_SHAPES = dict(qkv=(D, 3 * D), out=(D, D), fc1=(D, 4 * D), fc2=(4 * D, D))
W4_PER_LAYER = dict(qkv=1, out=3, fc1=1, fc2=1)  # products of a layer's step
W4_ROWS = (BATCH, BATCH * 4)
# the sequential transcribe: the same decode options, one window at a time
SEQUENTIAL_S = 60
SEQUENTIAL_OPTS = dict({k: v for k, v in HEADLINE_OPTS.items() if k != "max_batch"},
                       word_timestamps=True, condition_on_previous_text=True)
# DTW (K6) shapes of the words path: 4 windows' text rows (ragged) x 1500
# frames per chunk, and the longest text a window can hold
DTW_ROWS = (101, 87, 64, 33)
DTW_FRAMES = 1500
DTW_WORST = 448
# the switches calls: the JAX package's alternative kernels (K7, K8, K10)
SWITCH_ENV = {"WHISPER_AT_TPU_ENC_ATTN": "flash", "WHISPER_AT_TPU_CROSS_DECODE": "stream"}
SWITCHES_B_OPTS = dict(HEADLINE_OPTS, kv_bits=4, weight_quant=False)
K8_POINTS = (BATCH, BATCH * 4, BATCH * BEAM)  # a greedy step, the greedy prefill, a beam-5 step
# cold timing: the decode loop reads each layer's weights and cross K/V after
# the 31 other layers', so it finds them in HBM, not in the 50 MB L2
L2_FLUSH_BYTES = 128 << 20  # written before each timed replay of a cold graph
N_LAYERS = 32               # large-v1's decoder layers: one weight set each in K5's step
COLD_SETS = 3               # K/V sets timed in turn: >= 100 MB touched between reuses
A1_MB = 100                 # at A = 1 (a 3.9 MB set) enough sets to touch this between reuses
# the streaming probe (P1, P2): the JAX probe's defaults; P2's rows in the
# kernels line are its depth-4 rings (every depth is printed)
PROBE_MB = 512
PROBE_CHUNK_KB = 1024
PROBE_ITERS = 5
PROBE_ROWS = {"P1": "auto", "P2-cp": "cp-4", "P2-tma": "tma-4"}
# the serving phase: 3 x BATCH files of 8-25 s (the JAX bench's serving row,
# `bench.py:292`) through one TranscriptionService, every other one prefetched;
# the fill window is long enough that only the window budget closes a batch
SERVE_SECONDS = (8, 26)
SERVE_FILL_S = 60.0
SERVE_HTTP_FILES = 2
# the streaming phase: 8 sessions of 90 s fed in 250 ms blocks from their own
# threads, saturated, one with word timestamps (`bench.py:541-600`)
STREAM_SESSIONS = 8
STREAM_SECONDS = 90
STREAM_BLOCK = 16000 // 4
STREAM_WAIT_S = 0.15
# K3 and K3-int4 before their redesign on gemm_sm90.cuh, as recorded (not
# this run)
K3_BEFORE = ("K3 1.0242-1.0435 ms, K3-int4 1.0131-1.0139 ms at [24, 1500, 1280], 0.0529-0.0545 "
             "ms at [1, 1500, 1280] (recorded: tools/time_k3.py over a git archive of 330a10f, "
             "NVIDIA H100 80GB HBM3, 700.00 W)")
# K2 before its redesign on gemm_sm90.cuh, as recorded (not this run)
K2_BEFORE = ("4.1369-4.1376 ms at [24, 1500, 1280], 0.2445-0.2502 ms at [1, 1500, 1280] "
             "(recorded: k2_points over a git archive of 4d99e7e, NVIDIA H100 80GB HBM3, "
             "700.00 W)")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sm_clock_mhz() -> float:
    """The card's maximum SM clock (MHz), as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `iters` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Mean device time of fn() from a CUDA graph of `iters` calls replayed
    `replays` times back to back (CUDA events): a kernel of a few
    microseconds, without the host's cost of launching it eagerly."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def cold_graph_ms(fns, flush, replays: int = 5) -> float:
    """Mean device time of one replay of a CUDA graph of the calls `fns`, in
    order. `flush()` runs before each replay, outside the timed span (CUDA
    events around the replay only), so the graph finds the L2 cold, as the
    decode loop finds one layer's operands after the other layers'."""
    for fn in fns:
        fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(replays):
        flush()
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / replays


def l2_flusher(dev):
    """A function that writes L2_FLUSH_BYTES, evicting whatever the L2 holds."""
    scratch = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    return scratch.zero_


def cold_sets(tensors, n: int = COLD_SETS) -> list:
    """`tensors` and n - 1 copies of them, to be used in turn (`cycle_ms`)."""
    return [tuple(tensors)] + [tuple(t.clone() for t in tensors) for _ in range(n - 1)]


def cycle_ms(fn, sets, iters: int) -> float:
    """Mean device time of fn(*sets[i % len(sets)]) over `iters` calls back
    to back: each call finds its operands cold once the other sets together
    exceed the L2, as the decode loop finds a layer's cross K/V."""
    it = itertools.cycle(sets)
    return time_ms(lambda: fn(*next(it)), iters)


def host_ms(fn, sets, iters: int) -> float:
    """Mean host time of one call fn(*s), sets in turn, over `iters` calls
    issued without waiting for the card: what the wrapper costs the host."""
    it = itertools.cycle(sets)
    fn(*next(it))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*next(it))
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / iters


def cold_cycle_ms(fn, sets, replays: int = 5) -> float:
    """Mean device time of one call fn(*s) in a CUDA graph of one call per
    set of `sets`, in turn: each call finds its operands cold as in
    `cycle_ms`, and the host's cost of launching eagerly stays off the
    clock."""
    return cold_graph_ms([lambda s=s: fn(*s) for s in sets], lambda: None, replays) / len(sets)


def set_mb(tensors) -> float:
    return sum(t.numel() * t.element_size() for t in tensors) / 1e6


def k4_bound(a: int, groups: int, bits: int):
    """K4's bound at A audio rows, G query rows a head, T_ENC valid
    positions: the valid positions' K and V codes and scales and the bias
    read once, q read and out written once; 4 A H G T 64 fp32 operations."""
    return bound(4.0 * a * H * groups * T_ENC * DH,
                 2 * a * T_ENC * D * bits / 8 + 2 * 4.0 * a * H * T_ENC + 4.0 * T_ENC
                 + 2.0 * a * H * groups * DH + 4.0 * a * H * groups * DH,
                 PEAK_FP32_FLOPS)


# the points at which K4 and K10 are timed cold: (A, G), the greedy step at
# batch 24, a beam step, the sequential call's step and the speculative
# call's verify pass (lookahead 8: G = 9)
K4_POINTS = ((BATCH, 1), (BATCH, BEAM), (1, 1), (BATCH, SPEC_G))
# K4 and K4-int4 before their redesign (git 5094ee7) at K4_POINTS: ms cold,
# eager over the K/V sets (`cross_decode_points`), the mean of two runs
# recorded on an NVIDIA H100 80GB HBM3 at 700 W, not measured in the run
# that prints them
K4_BEFORE = {8: {(BATCH, 1): 0.0882, (BATCH, BEAM): 0.1472, (1, 1): 0.0388},
             4: {(BATCH, 1): 0.0786, (BATCH, BEAM): 0.1390, (1, 1): 0.0377}}


def before_k4(bits: int, a: int, groups: int) -> str:
    ms = K4_BEFORE[bits].get((a, groups))
    if ms is None:
        return "no time before its redesign recorded at this point"
    return (f"before its redesign {ms:.4f} ms eager (recorded: git 5094ee7, NVIDIA H100 80GB "
            f"HBM3 at 700 W; not this run)")


def cross_decode_points(randn, kv, bias, bits: int) -> dict:
    """K4 (or K4-int4) and K10 (or K10-int4) on the same bytes, cold, at
    K4_POINTS: at batch 24 over COLD_SETS copies of kv (K3's layout,
    [BATCH, 1536, ...]), at A = 1 over enough copies of kv's first audio row
    to put A1_MB between reuses; each eager (`cycle_ms`, the host's launch
    cost included) and in a CUDA graph (`cold_cycle_ms`), and the host's
    time a call (`host_ms`). Returns {(A, G): dict(k4=ms, k4_graph=ms,
    k4_host=ms, k10=ms, k10_graph=ms, k10_host=ms, bound=(ms, by), sets=n)}."""
    from whisper_at_tpu_torch.ops import cross_decode as cd
    from whisper_at_tpu_torch.ops import cross_decode_stream as cs

    k4 = cd.cross_attention_int4 if bits == 4 else cd.cross_attention_int8
    k10 = cs.cross_attention_stream4 if bits == 4 else cs.cross_attention_stream
    row = tuple(t[:1].contiguous() for t in kv)
    sets_of = {BATCH: cold_sets(kv),
               1: cold_sets(row, max(COLD_SETS, int(-(-A1_MB // set_mb(row))) + 1))}
    points = {}
    for a, groups in K4_POINTS:
        sets = sets_of[a]
        qd = randn(a, H * groups, DH, scale=DH ** -0.5)
        iters = max(48, 2 * len(sets))
        f4 = lambda *s: k4(qd, *s, bias, H)  # noqa: E731
        f10 = lambda *s: k10(qd, *s, bias, H)  # noqa: E731
        points[(a, groups)] = dict(
            k4=cycle_ms(f4, sets, iters), k4_graph=cold_cycle_ms(f4, sets),
            k4_host=host_ms(f4, sets, iters), k10=cycle_ms(f10, sets, iters),
            k10_graph=cold_cycle_ms(f10, sets), k10_host=host_ms(f10, sets, iters),
            bound=k4_bound(a, groups, bits), sets=len(sets))
    return points


def bound(flops: float, nbytes: float, peak_flops: float):
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check(name: str, err: float, tol: float) -> None:
    if not err <= tol:
        raise AssertionError(f"{name}: max abs err {err} > tolerance {tol}")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


STEP_ITERS = 1 << 20  # dependent steps of the chain floor's measurement


@functools.lru_cache(maxsize=None)
def k6_step_ns() -> dict:
    """The latency of one step of K6's dependent chain on the card, in ns,
    by sum type, along a row (the cost feeds the next step's compares and
    add) and across rows (and a shuffle from lane l - 1 before them): one
    warp runs STEP_ITERS such steps (`dtw_step_chain` in csrc/dtw.cu),
    timed by CUDA events. Returns {(dtype, crosses_rows): ns}."""
    from whisper_at_tpu_torch.ops import dtw

    fn = dtw.KERNEL.c_function("dtw_step_chain", [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                               + [ctypes.c_void_p])
    seed = torch.randn(128, device="cuda")
    out = torch.zeros(1, dtype=torch.int64, device="cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    ns = {}
    for acc in (torch.float64, torch.float32):
        for cross in (False, True):
            def run():
                rc = fn(ctypes.c_void_p(seed.data_ptr()), ctypes.c_void_p(out.data_ptr()),
                        STEP_ITERS, int(acc == torch.float64), int(cross), stream)
                if rc:
                    raise RuntimeError(f"dtw_step_chain: CUDA error {rc}")
            ns[(acc, cross)] = time_ms(run, 3, 1) * 1e6 / STEP_ITERS
    return ns


def k6_floor_ms(n: int, m: int, acc, step_ns: dict) -> float:
    """K6's chain floor for one matrix of n DP rows and m columns: the path
    from (1, 1) to (n, m) has n + m - 1 cells, each a step of the chain
    along a row, and n - 1 of them cross rows (a shuffle more)."""
    along, across = step_ns[(acc, False)], step_ns[(acc, True)]
    return ((n + m - 1) * along + (n - 1) * (across - along)) / 1e6


def dtw_check(cases, step_ns: dict) -> dict:
    """K6 against its plain wavefront on each (x [G, N_max, M], n [G]) case,
    bit for bit with float64 and with float32 sums; the largest difference
    of a trace value over every compared pair; the kernel's (float64, the
    path's type, and float32), the plain version's, the byte bound's and
    the chain floor's (`k6_floor_ms` over the largest n, float64) mean time
    per call. Bytes: each valid cost row read once, the skewed int8 trace
    written once."""
    from whisper_at_tpu_torch.ops import dtw

    err, ms, ms32, plain_ms, bound_ms, floor_ms = 0.0, [], [], [], [], []
    for x, n in cases:
        for acc in (torch.float64, torch.float32):
            out = dtw.dtw_trace(x, n, acc)
            ref = dtw.dtw_trace_plain(x, n, acc)
            torch.cuda.synchronize()
            err = max(err, max_err(out, ref))
            if not torch.equal(out, ref):
                raise AssertionError(f"K6 {tuple(x.shape)} {acc}: trace differs from the "
                                     f"plain version at {int((out != ref).sum())} cells")
        g, n_max, m = x.shape
        ms.append(time_ms(lambda: dtw.dtw_trace(x, n), 10))
        ms32.append(time_ms(lambda: dtw.dtw_trace(x, n, torch.float32), 10))
        plain_ms.append(time_ms(lambda: dtw.dtw_trace_plain(x, n), 1, 1))
        nbytes = 4.0 * int(n.sum()) * m + g * (n_max + m + 1) * (n_max + 1) + 4.0 * g
        bound_ms.append(bound(0.0, nbytes, PEAK_FP32_FLOPS)[0])
        floor_ms.append(k6_floor_ms(min(int(n.max()), n_max), m, torch.float64, step_ns))
    shapes = ", ".join(f"{list(x.shape)} n={n.tolist()}" for x, n in cases)
    steps = [x.shape[1] + x.shape[2] - 1 for x, _ in cases]
    return dict(err=err, ms=float(np.mean(ms)), ms32=float(np.mean(ms32)),
                plain_ms=float(np.mean(plain_ms)), bound=(float(np.mean(bound_ms)), "bytes"),
                floor=float(np.mean(floor_ms)),
                tol=f"trace bitwise equal with float64 and float32 sums over {shapes}; "
                    f"{steps} diagonal steps")


def attention_worst(name, fast, plain, q, k, v, n_head):
    """K1 or K7 against its plain version per element: one bf16 ulp
    (<= 2^-7 |x|) plus 2^-10 absolute. Returns (max abs err, worst
    |out - ref| over that bound); raises above 1."""
    out = fast(q, k, v, n_head)
    ref = plain(q, k, v, n_head)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    worst = float((diff / (2 ** -10 + 2 ** -7 * ref.float().abs())).max())
    if not worst <= 1.0:
        raise AssertionError(f"{name} {tuple(q.shape)}: |out - ref| exceeds 2^-10 + 2^-7 "
                             f"|ref| by {worst:.3f}x")
    return float(diff.max()), worst


def k1_compare(q, k, v, n_head):
    """K1 against its plain version at attention_worst's bound. Returns (max
    abs err, tolerance text)."""
    from whisper_at_tpu_torch.ops import enc_attention

    err, worst = attention_worst("K1", enc_attention.enc_attention,
                                 enc_attention.enc_attention_plain, q, k, v, n_head)
    return err, f"|out - ref| <= 2^-10 + 2^-7 |ref| per element, worst at {worst:.3f} of it"


def attention_margins(card: str) -> None:
    """k1_compare's and k7_compare's bound on more inputs at [24, 1500, 1280].

    Seeds SEED+1 .. SEED+3 of the phase's inputs are held to it as seed SEED
    is. A one-ulp difference of an output x reads at most 2^e / (2^e + 2^-3)
    of it (e = floor(log2 |x|)), under 1 at any x; two ulps fail for
    |x| >= 1/8.

    Each seed also draws sharp rows over larger values (q, k x3, v x4),
    where a few large weights over values of both signs cancel. The kernels
    and the plain versions all round P to bf16 (unit roundoff u = 2^-8),
    each moving an output by up to u * sum_i p_i |v_i| + u |out|, so two of
    them may differ by 4u (p @ |v|): those inputs are held per element to
    2^-10 + 2^-6 (p @ |v|), with p @ |v| from K1's plain version on |v|,
    and their worst at the |ref| bound is printed beside it."""
    from whisper_at_tpu_torch.ops import enc_attention, enc_flash

    kernels = (("K1", enc_attention.enc_attention, enc_attention.enc_attention_plain),
               ("K7", enc_flash.enc_flash, enc_flash.enc_flash_plain))
    dev = torch.device("cuda")
    rows, failed = {}, []
    for seed in range(SEED + 1, SEED + 4):
        gen = torch.Generator(device=dev).manual_seed(seed)
        for label, scales in (("", (1, 1, 1)), ("sharp", (3, 3, 4))):
            q, k, v = ((torch.randn((BATCH, T_ENC, D), generator=gen, device=dev) * x)
                       .to(torch.bfloat16) for x in scales)
            mag = enc_attention.enc_attention_plain(q, k, v.abs(), H).float() if label else None
            for name, fast, plain in kernels:
                out, ref = fast(q, k, v, H).float(), plain(q, k, v, H).float()
                diff = (out - ref).abs()
                at_ref = float((diff / (2 ** -10 + 2 ** -7 * ref.abs())).max())
                cases = rows.setdefault(f"{name} {label}".strip(), [])
                if mag is None:
                    worst = at_ref
                    cases.append(f"{at_ref:.4f}")
                else:
                    worst = float((diff / (2 ** -10 + 2 ** -6 * mag)).max())
                    cases.append(f"{worst:.4f} (|ref| bound {at_ref:.3f})")
                if not worst <= 1.0:
                    failed.append(f"{name} {label} seed {seed} at {worst:.3f}x")
                del out, ref, diff
            del q, k, v, mag
    print(f"K1/K7 worst of the bound at [{BATCH}, {T_ENC}, {D}], seeds {SEED + 1}-{SEED + 3}: "
          + "; ".join(f"{key} {cases}" for key, cases in rows.items()) + f" [{card}]",
          flush=True)
    if failed:
        raise AssertionError(f"K1/K7 exceed their bound: {failed}")


def k2_compare(*args):
    """K2 against its plain version: 1e-3 + 2^-6 max |ref|."""
    from whisper_at_tpu_torch.ops import enc_mlp

    out = enc_mlp.enc_mlp(*args)
    ref = enc_mlp.enc_mlp_plain(*args)
    torch.cuda.synchronize()
    err = max_err(out, ref)
    tol = 1e-3 + 2 ** -6 * float(ref.float().abs().max())
    check(f"K2 {tuple(args[0].shape)}", err, tol)
    return err, f"{tol:.3e}"


def k2_bound(m: int, f: int = 4 * D):
    """K2's bound at m rows of D over f hidden units (4D; K2-partial a
    rank's 4D / tp): 4 m D f operations; x, the weights, LN and bias vectors
    and out, each read or written once (K2-partial reads no b2)."""
    vectors = 3 * D + f if f == 4 * D else 2 * D + f
    return bound(4.0 * m * D * f, 2.0 * (2 * m * D + 2 * D * f) + 4.0 * vectors,
                 PEAK_BF16_FLOPS)


def k2_partial_compare(*args):
    """K2-partial against its plain version: 1e-3 + 2^-6 max |ref|."""
    from whisper_at_tpu_torch.ops import enc_mlp

    out = enc_mlp.enc_mlp_partial(*args)
    ref = enc_mlp.enc_mlp_partial_plain(*args)
    torch.cuda.synchronize()
    err = max_err(out, ref)
    tol = 1e-3 + 2 ** -6 * float(ref.float().abs().max())
    check(f"K2-partial {tuple(args[0].shape)} F {args[3].shape[0]}", err, tol)
    return err, f"{tol:.3e}"


def k2_partial_row(card: str, args) -> dict:
    """K2-partial at the tensor-parallel widths of large-v1 (F = 2560 at
    tp 2, 1280 at tp 4) on the headline's K2 inputs: each rank's slice held
    against its plain version, the ranks' outputs summed plus x + b2 held
    against the whole K2's, and rank 0's slice timed (10 calls) beside the
    whole K2 and its bound. Returns the tp 2 row (the mesh phase's width)."""
    from whisper_at_tpu_torch.ops import enc_mlp

    x, ln_w, ln_b, w1, b1, w2, b2 = args
    f = 4 * D
    whole = enc_mlp.enc_mlp(*args)
    whole_ms = time_ms(lambda: enc_mlp.enc_mlp(*args), 10)
    rows = {}
    for tp in (2, 4):
        fr = f // tp
        parts = [(x, ln_w, ln_b, w1[r * fr:(r + 1) * fr], b1[r * fr:(r + 1) * fr],
                  w2[:, r * fr:(r + 1) * fr].contiguous()) for r in range(tp)]
        errs, tols = zip(*(k2_partial_compare(*p) for p in parts))
        total = sum(enc_mlp.enc_mlp_partial(*p).float() for p in parts)
        summed = (x.float() + total + b2.float()).to(torch.bfloat16)
        sum_err = max_err(summed, whole)
        sum_tol = 1e-3 + 2 ** -6 * float(whole.float().abs().max())
        check(f"K2-partial tp {tp} summed against K2", sum_err, sum_tol)
        ms = time_ms(lambda: enc_mlp.enc_mlp_partial(*parts[0]), 10)
        bnd = k2_bound(BATCH * T_ENC, fr)
        rows[tp] = dict(
            module=enc_mlp, kernel=enc_mlp.KERNEL_PARTIAL, err=max(errs),
            tol=(f"{tols[0]}; the {tp} ranks summed + x + b2 against K2: err {sum_err:.3e} "
                 f"<= {sum_tol:.3e}"),
            ms=ms, plain_ms=time_ms(lambda: enc_mlp.enc_mlp_partial_plain(*parts[0]), 3, 1),
            library_ms=None, bound=bnd)
        whole_bound = k2_bound(BATCH * T_ENC)[0]
        sms = enc_mlp.sm_count(0)
        fc1, fc2 = enc_mlp.plan(BATCH * T_ENC, fr, sms), enc_mlp.plan(BATCH * T_ENC, D, sms)
        print(f"K2-partial tp {tp} [{BATCH}, {T_ENC}, {D}] F {fr}: kernel {ms:.4f} ms a rank, "
              f"{100 * bnd[0] / ms:.1f}% of its {bnd[0]:.4f} ms bound; the whole K2 "
              f"{whole_ms:.4f} ms ({100 * whole_bound / whole_ms:.1f}% of {whole_bound:.4f} "
              f"ms); plan (width, blocks) fc1 {fc1}, fc2 {fc2}; max_abs_err {max(errs):.3e}, "
              f"summed over ranks {sum_err:.3e} [{card}]", flush=True)
    return rows[2]


def k2_chain(x, ln_w, ln_b, w1, b1, w2, b2):
    """The unfused chain K2 replaces, `models/encoder.py`'s mlp_impl "xla":
    x + fc2(gelu(fc1(mlp_ln(x)))) through layers.linear (cuBLAS products,
    the bias added to the bf16 product) and elementwise passes."""
    from whisper_at_tpu_torch.models.layers import gelu, layer_norm, linear

    return x + linear(gelu(linear(layer_norm(x, ln_w, ln_b), w1, b1)), w2, b2)


def k2_points(card: str, args=None) -> None:
    """K2 beside the unfused chain it replaces (`k2_chain`), each by
    `time_ms` over 10 calls on the same inputs, at the headline's rows
    [24, 1500, 1280] and at one audio row [1, 1500, 1280] (the sequential
    and words calls' shape; x's first row, the same weights); `args` are
    K2's headline inputs, made here from SEED when None (to time another
    checkout's K2, import this with that checkout's package first on
    sys.path). Prints one line."""
    from whisper_at_tpu_torch.ops import enc_mlp

    if args is None:
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        f = 4 * D

        def uniform(*shape, scale):
            return ((torch.rand(shape, generator=gen, device=dev) * 2 - 1) * scale).to(
                torch.bfloat16)

        args = (uniform(BATCH, T_ENC, D, scale=3 ** 0.5), 1 + uniform(D, scale=0.1),
                uniform(D, scale=0.1), uniform(f, D, scale=D ** -0.5),
                uniform(f, scale=D ** -0.5), uniform(D, f, scale=f ** -0.5),
                uniform(D, scale=f ** -0.5))
    parts = []
    for a in (BATCH, 1):
        inputs = (args[0][:a],) + tuple(args[1:])
        ms = time_ms(lambda: enc_mlp.enc_mlp(*inputs), 10)
        chain = time_ms(lambda: k2_chain(*inputs), 10)
        b_ms = k2_bound(a * T_ENC)[0]
        parts.append(f"[{a}, {T_ENC}, {D}] kernel {ms:.4f} ms, the unfused chain it replaces "
                     f"{chain:.4f} ms ({ms / chain:.3f}x), {100 * b_ms / ms:.1f}% of the "
                     f"{b_ms:.4f} ms bound")
    print("K2: " + "; ".join(parts) + f"; before its redesign {K2_BEFORE} [{card}]", flush=True)


def k3_bound(b: int, bits: int, n: int = D):
    """K3's bound (or K3-int4's) at b audio rows of large-v1 over n output
    columns (D; a tensor-parallel rank's D / tp): xa, the weight pair and bv
    read once, the codes and fp32 scales of K and V written once; 2 x 2 b
    Ta D n operations."""
    ta_pad = -(-T_ENC // 128) * 128
    return bound(2.0 * 2 * b * T_ENC * D * n,
                 2.0 * b * T_ENC * D + 2 * 2.0 * n * D + 2.0 * n
                 + 2 * (b * ta_pad * n * bits / 8 + 4.0 * b * (n // DH) * ta_pad),
                 PEAK_BF16_FLOPS)


def k3_tp_points(card: str, xa, wk, wv, bv) -> None:
    """K3 and K3-int4 on a tensor-parallel rank's [D / tp, D] weights (rank
    0's rows of one layer) at tp 2 and 4 (N = 640, 320) beside the whole
    layer (N = 1280), on the headline's xa [24, 1500, 1280]: held against
    the plain version (tp > 1; the whole layer is held in its rows), and
    timed hot over 10 launches of one layer's weights, each beside its
    bound. Prints one line an entry."""
    from whisper_at_tpu_torch.ops import kv_quant

    for entry, bits in (("K3", 8), ("K3-int4", 4)):
        project = kv_quant.project_quantize_kv4 if bits == 4 else kv_quant.project_quantize_kv
        parts = []
        for tp in (1, 2, 4):
            n = D // tp
            w = tuple(t[:n].contiguous() for t in (wk, wv, bv))
            err = k3_compare(xa, *w, bits=bits)[0] if tp > 1 else None
            ms = time_ms(lambda: project(xa, *w), 10)
            bnd = k3_bound(BATCH, bits, n)
            bn, blocks = kv_quant.plan(BATCH, T_ENC, n, kv_quant.sm_count(0))
            parts.append(f"N {n}{'' if tp == 1 else f' (tp {tp})'} {ms:.4f} ms, "
                         f"{100 * bnd[0] / ms:.1f}% of {bnd[0]:.4f} ms, {bn}-wide tiles on "
                         f"{blocks} blocks" + ("" if err is None else f", err {err:.3e}"))
        print(f"{entry} at tensor-parallel widths [{BATCH}, {T_ENC}, {D}] (hot, 10 launches of "
              f"one layer's weights): " + "; ".join(parts) + f" [{card}]", flush=True)


def k3_inputs(gen, dev):
    """xa [24, 1500, 1280] and N_LAYERS layers' (wk, wv, bv) at large-v1
    width, bf16, drawn from gen."""
    def uniform(*shape):
        return ((torch.rand(shape, generator=gen, device=dev) * 2 - 1) * D ** -0.5).to(
            torch.bfloat16)

    xa = torch.randn((BATCH, T_ENC, D), generator=gen, device=dev).to(torch.bfloat16)
    return xa, [(uniform(D, D), uniform(D, D), uniform(D)) for _ in range(N_LAYERS)]


def k3_points(card: str, xa=None, layers=None) -> dict:
    """K3 and K3-int4 as `precompute_cross_kv` meets them: one launch a
    layer over N_LAYERS layers' own weight pairs (210 MB) on one xa, each
    into its layer's slice of a stacked output, timed per launch as a CUDA
    graph of the N_LAYERS launches (`cold_graph_ms`; the weights and the
    batch-24 xa exceed the L2 between reuses), at the headline's [24, 1500,
    1280] and at one audio row (xa's first); the plain version beside (one
    layer, eager); the share of the bound. xa and layers from `k3_inputs`,
    made here from SEED when None (to time another checkout's K3, import
    this with that checkout's package first: `tools/time_k3.py`). Prints one
    line a point; returns {(entry, b): dict(ms, plain, bound)}."""
    from whisper_at_tpu_torch.ops import kv_quant

    dev = torch.device("cuda")
    if xa is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        xa, layers = k3_inputs(gen, dev)
    ta_pad = kv_quant.pad_ta(T_ENC)
    points = {}
    for entry, bits in (("K3", 8), ("K3-int4", 4)):
        project = kv_quant.project_quantize_kv4 if bits == 4 else kv_quant.project_quantize_kv
        for b in (BATCH, 1):
            x = xa[:b]
            k = torch.empty((N_LAYERS, b, ta_pad, D * bits // 8), dtype=torch.int8, device=dev)
            ks = torch.empty((N_LAYERS, b, H, ta_pad), dtype=torch.float32, device=dev)
            v, vs = torch.empty_like(k), torch.empty_like(ks)
            fns = [lambda i=i, w=w: project(x, *w, out=(k[i], ks[i], v[i], vs[i]))
                   for i, w in enumerate(layers)]
            r = dict(ms=cold_graph_ms(fns, lambda: None) / N_LAYERS,
                     plain=time_ms(lambda: kv_quant.project_quantize_kv_plain(
                         x, *layers[0], bits=bits), 3, 1),
                     bound=k3_bound(b, bits))
            del fns, k, ks, v, vs
            points[(entry, b)] = r
            print(f"{entry} [{b}, {T_ENC}, {D}]: kernel {r['ms']:.4f} ms a launch (a CUDA "
                  f"graph of {N_LAYERS} launches over {N_LAYERS} layers' weight pairs on one "
                  f"xa), {100 * r['bound'][0] / r['ms']:.1f}% of the {r['bound'][0]:.4f} ms "
                  f"bound ({r['bound'][1]}); plain {r['plain']:.4f} ms [{card}]", flush=True)
    torch.cuda.empty_cache()
    print(f"K3 before its redesign: {K3_BEFORE}", flush=True)
    return points


def k3_compare(xa, wk, wv, bv, bits: int = 8):
    """K3 (or its int4 entry) against its plain version: codes within 1 LSB
    on <= 1e-3 of the entries, scales within 2^-7 relative; the error is
    that of the dequantized K/V. Returns (err, tolerance text, the kernel's
    output)."""
    from whisper_at_tpu_torch.models.layers import unpack4
    from whisper_at_tpu_torch.ops import kv_quant

    project = kv_quant.project_quantize_kv4 if bits == 4 else kv_quant.project_quantize_kv
    kern = project(xa, wk, wv, bv)
    plain = kv_quant.project_quantize_kv_plain(xa, wk, wv, bv, bits=bits)
    torch.cuda.synchronize()
    codes = (lambda t: unpack4(t).int()) if bits == 4 else (lambda t: t.int())
    code_diff = torch.cat([(codes(kern[i]) - codes(plain[i])).abs().flatten() for i in (0, 2)])
    frac = float((code_diff > 0).float().mean())
    name = f"K3{'-int4' if bits == 4 else ''} {tuple(xa.shape)}"
    if int(code_diff.max()) > 1 or frac > 1e-3:
        raise AssertionError(f"{name}: codes differ by up to {int(code_diff.max())} on "
                             f"{frac:.2e} of entries (limit 1 LSB on 1e-3)")
    s_rel = max(float(((kern[i] - plain[i]).abs() / plain[i].clamp_min(1e-30)).max())
                for i in (1, 3))
    if s_rel > 2 ** -7:
        raise AssertionError(f"{name}: scales differ by rel {s_rel} > {2 ** -7}")
    b, ta_pad = kern[0].shape[:2]
    h = kern[1].shape[1]

    def dequant(c, scales):
        return codes(c).float().view(b, ta_pad, h, -1) * scales.transpose(1, 2)[..., None]

    err = max(max_err(dequant(kern[i], kern[i + 1]), dequant(plain[i], plain[i + 1]))
              for i in (0, 2))
    return err, (f"codes within 1 LSB on <= 1e-3 of entries (got {frac:.1e}), "
                 f"scales rel <= 2^-7 (got {s_rel:.1e})"), kern


def k4_compare(q, kq, ks, vq, vs, bias, n_head, bits: int = 8):
    """K4 (or its int4 entry) against its plain version: 1e-4 + 1e-3 max |ref|."""
    from whisper_at_tpu_torch.ops import cross_decode as cd

    kernel, plain = ((cd.cross_attention_int4, cd.cross_attention_int4_plain) if bits == 4
                     else (cd.cross_attention_int8, cd.cross_attention_int8_plain))
    out = kernel(q, kq, ks, vq, vs, bias, n_head)
    ref = plain(q, kq, ks, vq, vs, bias, n_head)
    torch.cuda.synchronize()
    err = max_err(out, ref)
    tol = 1e-4 + 1e-3 * float(ref.abs().max())
    check(f"K4{'-int4' if bits == 4 else ''} {tuple(q.shape)}", err, tol)
    return err, f"{tol:.3e}"


def k5_compare(x, wp):
    """K5 against its plain version: bf16 x int4 products are exact in fp32,
    so only the summation order differs; 2^-18 of max sum |x| |w|."""
    from whisper_at_tpu_torch.models.layers import unpack4
    from whisper_at_tpu_torch.ops import w4_matmul

    out = w4_matmul.w4_matmul(x, wp)
    ref = w4_matmul.w4_matmul_plain(x, wp)
    torch.cuda.synchronize()
    err = max_err(out, ref)
    tol = 2 ** -18 * float((x.float().abs() @ unpack4(wp).float().abs().t()).max())
    check(f"K5 {tuple(x.shape)} x {tuple(wp.shape)}", err, tol)
    return err, f"{tol:.3e}"


def k7_compare(q, k, v, n_head):
    """K7 against its plain version at K1's bound (attention_worst)."""
    from whisper_at_tpu_torch.ops import enc_flash

    err, worst = attention_worst("K7", enc_flash.enc_flash, enc_flash.enc_flash_plain,
                                 q, k, v, n_head)
    return err, f"|out - ref| <= 2^-10 + 2^-7 |ref| per element, worst at {worst:.3f} of it"


def k8_compare(x, fc1, fc2):
    """K8 (bf16 or int8 entry, as the modules are) against its plain
    version: 2^-7 of max |ref| plus 1e-3 (an h entry rounded to bf16 the
    other way moves an output by one ulp of h times its fc2 row)."""
    from whisper_at_tpu_torch.ops import fused_mlp

    w1, s1, b1 = fused_mlp.linear_weights(fc1)
    w2, s2, b2 = fused_mlp.linear_weights(fc2)
    out = fused_mlp.fused_mlp(x, fc1, fc2)
    again = fused_mlp.fused_mlp(x, fc1, fc2)
    ref = fused_mlp.fused_mlp_plain(x, w1, s1, b1, w2, s2, b2)
    torch.cuda.synchronize()
    name = f"K8{'' if s1 is None else '-int8'} {tuple(x.shape)}"
    if not torch.equal(out, again):
        raise AssertionError(f"{name}: two calls on the same inputs differ")
    err = max_err(out, ref)
    tol = 1e-3 + 2 ** -7 * float(ref.float().abs().max())
    check(name, err, tol)
    return err, f"{tol:.3e}, bitwise equal on a repeat"


def k9_compare(q, kq, ks, vq, vs, n_head, s):
    """K9 against its plain version: both fp32 to the bf16 output, which
    may round the other way; 2^-7 |ref| (one bf16 ulp) + 1e-5 per element."""
    from whisper_at_tpu_torch.ops import flash_decode

    out = flash_decode.flash_decode_cross(q, kq, ks, vq, vs, n_head, s)
    ref = flash_decode.flash_decode_cross_plain(q, kq, ks, vq, vs, n_head, s)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    worst = float((diff / (1e-5 + 2 ** -7 * ref.float().abs())).max())
    if not worst <= 1.0:
        raise AssertionError(f"K9 {tuple(q.shape)}: |out - ref| exceeds 1e-5 + 2^-7 |ref| "
                             f"by {worst:.3f}x")
    return float(diff.max()), f"|out - ref| <= 1e-5 + 2^-7 |ref| per element, worst at " \
                              f"{worst:.3f} of it"


# K9 before its redesign (git ea8d90e), cold, eager over K/V sets used in
# turn (`k9_points`) at batch 24 and one audio row: the mean of two turns of
# tools/time_k6_k9.py in one call on an NVIDIA H100 80GB HBM3 at 700 W, not
# measured in the run that prints them
K9_BEFORE = {BATCH: 0.0748, 1: 0.0557}


def k9_points(randn, kv) -> dict:
    """K9 cold, as K4 is timed (`cross_decode_points`): at batch 24 over
    COLD_SETS copies of kv (K3's layout, (kq, ks, vq, vs)) and at one audio
    row over enough copies of kv's first row to put A1_MB between reuses,
    one query row a head over T_ENC positions; eager (`cycle_ms`) and in a
    CUDA graph (`cold_cycle_ms`). Returns {A: dict(ms=, graph=, bound=(ms,
    by), sets=n)}."""
    from whisper_at_tpu_torch.ops import flash_decode

    row = tuple(t[:1].contiguous() for t in kv)
    sets_of = {BATCH: cold_sets(kv),
               1: cold_sets(row, max(COLD_SETS, int(-(-A1_MB // set_mb(row))) + 1))}
    points = {}
    for a, sets in sets_of.items():
        q = randn(a * H, DH)
        fn = lambda *s: flash_decode.flash_decode_cross(q, *s, H, T_ENC)  # noqa: E731
        points[a] = dict(
            ms=cycle_ms(fn, sets, max(48, 2 * len(sets))), graph=cold_cycle_ms(fn, sets),
            bound=bound(4.0 * a * H * T_ENC * DH,
                        2 * a * T_ENC * D + 2 * 4.0 * a * H * T_ENC + 2 * 2.0 * a * H * DH,
                        PEAK_FP32_FLOPS),
            sets=len(sets))
    return points


def print_k9_points(card: str, points: dict) -> None:
    for a, p in points.items():
        print(f"K9 A={a} G=1 cold over {p['sets']} K/V sets: eager {p['ms']:.4f} ms, graph "
              f"{p['graph']:.4f} ms; {100 * p['bound'][0] / p['ms']:.1f}% of the "
              f"{p['bound'][0]:.4f} ms bound eager, {100 * p['bound'][0] / p['graph']:.1f}% in "
              f"the graph; before its redesign {K9_BEFORE[a]:.4f} ms eager (K9_BEFORE, "
              f"recorded, not this run) [{card}]", flush=True)


def k10_compare(q, kq, ks, vq, vs, bias, n_head, bits: int = 8):
    """K10 (or its int4 entry) against its plain version, which rounds at
    the same points: 1e-4 + 1e-3 max |ref|, as K4."""
    from whisper_at_tpu_torch.ops import cross_decode_stream as cs

    kernel, plain = ((cs.cross_attention_stream4, cs.cross_attention_stream4_plain) if bits == 4
                     else (cs.cross_attention_stream, cs.cross_attention_stream_plain))
    out = kernel(q, kq, ks, vq, vs, bias, n_head)
    ref = plain(q, kq, ks, vq, vs, bias, n_head)
    torch.cuda.synchronize()
    err = max_err(out, ref)
    tol = 1e-4 + 1e-3 * float(ref.abs().max())
    check(f"K10{'-int4' if bits == 4 else ''} {tuple(q.shape)}", err, tol)
    return err, f"{tol:.3e}"


COMPARE = {"K1": k1_compare, "K2": k2_compare, "K2-partial": k2_partial_compare, "K3": lambda *a: k3_compare(*a)[:2],
           "K4": k4_compare, "K3-int4": lambda *a: k3_compare(*a, bits=4)[:2],
           "K4-int4": lambda *a: k4_compare(*a, bits=4), "K5": k5_compare,
           "K7": k7_compare, "K8": k8_compare, "K10": k10_compare,
           "K10-int4": lambda *a: k10_compare(*a, bits=4)}


def k5_rows(gen, dev) -> dict:
    """K5 at every weight shape of the decode loop, with 24 and 96 rows,
    held against its plain version and timed beside torch.matmul of x with
    the bf16 weight (the full-width product int4 replaces).

    Cold, as the decode loop meets them: N_LAYERS layers of weights, each
    layer its own six (qkv, three of the out shape, fc1, fc2; 367 MB of
    int4, 1.47 GB of bf16 for torch.matmul). One greedy layer-step is a CUDA
    graph of all 192 products in layer order, reported per layer; each
    shape is a graph of its products over the 32 layers, reported per
    product (`cold_graph_ms`, the L2 flushed before each replay). Hot, as
    before: one weight from a graph of 20 calls replayed (`graph_ms`), and
    the eager time per call, host launch included. The kernels-line row is
    the cold layer-step at M = 24."""
    from whisper_at_tpu_torch.models.layers import pack4
    from whisper_at_tpu_torch.ops import w4_matmul

    flush = l2_flusher(dev)
    layers = []  # per layer: (shape name, packed int4 weight, bf16 weight) in step order
    for _ in range(N_LAYERS):
        layer = []
        for name, (k, n) in W4_SHAPES.items():
            for _ in range(W4_PER_LAYER[name]):
                codes = torch.randint(-7, 8, (n, k), generator=gen, device=dev,
                                      dtype=torch.int8)
                layer.append((name, pack4(codes), codes.to(torch.bfloat16)))
        layers.append(layer)
    products = [p for layer in layers for p in layer]
    total = dict(err=0.0, plain_ms=0.0, ops=0.0, bytes=0.0)
    tols, steps = [], {}
    for m in W4_ROWS:
        xs = {name: torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
              for name, (k, n) in W4_SHAPES.items()}
        for name, (k, n) in W4_SHAPES.items():
            x = xs[name]
            mine = [(wp, w16) for nm, wp, w16 in products if nm == name]
            wp, w16 = mine[0]
            err, tol = k5_compare(x, wp)
            cold = cold_graph_ms([lambda wp=wp: w4_matmul.w4_matmul(x, wp) for wp, _ in mine],
                                 flush) / len(mine)
            cold_lib = cold_graph_ms([lambda w=w: torch.matmul(x, w.t()) for _, w in mine],
                                     flush) / len(mine)
            hot = graph_ms(lambda: w4_matmul.w4_matmul(x, wp))
            eager_ms = time_ms(lambda: w4_matmul.w4_matmul(x, wp), 100)
            plain_ms = graph_ms(lambda: w4_matmul.w4_matmul_plain(x, wp), 5, 2)
            hot_lib = graph_ms(lambda: torch.matmul(x, w16.t()))
            ops, nbytes = 2.0 * m * n * k, n * k / 2 + 2.0 * m * k + 4.0 * m * n
            b_ms, b_by = bound(ops, nbytes, PEAK_BF16_FLOPS)
            print(f"K5 {name} M={m} K={k} N={n}: max_abs_err={err:.3e} (tol {tol}) cold: "
                  f"kernel_ms={cold:.4f} library_ms={cold_lib:.4f} (torch.matmul, bf16 weight; mean "
                  f"over the {len(mine)} weights of {N_LAYERS} layers, one graph, L2 flushed "
                  f"before each replay); hot: kernel_ms={hot:.4f} library_ms={hot_lib:.4f} (one "
                  f"weight, graph of 20 calls); eager, launch included, hot: {eager_ms:.4f}; "
                  f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by})", flush=True)
            tols.append(f"M={m} {name}: {err:.2e} <= {tol}")
            total["err"] = max(total["err"], err)
            if m == BATCH:
                reps = W4_PER_LAYER[name]
                total["plain_ms"] += reps * plain_ms
                total["ops"] += reps * ops
                total["bytes"] += reps * nbytes
        step = cold_graph_ms([lambda nm=nm, wp=wp: w4_matmul.w4_matmul(xs[nm], wp)
                              for nm, wp, _ in products], flush) / N_LAYERS
        step_lib = cold_graph_ms([lambda nm=nm, w=w: torch.matmul(xs[nm], w.t())
                                  for nm, _, w in products], flush) / N_LAYERS
        steps[m] = (step, step_lib)
        print(f"K5 greedy layer-step M={m}, cold: kernel_ms={step:.4f} library_ms={step_lib:.4f} "
              f"(torch.matmul, bf16 weights) = {step / step_lib:.3f}x, per layer of a graph of "
              f"{len(products)} products over {N_LAYERS} layers' weights", flush=True)
    del layers, products
    return dict(module=w4_matmul, err=total["err"],
                tol="; ".join(tols) + f"; cold layer-step at M={W4_ROWS[1]}: "
                f"{steps[W4_ROWS[1]][0]:.4f} ms, torch.matmul {steps[W4_ROWS[1]][1]:.4f} ms",
                ms=steps[BATCH][0], plain_ms=total["plain_ms"], library_ms=steps[BATCH][1],
                bound=bound(total["ops"], total["bytes"], PEAK_BF16_FLOPS))


def k8_bound(m: int, int8: bool):
    """K8's bound at m rows of large-v1: the weight pair (int8: and its fp32
    scales), the biases, x and out, each read or written once; 4 m D 4D
    operations."""
    f = 4 * D
    wbytes = 2.0 * D * f * (1 if int8 else 2) + (4.0 * (f + D) if int8 else 0.0)
    return bound(4.0 * m * D * f, wbytes + 2.0 * (f + D) + 2 * 2.0 * m * D, PEAK_BF16_FLOPS)


def k8_chain(x, fc1, fc2):
    """The unfused MLP K8 replaces, `models/decoder.py`'s path with FUSED_MLP
    off: fc2(gelu(fc1(x))) through the modules (a QuantLinear widens its int8
    weight to bf16 on every call, then torch.matmul, the scale, the bias)."""
    from whisper_at_tpu_torch.models.layers import gelu

    return fc2(gelu(fc1(x)))


def k8_layers(gen, dev) -> dict:
    """N_LAYERS layers' decoder MLP pairs (fc1, fc2) at large-v1 width: bf16
    Linear pairs drawn from gen ("K8") and their int8 QuantLinear pairs
    ("K8-int8")."""
    from whisper_at_tpu_torch.models.layers import Linear, quantize_linear

    layers = {"K8": [], "K8-int8": []}
    for _ in range(N_LAYERS):
        pair = (Linear(D, 4 * D, device=dev, dtype=torch.bfloat16),
                Linear(4 * D, D, device=dev, dtype=torch.bfloat16))
        for fc in pair:
            fc.reset_random(gen)
            fc.requires_grad_(False)
        layers["K8"].append(pair)
        layers["K8-int8"].append(tuple(quantize_linear(fc) for fc in pair))
    return layers


def k8_points(card: str, layers=None) -> dict:
    """K8 and K8-int8 at K8_POINTS, cold as the decode loop meets them: a
    CUDA graph of one call per layer over N_LAYERS layers' own weight pairs
    (420 MB int8, 839 MB bf16) with the L2 flushed before each replay, per
    call (`cold_graph_ms`); the unfused MLP it replaces (`k8_chain`) the
    same way in the same call; hot figures beside, labelled (one pair, a
    graph of 20 calls); the host's time a call (`host_ms`, the pairs in
    turn); the share of the bound. `layers` from `k8_layers`, made here
    from SEED when None (to time another checkout's K8, import this with
    that checkout's package first on sys.path: `tools/time_k8.py`). Prints
    one line a point; returns {(entry, m): dict(ms, chain, hot, hot_chain,
    host, bound)}."""
    from whisper_at_tpu_torch.ops import fused_mlp

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    if layers is None:
        layers = k8_layers(gen, dev)
    flush = l2_flusher(dev)
    points = {}
    with torch.no_grad():
        for entry, pairs in layers.items():
            for m in K8_POINTS:
                x = torch.randn((m, D), generator=gen, device=dev).to(torch.bfloat16)

                def kernel(fc1, fc2, x=x):
                    return fused_mlp.fused_mlp(x, fc1, fc2)

                def chain(fc1, fc2, x=x):
                    return k8_chain(x, fc1, fc2)

                r = dict(
                    ms=cold_graph_ms([lambda p=p: kernel(*p) for p in pairs], flush) / len(pairs),
                    chain=cold_graph_ms([lambda p=p: chain(*p) for p in pairs],
                                        flush) / len(pairs),
                    hot=graph_ms(lambda: kernel(*pairs[0])),
                    hot_chain=graph_ms(lambda: chain(*pairs[0])),
                    host=host_ms(kernel, pairs, 4 * len(pairs)),
                    bound=k8_bound(m, entry == "K8-int8"))
                points[(entry, m)] = r
                print(f"{entry} M={m} cold: kernel {r['ms']:.4f} ms, the unfused MLP it "
                      f"replaces {r['chain']:.4f} ms ({r['ms'] / r['chain']:.3f}x; per call of "
                      f"a graph over {len(pairs)} layers' pairs, L2 flushed before each "
                      f"replay); {100 * r['bound'][0] / r['ms']:.1f}% of the "
                      f"{r['bound'][0]:.4f} ms bound ({r['bound'][1]}); hot (one pair, a graph "
                      f"of 20 calls): kernel {r['hot']:.4f} ms, unfused {r['hot_chain']:.4f} "
                      f"ms; host {r['host']:.4f} ms a call [{card}]", flush=True)
    return points


def k8_rows(card: str, gen, dev) -> dict:
    """K8 and K8-int8 held against the plain version (and against a repeat
    of the same call, bit for bit) at K8_POINTS on the first layer's pair,
    then timed (`k8_points`). Each row's ms is the cold call at M = 24; the
    unfused MLP's cold time and the other points go in its tolerance
    string."""
    from whisper_at_tpu_torch.ops import fused_mlp

    layers = k8_layers(gen, dev)
    points = k8_points(card, layers)
    rows = {}
    for entry, pairs in layers.items():
        errs, tols = [], []
        for m in K8_POINTS:
            x = torch.randn((m, D), generator=gen, device=dev).to(torch.bfloat16)
            e, tol = k8_compare(x, *pairs[0])
            errs.append(e)
            tols.append(f"M={m}: err {e:.3e} <= {tol}")
        at = points[(entry, BATCH)]
        tols.append(f"cold at M={BATCH}: the unfused MLP it replaces {at['chain']:.4f} ms; "
                    + ", ".join(f"M={m}: kernel {points[(entry, m)]['ms']:.4f} ms, unfused "
                                f"{points[(entry, m)]['chain']:.4f} ms"
                                for m in K8_POINTS if m != BATCH))
        x = torch.randn((BATCH, D), generator=gen, device=dev).to(torch.bfloat16)
        weights = (*fused_mlp.linear_weights(pairs[0][0]), *fused_mlp.linear_weights(pairs[0][1]))
        rows[entry] = dict(
            module=fused_mlp, kernel=fused_mlp.KERNEL if entry == "K8" else fused_mlp.KERNEL_INT8,
            err=max(errs), tol="; ".join(tols), ms=at["ms"],
            plain_ms=graph_ms(lambda: fused_mlp.fused_mlp_plain(x, *weights), 5, 2),
            library_ms=None, bound=at["bound"])
    del layers
    torch.cuda.empty_cache()
    return rows


def kernel_checks(card: str):
    """Each kernel against its plain version at the headline shapes.
    Returns the rows by kernel id and K9's launches in this phase."""
    from whisper_at_tpu_torch.ops import (
        cross_decode,
        cross_decode_stream,
        dtw,
        enc_attention,
        enc_flash,
        enc_mlp,
        flash_decode,
        kv_quant,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    def uniform(*shape, bound_=1.0):
        return ((torch.rand(shape, generator=gen, device=dev) * 2 - 1) * bound_).to(bf)

    rows = {}

    # ---- K1 encoder attention: q, k, v [24, 1500, 1280] -------------------- #
    q, k, v = (randn(BATCH, T_ENC, D) for _ in range(3))
    err, tol = k1_compare(q, k, v, H)
    qh, kh, vh = (x.view(BATCH, T_ENC, H, DH).transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    flops = 4.0 * BATCH * H * T_ENC * T_ENC * DH
    nbytes = 4.0 * BATCH * T_ENC * D * 2
    rows["K1"] = dict(
        module=enc_attention, err=err, tol=tol,
        ms=time_ms(lambda: enc_attention.enc_attention(q, k, v, H), 10),
        plain_ms=time_ms(lambda: enc_attention.enc_attention_plain(q, k, v, H), 3, 1),
        library_ms=time_ms(lambda: sdpa(qh, kh, vh), 10),
        bound=bound(flops, nbytes, PEAK_BF16_FLOPS))

    # ---- K7 flash encoder attention on the same inputs, beside K1 and SDPA -- #
    err, tol = k7_compare(q, k, v, H)
    rows["K7"] = dict(
        module=enc_flash, err=err, tol=f"{tol}; K1 {rows['K1']['ms']:.4f} ms on these inputs",
        ms=time_ms(lambda: enc_flash.enc_flash(q, k, v, H), 10),
        plain_ms=time_ms(lambda: enc_flash.enc_flash_plain(q, k, v, H), 3, 1),
        library_ms=time_ms(lambda: sdpa(qh, kh, vh), 10),
        bound=bound(flops, nbytes, PEAK_BF16_FLOPS))
    del q, k, v, qh, kh, vh
    attention_margins(card)
    # beside the bound: one ex2 a score, at 16 a clock on each SM
    sms, mhz = torch.cuda.get_device_properties(0).multi_processor_count, sm_clock_mhz()
    n_exp = float(BATCH * H * T_ENC * T_ENC)
    exp_floor_ms = n_exp / (16 * sms * mhz * 1e6) * 1e3
    for name in ("K1", "K7"):
        r = rows[name]
        print(f"{name} on the card: {r['ms']:.4f} ms, {r['ms'] / r['library_ms']:.3f}x SDPA's "
              f"{r['library_ms']:.4f} ms in this run, {100 * r['bound'][0] / r['ms']:.1f}% of "
              f"the {r['bound'][0]:.4f} ms bound; exp floor {exp_floor_ms:.4f} ms ({n_exp:.4g} "
              f"ex2 at 16 a clock on {sms} SMs at {mhz:.0f} MHz) [{card}]", flush=True)

    # ---- K2 encoder MLP half-block: x [24, 1500, 1280], 4D = 5120 ---------- #
    f = 4 * D
    x = randn(BATCH, T_ENC, D)
    ln_w = (1 + 0.1 * torch.randn(D, generator=gen, device=dev)).to(bf)
    ln_b = randn(D, scale=0.1)
    w1, b1 = uniform(f, D, bound_=D ** -0.5), uniform(f, bound_=D ** -0.5)
    w2, b2 = uniform(D, f, bound_=f ** -0.5), uniform(D, bound_=f ** -0.5)
    args = (x, ln_w, ln_b, w1, b1, w2, b2)
    err, tol = k2_compare(*args)
    err_row, _ = k2_compare(x[:1], *args[1:])
    rows["K2"] = dict(
        module=enc_mlp, err=max(err, err_row), tol=f"{tol}; [1, {T_ENC}, {D}] err {err_row:.3e}",
        ms=time_ms(lambda: enc_mlp.enc_mlp(*args), 10),
        plain_ms=time_ms(lambda: enc_mlp.enc_mlp_plain(*args), 3, 1),
        library_ms=None,
        bound=k2_bound(BATCH * T_ENC))
    k2_points(card, args)
    rows["K2-partial"] = k2_partial_row(card, args)
    del x, args, w1, w2

    # ---- K8 decode MLP: x [M, 1280], W1 [5120, 1280], W2 [1280, 5120] ----- #
    rows.update(k8_rows(card, gen, dev))

    # ---- K3 cross-KV projection + int8: xa [24, 1500, 1280], one audio row - #
    xa, layers = k3_inputs(gen, dev)
    k3 = k3_points(card, xa, layers)
    wk, wv, bv = layers[0]
    del layers
    k3_tp_points(card, xa, wk, wv, bv)
    outs = {}
    for entry, bits in (("K3", 8), ("K3-int4", 4)):
        err, tol, outs[bits] = k3_compare(xa, wk, wv, bv, bits=bits)
        err_row, tol_row, _ = k3_compare(xa[:1], wk, wv, bv, bits=bits)
        rows[entry] = dict(
            module=kv_quant, kernel=kv_quant.KERNEL4 if bits == 4 else kv_quant.KERNEL,
            err=max(err, err_row),
            tol=(f"{tol}; [1, {T_ENC}, {D}]: err {err_row:.3e}, {tol_row}, "
                 f"{k3[(entry, 1)]['ms']:.4f} ms a launch"),
            ms=k3[(entry, BATCH)]["ms"], plain_ms=k3[(entry, BATCH)]["plain"],
            library_ms=None, bound=k3_bound(BATCH, bits))
    ta_pad = kv_quant.pad_ta(T_ENC)
    kern = outs.pop(8)

    # ---- K4 decode-step cross-attention over K3's output ------------------ #
    kq, ks, vq, vs = kern
    bias = cross_decode.pad_bias(T_ENC, ta_pad, dev)
    rows["K4"], points = k4_row(card, randn, kern, bias, 8)

    # ---- K9 split-S flash decode on K3's output, one query row per head --- #
    q9 = randn(BATCH * H, DH)
    before = flash_decode.KERNEL.launches
    err, tol = k9_compare(q9, kq, ks, vq, vs, H, T_ENC)
    err_row, tol_row = k9_compare(q9[:H], *(t[:1].contiguous() for t in kern), H, T_ENC)
    k9 = k9_points(randn, kern)
    print_k9_points(card, k9)
    rows["K9"] = dict(
        module=flash_decode, err=max(err, err_row),
        tol=(f"{tol}; one audio row: {tol_row}; cold eager over K/V sets in turn, K4 "
             f"{rows['K4']['ms']:.4f} ms at G=1 the same way"),
        ms=k9[BATCH]["ms"],
        plain_ms=time_ms(lambda: flash_decode.flash_decode_cross_plain(
            q9, kq, ks, vq, vs, H, T_ENC), 5, 1),
        library_ms=None, bound=k9[BATCH]["bound"])
    k9_launches = flash_decode.KERNEL.launches - before

    # ---- K10 streamed cross decode on the same inputs: G = 5 and G = 1 ----- #
    rows["K10"] = k10_row(randn, kern, bias, 8, rows["K4"], points)
    del kern, kq, ks, vq, vs

    # ---- K4-int4 over K3-int4's output [24, 1536, 640] --------------------- #
    kern = outs.pop(4)
    rows["K4-int4"], points = k4_row(card, randn, kern, bias, 4)
    rows["K10-int4"] = k10_row(randn, kern, bias, 4, rows["K4-int4"], points)
    del kern, xa

    # ---- K5 int4-weight matmul: the decode loop's four weight shapes ------- #
    rows["K5"] = k5_rows(gen, dev)

    # ---- K6 DTW trace: ragged [4, 101, 1500], then [1, 448, 1500] ---------- #
    step_ns = k6_step_ns()
    print("K6 step latency: " + ", ".join(
        f"{'float64' if acc == torch.float64 else 'float32'} "
        f"{'across rows' if cross else 'along a row'} {ns:.3f} ns"
        for (acc, cross), ns in step_ns.items()) + f" [{card}]", flush=True)
    cases = []
    for lengths in (DTW_ROWS, (DTW_WORST,)):
        x = torch.randn((len(lengths), max(lengths), DTW_FRAMES), generator=gen, device=dev)
        cases.append((x, torch.tensor(lengths, dtype=torch.int32, device=dev)))
    worst = dtw_check(cases[1:], step_ns)
    rows["K6"] = dict(module=dtw, library_ms=None, **dtw_check(cases[:1], step_ns))
    rows["K6"]["err"] = max(rows["K6"]["err"], worst["err"])
    rows["K6"]["tol"] += (f"; [1, {DTW_WORST}, {DTW_FRAMES}] takes {worst['ms']:.4f} ms "
                          f"(float32 {worst['ms32']:.4f}; chain floor {worst['floor']:.4f} ms; "
                          f"{DTW_WORST + DTW_FRAMES - 1} steps, bitwise equal too)")
    print_k6(card, "[4, 101/87/64/33, 1500]", rows["K6"])
    print_k6(card, f"[1, {DTW_WORST}, {DTW_FRAMES}]", worst)
    del cases

    for name, r in rows.items():
        r.setdefault("kernel", r["module"].KERNEL)
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"{name} {r['kernel'].name}: max_abs_err={r['err']:.3e} "
              f"(tol {r['tol']}) kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"library_ms={lib} bound_ms={r['bound'][0]:.4f} ({r['bound'][1]}) "
              f"[{card}]", flush=True)
    torch.cuda.empty_cache()
    return rows, k9_launches


def print_k6(card: str, label: str, r: dict) -> None:
    print(f"K6 {label}: float64 {r['ms']:.4f} ms, float32 {r['ms32']:.4f} ms; chain floor "
          f"{r['floor']:.4f} ms (float64, {100 * r['floor'] / r['ms']:.1f}% of the kernel's "
          f"time); byte bound {r['bound'][0]:.4f} ms [{card}]", flush=True)


def k4_row(card: str, randn, kv, bias, bits: int):
    """K4 (or K4-int4) on K3's output kv at batch 24 and on its first audio
    row, held against the plain version at the prefill bucket (G = 4), a beam
    step (G = 5) and the greedy step (G = 1), and timed cold at K4_POINTS
    (`cross_decode_points`) beside K10 on the same bytes, the kernel before
    its redesign as recorded (K4_BEFORE) and the split of the positions it
    chose. The row's ms is the greedy step's at batch 24, eager over
    COLD_SETS sets. Returns the row and the points."""
    from whisper_at_tpu_torch.ops import cross_decode as cd

    name = "K4-int4" if bits == 4 else "K4"
    kernel, plain = ((cd.cross_attention_int4, cd.cross_attention_int4_plain) if bits == 4
                     else (cd.cross_attention_int8, cd.cross_attention_int8_plain))
    row = tuple(t[:1].contiguous() for t in kv)
    errs, tols = [], []
    for a, groups, args in [(BATCH, 4, kv), (BATCH, BEAM, kv), (1, BEAM, row), (1, 1, row),
                            (BATCH, 1, kv), (BATCH, SPEC_G, kv)]:
        qd = randn(a, H * groups, DH, scale=DH ** -0.5)
        e, tol = k4_compare(qd, *args, bias, H, bits)
        errs.append(e)
        tols.append(f"A={a} G={groups}: err {e:.3e} <= {tol}")
    points = cross_decode_points(randn, kv, bias, bits)
    ta_pad = kv[0].shape[1]
    slots = cd.wave_slots(kv[0].device.index)
    for (a, groups), p in points.items():
        n_split, per, tensor_cores, chunk = cd.plan(a, H, groups, ta_pad, bits, slots)
        print(f"{name} A={a} G={groups} cold: {p['k4']:.4f} ms eager over {p['sets']} K/V sets "
              f"used in turn, {p['k4_graph']:.4f} ms in a CUDA graph, host {p['k4_host']:.4f} "
              f"ms a call; K10 on the same bytes {p['k10']:.4f} ms eager "
              f"({p['k4'] / p['k10']:.3f}x), {p['k10_graph']:.4f} ms in a graph "
              f"({p['k4_graph'] / p['k10_graph']:.3f}x), host {p['k10_host']:.4f} ms; "
              f"{100 * p['bound'][0] / p['k4']:.1f}% of "
              f"the {p['bound'][0]:.4f} ms bound; {before_k4(bits, a, groups)}; "
              f"{'tensor' if tensor_cores else 'CUDA'} cores, "
              f"stages of {chunk}, {n_split} run(s) of {per} stage(s)"
              f"{f' (a cluster of {n_split})' if n_split > 1 else ''} [{card}]", flush=True)
    greedy = points[(BATCH, 1)]
    tols.append(f"cold, eager over {greedy['sets']} K/V sets (cycle_ms); in a CUDA graph "
                f"{greedy['k4_graph']:.4f} ms")
    return dict(module=cd, kernel=cd.KERNEL4 if bits == 4 else cd.KERNEL, err=max(errs),
                tol="; ".join(tols), ms=greedy["k4"],
                plain_ms=time_ms(lambda: plain(qd, *kv, bias, H), 5, 1), library_ms=None,
                bound=greedy["bound"]), points


def k10_row(randn, kv, bias, bits: int, k4_row: dict, points: dict) -> dict:
    """K10 (or K10-int4) on K3's output kv at a beam step (G = 5) and the
    greedy step (G = 1). Its ms is the greedy step's cold time, eager over
    COLD_SETS sets, from K4's points (`cross_decode_points`, the same bytes);
    the bound is K4's."""
    from whisper_at_tpu_torch.ops import cross_decode_stream as cs

    stream, plain, kernel = ((cs.cross_attention_stream4, cs.cross_attention_stream4_plain,
                              cs.KERNEL4) if bits == 4 else
                             (cs.cross_attention_stream, cs.cross_attention_stream_plain,
                              cs.KERNEL))
    errs, tols = [], []
    for groups in (BEAM, 1):
        qd = randn(BATCH, H * groups, DH, scale=DH ** -0.5)
        e, tol = k10_compare(qd, *kv, bias, H, bits)
        errs.append(e)
        tols.append(f"G={groups}: err {e:.3e} <= {tol}")
    ms = points[(BATCH, 1)]["k10"]
    k4 = f"K4{'-int4' if bits == 4 else ''}"
    tols.append(f"{k4} {k4_row['ms']:.4f} ms at G=1 cold, this kernel {ms / k4_row['ms']:.3f}x "
                f"it; eager over {points[(BATCH, 1)]['sets']} K/V sets (cycle_ms), in a CUDA "
                f"graph {points[(BATCH, 1)]['k10_graph']:.4f} ms; at G={BEAM} "
                f"{points[(BATCH, BEAM)]['k10']:.4f} ms, at A=1 {points[(1, 1)]['k10']:.4f} ms")
    return dict(module=cs, kernel=kernel, err=max(errs), tol="; ".join(tols), ms=ms,
                plain_ms=time_ms(lambda: plain(qd, *kv, bias, H), 5, 1),
                library_ms=None, bound=k4_row["bound"])


def synth_audio(seconds: int, seed: int) -> np.ndarray:
    """int16 PCM: a 220 Hz tone with noise, as the repository's bench makes it."""
    rng = np.random.default_rng(seed)
    t = np.arange(16000 * seconds) / 16000.0
    a = 0.3 * np.sin(2 * np.pi * 220.0 * t) + 0.05 * rng.standard_normal(len(t))
    return (np.clip(a, -1.0, 1.0) * 32767.0).astype(np.int16)


def kernels_of(names) -> list:
    """The registered kernel names of kernel ids (K1 .. K10 and the int4 /
    int8 entries)."""
    from whisper_at_tpu_torch.ops import (
        cross_decode,
        cross_decode_stream,
        dtw,
        enc_attention,
        enc_flash,
        enc_mlp,
        flash_decode,
        fused_mlp,
        kv_quant,
        probe_dma,
        w4_matmul,
    )

    kernels = {"K1": enc_attention.KERNEL, "K2": enc_mlp.KERNEL,
               "K2-partial": enc_mlp.KERNEL_PARTIAL, "K3": kv_quant.KERNEL,
               "K4": cross_decode.KERNEL, "K3-int4": kv_quant.KERNEL4,
               "K4-int4": cross_decode.KERNEL4, "K5": w4_matmul.KERNEL, "K6": dtw.KERNEL,
               "K7": enc_flash.KERNEL, "K8": fused_mlp.KERNEL, "K8-int8": fused_mlp.KERNEL_INT8,
               "K9": flash_decode.KERNEL, "K10": cross_decode_stream.KERNEL,
               "K10-int4": cross_decode_stream.KERNEL4, "P1": probe_dma.KERNEL_AUTO,
               "P2-cp": probe_dma.KERNEL_CP, "P2-tma": probe_dma.KERNEL_TMA}
    return [kernels[n].name for n in names]


HEADLINE_KERNELS = ("K1", "K2", "K3", "K4")
INT4_KERNELS = ("K1", "K2", "K3-int4", "K4-int4", "K5")
WORDS_KERNELS = HEADLINE_KERNELS + ("K6",)
SWITCHES_A_KERNELS = ("K7", "K2", "K3", "K8-int8", "K10")
SWITCHES_B_KERNELS = ("K7", "K2", "K3-int4", "K8", "K10-int4")


class Recorder:
    """Within `with Recorder():`, each kernel wrapper is replaced, at the
    place the path calls it, by one that keeps a copy of its inputs and then
    launches as before (the wrapper counts its launch once, as always):
    every call of K6, and the first call of each other kernel at each
    distinct set of shapes (K8: and weight type). `inputs[kernel id]` lists
    the argument tuples (K8's modules are kept, not copied)."""

    def __init__(self):
        from whisper_at_tpu_torch.models import decoder, encoder
        from whisper_at_tpu_torch.ops import dtw, w4_matmul

        self.sites = {"K1": (encoder, "enc_attention"), "K2": (encoder, "enc_mlp"),
                      "K2-partial": (encoder, "enc_mlp_partial"),
                      "K3": (decoder, "project_quantize_kv"),
                      "K4": (decoder, "cross_attention_int8"),
                      "K3-int4": (decoder, "project_quantize_kv4"),
                      "K4-int4": (decoder, "cross_attention_int4"),
                      "K5": (w4_matmul, "w4_matmul"), "K6": (dtw, "dtw_trace"),
                      "K7": (encoder, "enc_flash"), "K8": (decoder, "fused_mlp"),
                      "K10": (decoder, "cross_attention_stream"),
                      "K10-int4": (decoder, "cross_attention_stream4")}
        self.seen = {name: {} for name in self.sites}
        self.originals = {}

    @property
    def inputs(self) -> dict:
        return {name: list(seen.values()) for name, seen in self.seen.items()}

    def _wrap(self, name, fn):
        seen = self.seen[name]

        def recording(*args, **kwargs):
            key = len(seen) if name == "K6" else tuple(
                tuple(a.shape) if torch.is_tensor(a) else
                type(a).__name__ if isinstance(a, torch.nn.Module) else a for a in args)
            if key not in seen:
                seen[key] = tuple(a.detach().clone() if torch.is_tensor(a) else a
                                  for a in args)
            return fn(*args, **kwargs)
        return recording

    def __enter__(self):
        for name, (owner, attr) in self.sites.items():
            self.originals[name] = getattr(owner, attr)
            setattr(owner, attr, self._wrap(name, self.originals[name]))
        return self

    def __exit__(self, *exc):
        for name, (owner, attr) in self.sites.items():
            setattr(owner, attr, self.originals[name])


def hold_path_inputs(card: str, label: str, inputs: dict):
    """Every kernel against its plain version on the inputs a path gave it
    (K1-K5, K7, K8, K10 and the int4 entries at each shape, K6 on every
    call). Returns K6's `dtw_check` dict, or None when the path did not run
    K6."""
    for name, calls in inputs.items():
        if name == "K6" or not calls:
            continue
        for args in calls:
            err, tol = COMPARE[name](*args)
            shapes = [list(a.shape) for a in args if torch.is_tensor(a)][:2]
            entry = "K8-int8" if name == "K8" and hasattr(args[1], "w_q") else name
            print(f"{label}: {entry} on its input {shapes}: max_abs_err={err:.3e} "
                  f"(tol {tol}) [{card}]", flush=True)
    if not inputs["K6"]:
        return None
    k6 = dtw_check([(x, n) for x, n, *_ in inputs["K6"]], k6_step_ns())
    print(f"{label}: K6 on its {len(inputs['K6'])} inputs: max_abs_err={k6['err']:.1f} "
          f"({k6['tol']}), kernel_ms={k6['ms']:.4f} (float32 {k6['ms32']:.4f}) "
          f"plain_ms={k6['plain_ms']:.4f} bound_ms={k6['bound'][0]:.4f} (bytes), chain "
          f"floor {k6['floor']:.4f} ms, means per call [{card}]", flush=True)
    return k6


def run_counted(fn, kernel_ids, unused_ids=()):
    """fn() with every launch count set to 0 just before and read just
    after; fails when a kernel of the path was not launched, or when one of
    `unused_ids` was. Returns (result, seconds, counts)."""
    from whisper_at_tpu_torch.ops import cuda

    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = cuda.launch_counts()
    missing = [name for name in kernels_of(kernel_ids) if counts[name] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on this path: {missing}")
    stray = [name for name in kernels_of(unused_ids) if counts[name] != 0]
    if stray:
        raise AssertionError(f"kernels launched that this path must not use: {stray}")
    return result, seconds, counts


def check_segments(result, audio_len: int, words: bool) -> int:
    """Tags finite and written, segments ordered; with words, word times
    finite, ordered and inside their window, probabilities in [0, 1].
    Returns the number of words."""
    tags = np.asarray(result["audio_tag"])
    n_cells = -(-audio_len // (16000 * 10))
    if tags.shape != (n_cells, 527) or not np.isfinite(tags).all():
        raise AssertionError(f"audio_tag has shape {tags.shape} or non-finite values")
    if np.abs(tags).sum(axis=1).min() <= 0:
        raise AssertionError("a tag cell was never written")
    n_words = 0
    for seg in result["segments"]:
        if not 0 <= seg["start"] <= seg["end"]:
            raise AssertionError(f"segment times out of order: {seg}")
        if not np.isfinite(seg["avg_logprob"]):
            raise AssertionError(f"non-finite avg_logprob: {seg}")
        if not words:
            continue
        lo, hi = seg["seek"] / 100, seg["seek"] / 100 + 30
        times = [(w["start"], w["end"]) for w in seg["words"]]
        flat = [t for pair in times for t in pair]
        if not (np.isfinite(flat).all() and flat == sorted(flat)
                and all(lo <= t <= hi for t in flat)):
            raise AssertionError(f"word times not finite, ordered and in [{lo}, {hi}]: "
                                 f"{times}")
        if not all(0 <= w["probability"] <= 1 for w in seg["words"]):
            raise AssertionError(f"word probability outside [0, 1]: {seg['words']}")
        n_words += len(seg["words"])
    if words and n_words == 0:
        raise AssertionError("no segment carries words")
    return n_words


def transcribe_check(card: str, model) -> dict:
    """The headline call at large-v1 full width: a warm-up call whose kernel
    inputs are recorded and held against the plain versions, then the
    counted call. Returns its launch counts and throughput."""
    import whisper_at_tpu_torch as wat

    audio = synth_audio(BATCH * 30, SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with Recorder() as rec:  # warm-up: allocator, library handles
        wat.transcribe_batched(model, audio, **HEADLINE_OPTS)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    hold_path_inputs(card, "headline call", rec.inputs)
    del rec

    torch.cuda.reset_peak_memory_stats()
    result, seconds, counts = run_counted(
        lambda: wat.transcribe_batched(model, audio, **HEADLINE_OPTS), HEADLINE_KERNELS)
    peak = torch.cuda.max_memory_allocated()
    check_segments(result, len(audio), words=False)
    rate = len(audio) / 16000 / seconds
    print(f"transcribe_batched {SIZE} batch {BATCH}: {len(audio) / 16000:.0f} s audio "
          f"in {seconds:.3f} s = {rate:.2f} audio-s/s "
          f"(second call; the first took {warm_s:.3f} s), {len(result['segments'])} segments, "
          f"tags {np.asarray(result['audio_tag']).shape}, peak memory {peak / 2**30:.2f} GiB, "
          f"launches {counts} [{card}]", flush=True)
    return counts, rate


def int4_check(card: str, model) -> dict:
    """The headline call with every int4 option (`INT4_OPTS`): a warm-up
    call whose kernel inputs are recorded and held against the plain
    versions, then the counted call, which must launch K1, K2, K3-int4,
    K4-int4 and K5 and neither int8 entry of K3 or K4. Returns its launch
    counts and its throughput."""
    import whisper_at_tpu_torch as wat

    audio = synth_audio(BATCH * 30, SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with Recorder() as rec:
        wat.transcribe_batched(model, audio, **INT4_OPTS)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    hold_path_inputs(card, "int4 call", rec.inputs)
    del rec

    torch.cuda.reset_peak_memory_stats()
    result, seconds, counts = run_counted(
        lambda: wat.transcribe_batched(model, audio, **INT4_OPTS), INT4_KERNELS, ("K3", "K4"))
    peak = torch.cuda.max_memory_allocated()
    check_segments(result, len(audio), words=False)
    rate = len(audio) / 16000 / seconds
    print(f"transcribe_batched int4 (kv, weights, self cache) {SIZE} batch {BATCH}: "
          f"{len(audio) / 16000:.0f} s audio in {seconds:.3f} s = {rate:.2f} audio-s/s "
          f"(second call; the first took {warm_s:.3f} s), {len(result['segments'])} segments, "
          f"peak memory {peak / 2**30:.2f} GiB, launches {counts} [{card}]", flush=True)
    return counts, rate


def full_text_opts(model) -> dict:
    """The headline's options with timestamp tokens off and EOT suppressed,
    so every window decodes TOKENS text tokens, the length of real speech's
    windows (about 50-100). Random weights would otherwise end a window's
    text (or every beam) after a few tokens."""
    from whisper_at_tpu_torch.tokenizer import get_tokenizer

    tok = get_tokenizer(model.is_multilingual)
    suppress = [-1, tok.eot, *range(tok.timestamp_begin, model.dims.n_vocab)]
    return dict(HEADLINE_OPTS, without_timestamps=True, suppress_tokens=suppress)


def words_opts(model) -> dict:
    """The words call's options: full-length text (`full_text_opts`) with
    word timestamps, so the alignment runs on rows as long as speech's."""
    return dict(full_text_opts(model), word_timestamps=True)


def beam_check(card: str, model):
    """`transcribe_batched` with beam_size=5 and the headline's int8 options
    (the large-beam row) over the headline's audio, full-length text: a
    warm-up call whose kernel inputs are recorded and held against the
    plain versions (K4 at G = 5 among them), then the counted call. Returns
    its launch counts and throughput."""
    import whisper_at_tpu_torch as wat

    audio = synth_audio(BATCH * 30, SEED)
    opts = dict(full_text_opts(model), beam_size=BEAM)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with Recorder() as rec:
        wat.transcribe_batched(model, audio, **opts)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    k4_rows = sorted({args[0].shape[1] // H for args in rec.inputs["K4"]})
    if BEAM not in k4_rows:
        raise AssertionError(f"K4 never ran at G = {BEAM} in the beam call (G = {k4_rows})")
    hold_path_inputs(card, "beam call", rec.inputs)
    del rec

    torch.cuda.reset_peak_memory_stats()
    result, seconds, counts = run_counted(
        lambda: wat.transcribe_batched(model, audio, **opts), HEADLINE_KERNELS)
    peak = torch.cuda.max_memory_allocated()
    check_segments(result, len(audio), words=False)
    eot = opts["suppress_tokens"][1]
    n_text = [len([t for t in seg["tokens"] if t < eot]) for seg in result["segments"]]
    rate = len(audio) / 16000 / seconds
    print(f"transcribe_batched beam_size={BEAM} {SIZE} batch {BATCH} ({BATCH * BEAM} rows): "
          f"{len(audio) / 16000:.0f} s audio in {seconds:.3f} s = {rate:.2f} audio-s/s "
          f"(second call; the first took {warm_s:.3f} s), K4 at G = {k4_rows}, "
          f"{len(result['segments'])} segments of {min(n_text)}-{max(n_text)} tokens, "
          f"peak memory {peak / 2**30:.2f} GiB, launches {counts} [{card}]", flush=True)
    return counts, rate


def words_check(card: str, model):
    """`transcribe_batched` with word timestamps over the headline's audio
    (`words_opts`; default alignment mask: every head of the last half of
    the layers): a warm-up call whose kernel inputs are recorded and held
    against the plain versions, then the counted call (the greedy decode
    makes its inputs the same). Returns the launch counts and K6's
    `dtw_check` dict on the recorded inputs."""
    import whisper_at_tpu_torch as wat

    audio = synth_audio(BATCH * 30, SEED)
    opts = words_opts(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with Recorder() as rec:
        wat.transcribe_batched(model, audio, **opts)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    k6 = hold_path_inputs(card, "words call", rec.inputs)
    del rec

    torch.cuda.reset_peak_memory_stats()
    result, seconds, counts = run_counted(
        lambda: wat.transcribe_batched(model, audio, **opts), WORDS_KERNELS)
    peak = torch.cuda.max_memory_allocated()
    n_words = check_segments(result, len(audio), words=True)
    eot = opts["suppress_tokens"][1]
    n_text = [len([t for t in seg["tokens"] if t < eot]) for seg in result["segments"]]
    print(f"transcribe_batched word_timestamps {SIZE} batch {BATCH}, "
          f"{int(model.alignment_heads.sum())} alignment heads: {len(audio) / 16000:.0f} s "
          f"audio in {seconds:.3f} s = {len(audio) / 16000 / seconds:.2f} audio-s/s (second "
          f"call; the first took {warm_s:.3f} s), {len(result['segments'])} segments of "
          f"{min(n_text)}-{max(n_text)} tokens, {n_words} words, peak memory "
          f"{peak / 2**30:.2f} GiB, launches {counts} [{card}]", flush=True)
    return counts, k6


def sequential_check(card: str, model) -> dict:
    """The sequential transcribe with word timestamps over 60 s, the mask
    set from the port's copy of large-v1's alignment heads. There is one
    call; its kernel inputs are recorded in it (copies of a few MB) and
    held against the plain versions after it."""
    import whisper_at_tpu_torch as wat
    from whisper_at_tpu_torch.registry import _ALIGNMENT_HEADS

    audio = synth_audio(SEQUENTIAL_S, SEED)
    default_heads = model.alignment_heads
    model.set_alignment_heads(_ALIGNMENT_HEADS[SIZE])
    n_heads = int(model.alignment_heads.sum())
    try:
        with Recorder() as rec:
            result, seconds, counts = run_counted(
                lambda: wat.transcribe(model, audio, **SEQUENTIAL_OPTS), WORDS_KERNELS)
    finally:
        model.alignment_heads = default_heads
    n_words = check_segments(result, len(audio), words=True)
    # the gate is off, so every decoded window leaves at least one segment
    windows = len({seg["seek"] for seg in result["segments"]})
    print(f"transcribe (sequential) word_timestamps {SIZE}, {n_heads} alignment heads "
          f"(registry): {len(audio) / 16000:.0f} s audio in {seconds:.3f} s "
          f"(one call, cold for the seek loop's shapes), {windows} windows decoded, "
          f"{len(result['segments'])} segments, {n_words} words, launches {counts} [{card}]",
          flush=True)
    hold_path_inputs(card, "sequential call", rec.inputs)
    return counts


@contextlib.contextmanager
def decoded_rows():
    """The rows each `DecodingTask.run` of the block decoded (a list, filled
    as the block runs): exactly the windows of each batch."""
    from whisper_at_tpu_torch.decoding import DecodingTask

    rows, run = [], DecodingTask.run

    def counting(self, mel):
        rows.append(mel.shape[0])
        return run(self, mel)

    DecodingTask.run = counting
    try:
        yield rows
    finally:
        DecodingTask.run = run


def wav_body(pcm: np.ndarray) -> bytes:
    """16-bit mono 16 kHz WAV bytes of int16 PCM."""
    import io
    import wave

    buf = io.BytesIO()
    with wave.open(buf, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(16000)
        wf.writeframes(pcm.tobytes())
    return buf.getvalue()


def percentiles(xs) -> tuple:
    xs = sorted(xs)
    return xs[len(xs) // 2], xs[min(len(xs) - 1, int(len(xs) * 0.95))]


def serving_check(card: str, model, headline_rate: float) -> dict:
    """(10) The serving path: 3 x BATCH files of 8-25 s, every other one
    prefetched to the card (`prefetch_audio_many`, the rest as int16 arrays
    the service's prep pool prefetches), submitted together to one
    `TranscriptionService`, which must form three batches of BATCH
    one-window files; each result token for token against one direct
    `transcribe_many` over the same inputs (the same batches reach the same
    kernels). Then the HTTP front end on 127.0.0.1: two files POSTed as WAV,
    each response's JSON equal to the in-process result, and /healthz.
    Returns the launch counts."""
    import json as _json
    import threading
    import urllib.request

    import whisper_at_tpu_torch as wat
    from whisper_at_tpu_torch.serving import TranscriptionService, _jsonable, make_http_server
    from whisper_at_tpu_torch.transcribe import _serve_prof, transcribe_many

    rng = np.random.default_rng(SEED)
    seconds = [int(d) for d in rng.integers(*SERVE_SECONDS, size=3 * BATCH)]
    audios = [synth_audio(d, SEED + 1 + i) for i, d in enumerate(seconds)]
    opts = {k: v for k, v in HEADLINE_OPTS.items() if k != "max_batch"}
    audio_s = sum(seconds)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    direct = transcribe_many(model, audios, max_batch=BATCH, **opts)
    torch.cuda.synchronize()
    direct_s = time.perf_counter() - t0

    _serve_prof.snapshot()
    inputs = list(audios)
    inputs[::2] = wat.prefetch_audio_many(audios[::2])
    if not all(isinstance(a, wat.PrefetchedAudio) and a.device.type == "cuda"
               for a in inputs[::2]):
        raise AssertionError("prefetch_audio_many did not give PrefetchedAudio on the card")
    with TranscriptionService(model, max_batch=BATCH, max_wait_s=SERVE_FILL_S,
                              **opts) as svc, decoded_rows() as rows:
        def serve():
            futures = [svc.submit(a) for a in inputs]
            return [f.result(timeout=600) for f in futures]

        results, wall, counts = run_counted(serve, HEADLINE_KERNELS)
        stats = svc.stats()
    prof = _serve_prof.snapshot()
    if (stats["batches"], stats["max_batch_windows"], stats["failed"],
            stats["completed"]) != (3, BATCH, 0, 3 * BATCH):
        raise AssertionError(f"the service did not form three full batches: {stats}")
    for i, (got, want) in enumerate(zip(results, direct)):
        if [s["tokens"] for s in got["segments"]] != [s["tokens"] for s in want["segments"]] \
                or got["text"] != want["text"]:
            raise AssertionError(f"file {i}: the service's tokens differ from transcribe_many's")
        check_segments(got, len(audios[i]), words=False)
    p50, p95 = stats["latency_p50_s"], stats["latency_p95_s"]
    rate = audio_s / wall
    print(f"serving {SIZE}: {len(audios)} files of {min(seconds)}-{max(seconds)} s "
          f"({audio_s} s audio, half prefetched) in {wall:.3f} s = {rate:.2f} audio-s/s "
          f"({rate / headline_rate:.3f}x the headline's {headline_rate:.2f} in this process), "
          f"{stats['windows'] / wall:.2f} windows/s, {stats['batches']} batches of "
          f"{stats['max_batch_windows']} windows, decoded rows {sum(rows)} for "
          f"{stats['windows']} windows, request latency p50 {p50:.3f} s p95 {p95:.3f} s; "
          f"direct transcribe_many {direct_s:.3f} s; token-exact against it; launches "
          f"{counts} [{card}]", flush=True)
    print(f"serving stages (WHISPER_AT_TPU_SERVE_PROF): {_json.dumps(prof)} [{card}]",
          flush=True)

    with TranscriptionService(model, max_batch=BATCH, max_wait_s=0.05, **opts) as svc:
        server = make_http_server(svc, "127.0.0.1", 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            for pcm in audios[:SERVE_HTTP_FILES]:
                req = urllib.request.Request(base + "/v1/transcribe", data=wav_body(pcm),
                                             headers={"Content-Type": "audio/wav"})
                body = urllib.request.urlopen(req, timeout=600).read()
                want = _json.dumps(_jsonable(transcribe_many(model, [pcm], **opts)[0]))
                if _json.dumps(_json.loads(body)) != want:
                    raise AssertionError("the HTTP response differs from the in-process result")
            health = _json.loads(urllib.request.urlopen(base + "/healthz", timeout=60).read())
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=60)
    if health["status"] != "ok" or health["completed"] != SERVE_HTTP_FILES:
        raise AssertionError(f"/healthz: {health}")
    print(f"serving HTTP: {SERVE_HTTP_FILES} WAV POSTs on 127.0.0.1, each JSON equal to the "
          f"in-process transcribe_many; /healthz {health['completed']} completed, latency "
          f"p50 {health['latency_p50_s']:.3f} s [{card}]", flush=True)
    return counts


def streaming_check(card: str, model, headline_rate: float) -> dict:
    """(11) STREAM_SESSIONS sessions of one `StreamingService`, each fed
    STREAM_SECONDS s of int16 in 250 ms blocks from its own thread as fast
    as it goes, one with word timestamps (K6 runs in its thread while the
    scheduler decodes). Every session ends with transcribe()'s dict, ordered
    segments inside the audio and finite tags; no window fails. Returns the
    launch counts."""
    import json as _json
    import threading

    from whisper_at_tpu_torch.streaming import StreamingService, prof_snapshot

    opts = {k: v for k, v in HEADLINE_OPTS.items() if k != "max_batch"}
    waves = [synth_audio(STREAM_SECONDS, SEED + 100 + i) for i in range(STREAM_SESSIONS)]
    prof_snapshot()
    lats, results, errors = [], [None] * STREAM_SESSIONS, []
    with StreamingService(model, max_batch=BATCH, max_wait_s=STREAM_WAIT_S) as service:
        sessions = [service.open(word_timestamps=(i == 0), **opts)
                    for i in range(STREAM_SESSIONS)]

        def drive(i):
            sess, wave = sessions[i], waves[i]
            try:
                for lo in range(0, len(wave), STREAM_BLOCK):
                    before = sess._seek
                    t0 = time.perf_counter()
                    sess.feed(wave[lo:lo + STREAM_BLOCK])
                    if sess._seek > before:
                        lats.append(time.perf_counter() - t0)
                results[i] = sess.finish()
            except Exception as exc:  # noqa: BLE001 - raised below, in the main thread
                errors.append(exc)

        def drive_all():
            threads = [threading.Thread(target=drive, args=(i,)) for i in range(STREAM_SESSIONS)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=900)
            if any(th.is_alive() for th in threads):
                raise AssertionError("a streaming session did not finish")

        _, wall, counts = run_counted(drive_all, WORDS_KERNELS)
        stats = service.stats()
    prof = prof_snapshot()
    if errors:
        raise errors[0]
    for i, result in enumerate(results):
        if set(result) != {"text", "segments", "language", "at_time_res", "audio_tag"}:
            raise AssertionError(f"session {i}: not transcribe()'s dict: {sorted(result)}")
        check_segments(result, len(waves[i]), words=(i == 0))
        seeks = [seg["seek"] for seg in result["segments"]]
        if seeks != sorted(seeks) or any(s >= len(waves[i]) // 160 for s in seeks):
            raise AssertionError(f"session {i}: segments out of order or past the audio")
    if stats["max_batch_windows"] <= 1 or stats["windows"] < STREAM_SESSIONS * 3:
        raise AssertionError(f"the service never batched windows: {stats}")
    p50, p95 = percentiles(lats)
    rate = STREAM_SESSIONS * STREAM_SECONDS / wall
    print(f"streaming {SIZE}: {STREAM_SESSIONS} sessions x {STREAM_SECONDS} s in 250 ms blocks "
          f"(one with word timestamps) in {wall:.3f} s = {rate:.2f} audio-s/s "
          f"({rate / headline_rate:.3f}x the headline's {headline_rate:.2f} in this process), "
          f"{stats['windows']} windows in {stats['batches']} batches (largest "
          f"{stats['max_batch_windows']}), mel_batched_windows {stats['mel_batched_windows']}, "
          f"window-finalize latency p50 {p50:.3f} s p95 {p95:.3f} s over {len(lats)} windows, "
          f"launches {counts} [{card}]", flush=True)
    print(f"streaming stages (WHISPER_AT_TPU_STREAM_PROF): {_json.dumps(prof)} [{card}]",
          flush=True)
    return counts


# ---- (12) the training path ------------------------------------------------ #
# recipes/run_as_full_train.sh on 96 synthetic 10 s clips: all-layer features
# at n_frames 1000 (T = 500 encoder positions), then TL-TR lw_tr_1_8 at its
# lr, batch, mixup, time masks, label smoothing and balanced sampling
TRAIN_CLIPS = 96
TRAIN_CLIP_S = 10
EXTRACT_FRAMES = 1000
EXTRACT_BATCH = 24
TRAIN_MODE = "lw_tr_1_8"
TRAIN_BATCH = 48
TRAIN_EPOCHS = 2
TRAIN_RECIPE = dict(freqm=0, timem=10, mixup=0.5, label_smooth=0.1)
TRAIN_LR = 5e-5
TRAIN_STEP_ITERS = 10
N_CLASSES = 527


def write_label_csv(root: str) -> str:
    """A 527-row `index,mid,display_name` csv in `root`: made-up mids /m/{i}
    (the repository holds no AudioSet csv) and the English display names of
    the JAX package's asset, read by path. Returns its path."""
    import csv

    assets = os.path.join(os.path.dirname(os.path.abspath(__file__)), "whisper_at_tpu",
                          "assets", "label_name_dict.json")
    with open(assets, encoding="utf8") as f:
        names = json.load(f)["en"]
    label_csv = os.path.join(root, "class_labels_indices.csv")
    with open(label_csv, "w", newline="", encoding="utf8") as f:
        writer = csv.writer(f)
        writer.writerow(["index", "mid", "display_name"])
        for i, name in enumerate(names[:N_CLASSES]):
            writer.writerow([i, f"/m/{i}", name])
    return label_csv


def write_training_set(root: str) -> tuple:
    """TRAIN_CLIPS int16 WAVs of TRAIN_CLIP_S s (`synth_audio`, seeds 0 ..
    TRAIN_CLIPS - 1), a 527-row label CSV (display names from the JAX
    package's asset, read by path; mids /m/{i}) and a data JSON with 1-3
    labels a clip from default_rng(0). Returns (data json, label csv)."""
    label_csv = write_label_csv(root)
    rng = np.random.default_rng(0)
    data = []
    for i in range(TRAIN_CLIPS):
        path = os.path.join(root, f"clip{i:03d}.wav")
        with open(path, "wb") as f:
            f.write(wav_body(synth_audio(TRAIN_CLIP_S, i)))
        labels = rng.choice(N_CLASSES, size=int(rng.integers(1, 4)), replace=False)
        data.append({"wav": path, "labels": ",".join(f"/m/{k}" for k in labels)})
    data_json = os.path.join(root, "data.json")
    with open(data_json, "w") as f:
        json.dump({"data": data}, f)
    return data_json, label_csv


@contextlib.contextmanager
def extraction_timers():
    """Device time of each `extract_features_many` call (mel, encoder and
    pooling; CUDA events around it, no synchronisation added), host wall
    time of each chunk's file writing (`_save_chunk`) and the summed time of
    its `np.savez_compressed` calls (on WRITE_THREADS threads), while the
    block runs."""
    from whisper_at_tpu_torch.research import feature_extract as fx

    events, write_s, savez_s = [], [], []
    many, save_chunk, savez = fx.extract_features_many, fx._save_chunk, np.savez_compressed

    def timed_many(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = many(*args, **kwargs)
        end.record()
        events.append((start, end))
        return out

    def timed(fn, spent):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            fn(*args, **kwargs)
            spent.append(time.perf_counter() - t0)
        return run

    fx.extract_features_many, fx._save_chunk = timed_many, timed(save_chunk, write_s)
    np.savez_compressed = timed(savez, savez_s)
    times = {}
    try:
        yield times
    finally:
        fx.extract_features_many, fx._save_chunk, np.savez_compressed = many, save_chunk, savez
        torch.cuda.synchronize()
        times["encoder_s"] = sum(s.elapsed_time(e) for s, e in events) / 1e3
        times["write_s"], times["savez_s"] = sum(write_s), sum(savez_s)
        times["chunks"] = len(events)


def extraction_kernel_points(card: str, inputs: dict) -> None:
    """K1 and K2 timed at each shape the extraction gave them, beside their
    plain versions, SDPA (K1) or the unfused chain (K2), and the bound."""
    from whisper_at_tpu_torch.ops import enc_attention, enc_mlp

    sdpa = torch.nn.functional.scaled_dot_product_attention
    for q, k, v, n_head in inputs["K1"]:
        b, t, d = q.shape
        dh = d // n_head
        qh, kh, vh = (x.view(b, t, n_head, dh).transpose(1, 2) for x in (q, k, v))
        lim = bound(4.0 * b * n_head * t * t * dh, 4.0 * b * t * d * 2, PEAK_BF16_FLOPS)
        ms = time_ms(lambda: enc_attention.enc_attention(q, k, v, n_head), 10)
        print(f"extraction K1 {[b, t, d]}: kernel {ms:.4f} ms, plain "
              f"{time_ms(lambda: enc_attention.enc_attention_plain(q, k, v, n_head), 3, 1):.4f}"
              f" ms, SDPA {time_ms(lambda: sdpa(qh, kh, vh), 10):.4f} ms, bound {lim[0]:.4f} ms "
              f"({lim[1]}), {100 * lim[0] / ms:.1f}% of it [{card}]", flush=True)
    for args in inputs["K2"]:
        m = args[0].numel() // args[0].shape[-1]
        lim = k2_bound(m)
        ms = time_ms(lambda: enc_mlp.enc_mlp(*args), 10)
        print(f"extraction K2 {list(args[0].shape)}: kernel {ms:.4f} ms, plain "
              f"{time_ms(lambda: enc_mlp.enc_mlp_plain(*args), 3, 1):.4f} ms, unfused chain "
              f"{time_ms(lambda: k2_chain(*args), 10):.4f} ms, bound {lim[0]:.4f} ms "
              f"({lim[1]}), {100 * lim[0] / ms:.1f}% of it [{card}]", flush=True)


def extraction_check(card: str, model, data_json: str, feat_dir: str) -> dict:
    """(12a) `extract_feature_set` over the clips in chunks of EXTRACT_BATCH,
    bf16: every clip's file [32, 25, 1280]; K1 and K2 launched once a layer
    a chunk, K3 / K4 never; each distinct K1 / K2 input held against its
    plain version and timed; two clips against the same clips through the
    plain attention and MLP (each layer within K2's check tolerance:
    1e-3 + 2^-6 max |ref|); a second call writes nothing."""
    from whisper_at_tpu_torch.research import feature_extract as fx

    n_layer = model.dims.n_audio_layer
    with Recorder() as rec, extraction_timers() as times:
        written, wall, counts = run_counted(
            lambda: fx.extract_feature_set(model, data_json, feat_dir, n_frames=EXTRACT_FRAMES,
                                           batch_size=EXTRACT_BATCH, fp16=True),
            ("K1", "K2"), ("K3", "K4"))
    n_chunks = -(-TRAIN_CLIPS // EXTRACT_BATCH)
    k1, k2 = kernels_of(("K1", "K2"))
    if counts[k1] != n_chunks * n_layer or counts[k2] != n_chunks * n_layer:
        raise AssertionError(f"extraction launched K1 {counts[k1]} and K2 {counts[k2]} times, "
                             f"not {n_chunks * n_layer}")
    if len(written) != TRAIN_CLIPS:
        raise AssertionError(f"{len(written)} feature files written, not {TRAIN_CLIPS}")
    feats = []
    for path in written:
        with np.load(path) as f:
            feat = f["arr_0"]
        if feat.shape != (n_layer, EXTRACT_FRAMES // 40, D) or feat.dtype != np.float32 \
                or not np.isfinite(feat).all():
            raise AssertionError(f"{path}: {feat.shape} {feat.dtype}, or not finite")
        if len(feats) < 2:
            feats.append(feat)
    hold_path_inputs(card, "extraction", rec.inputs)
    extraction_kernel_points(card, rec.inputs)
    del rec

    # the first two clips through the plain attention and MLP
    from whisper_at_tpu_torch.audio import load_audio_pcm16

    with open(data_json) as f:
        wavs = [e["wav"] for e in json.load(f)["data"][:2]]
    saved = {k: os.environ.get(k) for k in ("WHISPER_AT_TPU_ENC_ATTN", "WHISPER_AT_TPU_ENC_MLP")}
    os.environ.update(WHISPER_AT_TPU_ENC_ATTN="xla", WHISPER_AT_TPU_ENC_MLP="xla")
    try:
        ref = fx.extract_features_many(model, [load_audio_pcm16(w) for w in wavs],
                                       EXTRACT_FRAMES, fp16=True).cpu().numpy()
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    worst = 0.0
    for feat, r in zip(feats, ref):
        for layer in range(n_layer):
            err = float(np.abs(feat[layer] - r[layer]).max())
            tol = 1e-3 + 2 ** -6 * float(np.abs(r[layer]).max())
            worst = max(worst, err / tol)
    if not worst <= 1.0:
        raise AssertionError(f"extracted features differ from the plain path's by {worst:.3f}x "
                             "K2's tolerance")
    again = fx.extract_feature_set(model, data_json, feat_dir, n_frames=EXTRACT_FRAMES,
                                   batch_size=EXTRACT_BATCH, fp16=True)
    if again:
        raise AssertionError(f"the second call wrote {len(again)} files")
    audio_s = TRAIN_CLIPS * TRAIN_CLIP_S
    print(f"extraction {SIZE} ({TRAIN_CLIPS} clips of {TRAIN_CLIP_S} s, n_frames "
          f"{EXTRACT_FRAMES}, chunks of {EXTRACT_BATCH}, bf16): {wall:.3f} s = "
          f"{audio_s / wall:.2f} audio-s/s, {TRAIN_CLIPS / wall:.2f} clips/s; encoder (mel, "
          f"encoder, pooling; device time) {times['encoder_s']:.3f} s over {times['chunks']} "
          f"chunks, writing {times['write_s']:.3f} s (host wall; np.savez_compressed "
          f"{times['savez_s']:.3f} s summed over {fx.WRITE_THREADS} threads); launches K1 "
          f"{counts[k1]}, K2 {counts[k2]}; two clips against the plain attention and MLP at "
          f"{worst:.3f} of K2's tolerance a layer; second call wrote 0 files [{card}]",
          flush=True)
    return counts


def step_times(head, batch, mode: str) -> dict:
    """One step from the same parameters in fp32 and in bf16 on one batch
    (losses), then TRAIN_STEP_ITERS bf16 steps, each synchronised: ms per
    step (the median after the first)."""
    import copy

    from whisper_at_tpu_torch import train as T

    feats, labels = (torch.from_numpy(x).cuda() for x in batch)
    losses = {}
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        model = copy.deepcopy(head)
        step = T.make_train_step(mode, T.make_optimizer(model.parameters(), TRAIN_LR),
                                 compute_dtype=dtype)
        losses[name] = float(step(model, feats, labels))
    ms = []
    for _ in range(TRAIN_STEP_ITERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(model, feats, labels)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return dict(losses=losses, ms=float(np.median(ms[1:])), first_ms=ms[0])


def training_check(card: str, model) -> None:
    """(12) The training path at large-v1 full width, in a temporary
    directory removed at the end: the clips and their labels
    (`write_training_set`), extraction (`extraction_check`), then TL-TR
    `lw_tr_1_8` at the recipe's settings for TRAIN_EPOCHS epochs (a dataset
    name other than as-full, so every batch runs), validated each epoch
    over the clips; `wa_model` over both epochs, validated; a fresh head
    resumed for epoch 3. Every loss, mAP and AUC finite; no feature file
    fell back to zeros; one step from the same parameters in fp32 and in
    bf16 agree to 2e-2 relative."""
    import tempfile

    from whisper_at_tpu_torch import train as T
    from whisper_at_tpu_torch.ops import flops
    from whisper_at_tpu_torch.train.loop import load_tltr

    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as root:
        data_json, label_csv = write_training_set(root)
        # FeatureDataset reads .npz only from a directory named like this
        feat_dir = os.path.join(root, "feat_as_smoke")
        extraction_check(card, model, data_json, feat_dir)

        conf = dict(TRAIN_RECIPE, dataset="smoke", tar_path=feat_dir)
        val_conf = dict(freqm=0, timem=0, mixup=0, dataset="smoke", tar_path=feat_dir)
        train_set = T.FeatureDataset(data_json, conf, label_csv)
        val_set = T.FeatureDataset(data_json, val_conf, label_csv)
        weights = T.balanced_sample_weights(data_json, label_csv)

        def loaders():
            return (T.DataLoader(train_set, TRAIN_BATCH, sampler_weights=weights, num_workers=8,
                                 seed=SEED),
                    T.DataLoader(val_set, TRAIN_BATCH, shuffle=False, num_workers=8))

        n_layer, rep_dim = T.tltr_shape_for(f"whisper-{SIZE}")
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)
        head = T.init_tltr(gen, N_CLASSES, n_layer, rep_dim, TRAIN_MODE)
        start_head = {k: v.clone() for k, v in head.state_dict().items()}
        exp = os.path.join(root, "exp")
        report = {}
        t0 = time.perf_counter()
        T.train(head, TRAIN_MODE, *loaders(), exp_dir=exp, lr=TRAIN_LR, n_epochs=TRAIN_EPOCHS,
                dataset="smoke", n_print_steps=1, report=report)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        result = np.loadtxt(os.path.join(exp, "result.csv"), delimiter=",")
        if sorted(report) != list(range(1, TRAIN_EPOCHS + 1)) or not np.isfinite(result).all() \
                or not all(np.isfinite([r["loss"], r["valid_loss"], r["mAP"], r["mAUC"]]).all()
                           for r in report.values()):
            raise AssertionError(f"training: a loss, mAP or AUC is not finite: {report}")

        averaged = T.wa_model(exp, 1, TRAIN_EPOCHS)
        t0 = time.perf_counter()
        wa_stats, _ = T.validate(T.make_eval_step(TRAIN_MODE), load_tltr(averaged, TRAIN_MODE),
                                 loaders()[1])
        wa_valid_s = time.perf_counter() - t0
        wa_map, wa_auc = T.mean_average_precision(wa_stats), T.mean_auc(wa_stats)
        if not np.isfinite([wa_map, wa_auc]).all():
            raise AssertionError(f"averaged head: mAP {wa_map}, AUC {wa_auc}")

        gen.manual_seed(SEED + 1)
        fresh = T.init_tltr(gen, N_CLASSES, n_layer, rep_dim, TRAIN_MODE)
        resumed = {}
        T.train(fresh, TRAIN_MODE, *loaders(), exp_dir=exp, lr=TRAIN_LR,
                n_epochs=TRAIN_EPOCHS + 1, dataset="smoke", n_print_steps=1, resume=True,
                report=resumed)
        after = np.loadtxt(os.path.join(exp, "result.csv"), delimiter=",")
        if sorted(resumed) != [TRAIN_EPOCHS + 1] or not np.array_equal(
                after[:TRAIN_EPOCHS], result) or not np.isfinite(after).all() \
                or after[TRAIN_EPOCHS, 3] != TRAIN_LR:
            raise AssertionError(f"resume: epochs run {sorted(resumed)}, result.csv {after}")
        if train_set.missing or val_set.missing:
            raise AssertionError(f"{train_set.missing} train and {val_set.missing} validation "
                                 "items fell back to zeros")

        head.load_state_dict(start_head)
        batch = next(iter(loaders()[0]))
        steps = step_times(head, batch, TRAIN_MODE)
        loss32, loss16 = steps["losses"]["fp32"], steps["losses"]["bf16"]
        if not abs(loss16 - loss32) <= 2e-2 * abs(loss32):
            raise AssertionError(f"one step: bf16 loss {loss16} against fp32 {loss32}")
    peak = torch.cuda.max_memory_allocated()
    step_bound_ms = (flops.tltr_flops(TRAIN_MODE, model.dims.n_audio_layer, D) * 2 * 3
                     * TRAIN_BATCH / PEAK_BF16_FLOPS * 1e3)
    last = report[TRAIN_EPOCHS]
    print(f"training {TRAIN_MODE} on [{model.dims.n_audio_layer}, 25, {D}] features, batch "
          f"{TRAIN_BATCH}, bf16: {TRAIN_EPOCHS} epochs of {TRAIN_CLIPS // TRAIN_BATCH} steps with "
          f"validation in {train_s:.3f} s; result.csv {result.tolist()}; step "
          f"{steps['ms']:.3f} ms (median of {TRAIN_STEP_ITERS - 1} after a first of "
          f"{steps['first_ms']:.3f}) = {TRAIN_BATCH / steps['ms'] * 1e3:.1f} samples/s, "
          f"{100 * step_bound_ms / steps['ms']:.1f}% of its {step_bound_ms:.3f} ms bound "
          f"(tltr_flops x 2 x 3 x {TRAIN_BATCH} at 989 TFLOP/s); loader per sample: data "
          f"{last['per_sample_data_s'] * 1e3:.3f} ms, DNN {last['per_sample_dnn_s'] * 1e3:.3f} "
          f"ms (epoch {TRAIN_EPOCHS}); validation {last['valid_s']:.3f} s, averaged head's "
          f"{wa_valid_s:.3f} s (mAP {wa_map:.4f}, AUC {wa_auc:.4f}); one step fp32 loss "
          f"{loss32:.6f}, bf16 {loss16:.6f}; resumed epoch {TRAIN_EPOCHS + 1}: mAP "
          f"{after[TRAIN_EPOCHS, 1]:.4f}; peak device memory {peak / 2**30:.2f} GiB [{card}]",
          flush=True)


# the command-line phase: one 60 s file sequential with words, three files
# batched, the CLI's defaults otherwise (beam 5 at T = 0)
CLI_SEQUENTIAL_S = 60
CLI_BATCHED_S = (20, 45, 70)
CLI_FLAGS = ["--language", "en", "--temperature_increment_on_fallback", "None", "-f", "all",
             "--verbose", "False"]
CLI_KERNELS = ("K1", "K2")
# the speculative phase: the headline's windows with full-length text and the
# headline's options but the int8 self cache, which the draft rules refuse
SPEC_NOISE_AT = (1, 40, 80)  # verify-pass positions at which the rounding noise is measured


def check_cli_outputs(out_dir: str, path: str, seconds: float, words: bool) -> dict:
    """The five files the command line wrote for one audio: the text, the
    subtitles' cues and the tsv parse, and their times agree with the json;
    every segment and word time lies in the 30 s window it was decoded from,
    and that window starts inside the audio; the json carries the tags.
    Returns counts for the printout."""
    import re

    stem = os.path.splitext(os.path.basename(path))[0]
    read = {ext: open(os.path.join(out_dir, f"{stem}.{ext}"), encoding="utf-8").read()
            for ext in ("txt", "vtt", "srt", "tsv", "json")}
    result = json.loads(read["json"])
    segs = result["segments"]
    tags = np.asarray(result["audio_tag"], dtype=np.float32)
    if tags.shape != (-(-int(seconds) // 10), 527) or not np.isfinite(tags).all():
        raise AssertionError(f"{stem}.json: audio_tag {tags.shape} not finite or not "
                             f"[{-(-int(seconds) // 10)}, 527]")
    if read["txt"] != "".join(s["text"].strip() + "\n" for s in segs):
        raise AssertionError(f"{stem}.txt is not the segments' text")
    tsv = read["tsv"].splitlines()
    if tsv[0] != "start\tend\ttext" or len(tsv) != len(segs) + 1 or any(
            [int(a), int(b)] != [round(1000 * s["start"]), round(1000 * s["end"])]
            for (a, b, *_), s in zip((ln.split("\t") for ln in tsv[1:]), segs)):
        raise AssertionError(f"{stem}.tsv does not hold the segments' times")
    stamp = r"(\d\d:)?\d\d:\d\d[.,]\d\d\d"
    vtt_cues = re.findall(rf"^{stamp} --> {stamp}$", read["vtt"], re.M)
    srt_cues = re.findall(rf"^\d+\n{stamp} --> {stamp}$", read["srt"], re.M)
    if not read["vtt"].startswith("WEBVTT\n") or len(vtt_cues) != len(srt_cues):
        raise AssertionError(f"{stem}.vtt / .srt do not parse as the same cues")
    times, past_end = [], 0
    for seg in segs:
        lo = seg["seek"] / 100
        if not lo < seconds:
            raise AssertionError(f"{stem}: a window starts at {lo} s, past the audio")
        seg_times = [seg["start"], seg["end"]] + [t for w in seg.get("words", [])
                                                  for t in (w["start"], w["end"])]
        if not all(lo <= t <= lo + 30 for t in seg_times) or seg["start"] > seg["end"]:
            raise AssertionError(f"{stem}: times {seg_times} outside their window "
                                 f"[{lo}, {lo + 30}]")
        past_end += sum(t > seconds for t in seg_times)
        times += seg_times
    n_words = sum(len(s.get("words", [])) for s in segs)
    if words and (n_words == 0 or "<u>" not in read["srt"]):
        raise AssertionError(f"{stem}: no words, or no highlighted cue")
    return dict(segments=len(segs), words=n_words, cues=len(srt_cues), past_end=past_end)


def cli_check(card: str, model) -> None:
    """(13) The command line at large-v1 full width, in a temporary
    directory: the random model saved as a reference checkpoint (.pt, bf16),
    then the port's `cli([...])` in this process, each call counted
    (`run_counted`) with its kernel inputs recorded and held against the
    plain versions: sequential over one 60 s WAV with word timestamps and
    highlighted words (K1, K2, K6), and `--batched True` over three files of
    20-70 s (K1, K2); never K3 or K4, since the command line decodes on the
    plain cross K/V, as the JAX one does. Every file's five outputs parse
    and agree (`check_cli_outputs`)."""
    import tempfile

    from whisper_at_tpu_torch.cli import cli

    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as root:
        t0 = time.perf_counter()
        ckpt = os.path.join(root, "large-v1-random.pt")
        torch.save({"dims": vars(model.dims), "model_state_dict": model.state_dict()}, ckpt)
        save_s = time.perf_counter() - t0
        runs = [("sequential", [CLI_SEQUENTIAL_S], ["--word_timestamps", "True",
                                                    "--highlight_words", "True"],
                 CLI_KERNELS + ("K6",)),
                ("batched", list(CLI_BATCHED_S), ["--batched", "True"], CLI_KERNELS)]
        for label, lengths, flags, kernel_ids in runs:
            paths = []
            for i, seconds in enumerate(lengths):
                paths.append(os.path.join(root, f"{label}_{i}.wav"))
                with open(paths[-1], "wb") as f:
                    f.write(wav_body(synth_audio(seconds, SEED + 30 + i)))
            out = os.path.join(root, f"out_{label}")
            argv = [*paths, "--model", ckpt, "--output_dir", out, *CLI_FLAGS, *flags]
            torch.cuda.reset_peak_memory_stats()
            with Recorder() as rec:
                _, seconds, counts = run_counted(lambda: cli(argv), kernel_ids, ("K3", "K4"))
            peak = torch.cuda.max_memory_allocated()
            checks = [check_cli_outputs(out, p, s, "--word_timestamps" in flags)
                      for p, s in zip(paths, lengths)]
            print(f"command line ({label}) {SIZE}: {len(paths)} file(s) of {lengths} s in "
                  f"{seconds:.3f} s, {seconds / len(paths):.3f} s a file (the model's load "
                  f"from a {os.path.getsize(ckpt) / 2**30:.2f} GiB .pt included; saving it "
                  f"took {save_s:.1f} s), {sum(lengths) / seconds:.2f} audio-s/s; outputs "
                  f"{checks}; peak memory {peak / 2**30:.2f} GiB, launches {counts} [{card}]",
                  flush=True)
            hold_path_inputs(card, f"command line ({label})", rec.inputs)
            del rec
    torch.cuda.empty_cache()


@contextlib.contextmanager
def decoded_tokens():
    """The tokens of every window each `DecodingTask.run` of the block
    decoded, in window order (a list, filled as the block runs)."""
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


def verify_noise_and_gaps(model, windows, tokens, opts: dict) -> tuple:
    """(noise, gaps): the largest difference between a logit of the verify
    pass over L + 1 tokens (`decoder_forward_rows`, K4 at G = L + 1) and the
    same logit of the single steps over the same prefix (`decoder_forward`,
    K4 at G = 1), at the SPEC_NOISE_AT positions of every window; and the
    top-two gap of the greedy call's filtered logits at each of its steps,
    [BATCH, steps], from the single steps teacher-forced on its tokens (the
    greedy loop's own passes)."""
    from whisper_at_tpu_torch import decoding
    from whisper_at_tpu_torch.models.decoder import (
        decoder_forward,
        decoder_forward_rows,
        init_cache,
        precompute_cross_kv,
        project_logits,
    )

    task = decoding.DecodingTask(model, decoding.DecodingOptions(**{
        k: v for k, v in opts.items() if k in decoding.DecodingOptions.__dataclass_fields__}))
    dtype = model.compute_dtype(True)
    feats, _ = model.embed_audio(windows, True)
    params = model.decoder_params_decode(opts["weight_quant"])
    cross = precompute_cross_kv(params, feats, H, dtype, quantize=opts["kv_quant"])
    init = list(task.initial_tokens)
    prefill = decoding._prefill_bucket(len(init))
    pad = prefill - len(init)
    steps = min(len(t) for t in tokens)
    sampled = torch.tensor([t[:steps] for t in tokens], device=windows.device)
    buf = torch.zeros((BATCH, prefill + steps + SPEC_G), dtype=torch.long,
                      device=windows.device)
    buf[:, pad:prefill] = torch.tensor(init, device=windows.device)
    buf[:, prefill:prefill + steps] = sampled
    total = buf.shape[1]
    filt = dict(eot=task.tokenizer.eot, ts_begin=task.tokenizer.timestamp_begin,
                blank_token=task.blank_token, max_initial_ts_index=task.max_initial_ts_index,
                suppress_blank=task.options.suppress_blank, with_ts_rules=task.with_ts_rules)

    def prefilled():
        cache = init_cache(len(params.blocks), BATCH, total, D, dtype, H, device=windows.device)
        hidden = decoder_forward(params, buf[:, :prefill], cross, cache, 0, pad, H, dtype)
        return cache, project_logits(params, hidden[:, -1:])[:, 0]

    # the greedy loop's logits, step by step, and their filtered top-two gaps
    cache, logits = prefilled()
    step_logits, gaps = [logits], []
    last_ts = torch.full((BATCH,), -1, dtype=torch.long, device=windows.device)
    for t in range(steps):
        slot = prefill + t
        f = decoding.apply_logit_filters(logits, t, buf[:, slot - 1], buf[:, slot - 2],
                                         last_ts, task.suppress_mask, **filt)
        top2 = f.topk(2, dim=-1).values
        gaps.append((top2[:, 0] - top2[:, 1]).float())
        token = buf[:, slot]
        last_ts = torch.where(token >= filt["ts_begin"], token, last_ts)
        hidden = decoder_forward(params, token[:, None], cross, cache, slot, pad, H, dtype)
        logits = project_logits(params, hidden)[:, 0]
        step_logits.append(logits)
    noise = 0.0
    for p in SPEC_NOISE_AT:
        if p + SPEC_G > steps:
            continue
        cache, _ = prefilled()
        for t in range(p - 1):  # the cache valid over the committed prefix
            decoder_forward(params, buf[:, prefill + t:prefill + t + 1], cross, cache,
                            prefill + t, pad, H, dtype)
        write = torch.full((BATCH,), prefill + p - 1, device=windows.device)
        vh = decoder_forward_rows(params, buf[:, prefill + p - 1:prefill + p - 1 + SPEC_G],
                                  cross, cache, write, pad, H, dtype)
        vlog = project_logits(params, vh)
        ref = torch.stack(step_logits[p:p + SPEC_G], dim=1)
        noise = max(noise, float((vlog - ref).abs().max()))
    return noise, torch.stack(gaps, dim=1).cpu().numpy()


def spec_check(card: str, model) -> dict:
    """(14) Speculative decoding at large-v1 full width: the headline's 24
    windows at 96 full-length tokens (`full_text_opts`) with the headline's
    options but the int8 self cache (the draft rules refuse it), three
    `transcribe_batched` calls in this process: (a) greedy, (b) a random
    tiny draft of another seed (its agreement is about nil: the loop's
    overhead bound), (c) the model as its own draft (bf16 unquantized drafts
    against the int8 verifier). (b) and (c) are counted (K1, K2, K3, K4),
    their kernel inputs recorded and held against the plain versions, and K4
    must have run at G = L + 1 = 9 on their verify passes. Each row of (b)
    and (c) equals (a)'s, or differs first where (a)'s filtered top-two gap
    is within twice the measured rounding noise between a verify pass and
    the single steps (`verify_noise_and_gaps`): the two sum in different
    orders, so a near tie may flip; the rows that differ are counted and
    printed, and any other difference fails. Returns K4's G = 9 inputs'
    launches a call and the rates."""
    import whisper_at_tpu_torch as wat
    from whisper_at_tpu_torch import decoding
    from whisper_at_tpu_torch.audio import N_SAMPLES, log_mel_spectrogram
    from whisper_at_tpu_torch.transcribe import _mel_to_windows

    audio = synth_audio(BATCH * 30, SEED)
    opts = {k: v for k, v in full_text_opts(model).items() if k != "self_kv_quant"}
    draft = wat.build_model("tiny", device="cuda", dtype=torch.bfloat16, seed=SEED + 1)
    seconds_audio = len(audio) / 16000
    calls = {}
    for label, d in (("(a) greedy", None), ("(b) tiny draft", draft), ("(c) self draft", model)):
        kw = dict(opts, draft_model=d, draft_lookahead=SPEC_LOOKAHEAD) if d is not None else opts
        torch.cuda.reset_peak_memory_stats()
        with Recorder() as rec, decoded_tokens() as tokens:
            result, seconds, counts = run_counted(
                lambda: wat.transcribe_batched(model, audio, **kw), HEADLINE_KERNELS)
        check_segments(result, len(audio), words=False)
        if len(tokens) != BATCH or min(map(len, tokens)) != TOKENS:
            raise AssertionError(f"{label}: decoded {len(tokens)} windows of "
                                 f"{sorted(set(map(len, tokens)))} tokens")
        g9 = [args for args in rec.inputs["K4"] if args[0].shape[1] == H * SPEC_G]
        if d is not None:
            if not g9:
                raise AssertionError(f"{label}: K4 never ran at G = {SPEC_G}")
            hold_path_inputs(card, f"speculative {label}", rec.inputs)
        calls[label] = dict(
            tokens=tokens, seconds=seconds,
            rate=seconds_audio / seconds, counts=counts, g9=len(g9),
            stats=decoding._LAST_SPEC_STATS if d is not None else None,
            peak=torch.cuda.max_memory_allocated())
        del rec
    greedy = calls["(a) greedy"]
    windows, _ = _mel_to_windows(log_mel_spectrogram(audio, padding=N_SAMPLES,
                                                     device=model.device))
    noise, gaps = verify_noise_and_gaps(model, windows, greedy["tokens"], opts)
    k4_name = kernels_of(["K4"])[0]
    for label in ("(b) tiny draft", "(c) self draft"):
        c = calls[label]
        differing = []
        for row, (ref, got) in enumerate(zip(greedy["tokens"], c["tokens"])):
            if ref == got:
                continue
            first = next((i for i, (x, y) in enumerate(zip(ref, got)) if x != y),
                         min(len(ref), len(got)))
            gap = float(gaps[row, first]) if first < gaps.shape[1] else float("inf")
            if not gap <= 2 * noise:
                raise AssertionError(f"{label}: window {row} differs from greedy first at "
                                     f"token {first}, where greedy's top-two gap {gap:.4g} "
                                     f"exceeds twice the rounding noise {noise:.4g}")
            differing.append((row, first, round(gap, 5)))
        s = c["stats"]
        print(f"speculative {label} {SIZE} batch {BATCH}, lookahead {SPEC_LOOKAHEAD}: "
              f"{seconds_audio:.0f} s audio in {c['seconds']:.3f} s = {c['rate']:.2f} "
              f"audio-s/s ({c['rate'] / greedy['rate']:.3f}x greedy's {greedy['rate']:.2f}, "
              f"{greedy['seconds']:.3f} s); {s['rounds']} rounds, {s['commits']} commits, "
              f"{s['tokens_per_round']:.2f} tokens a round ({s['tokens_per_round'] / BATCH:.2f}"
              f" a row); {len(differing)} of {BATCH} windows differ from greedy {differing} "
              f"(each within twice the verify-vs-step rounding noise {noise:.4g}); K4 "
              f"{c['counts'][k4_name]} launches ({c['g9']} recorded shape(s) at G = {SPEC_G}), "
              f"peak memory {c['peak'] / 2**30:.2f} GiB, launches {c['counts']} [{card}]",
              flush=True)
    del draft
    torch.cuda.empty_cache()
    return calls


@contextlib.contextmanager
def switches_on():
    """The JAX package's three switches on (`SWITCH_ENV` and
    `models.decoder.FUSED_MLP`), restored on the way out, whatever happens."""
    from whisper_at_tpu_torch.models import decoder

    saved = {k: os.environ.get(k) for k in SWITCH_ENV}
    os.environ.update(SWITCH_ENV)
    decoder.FUSED_MLP = True
    try:
        yield
    finally:
        decoder.FUSED_MLP = False
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def switches_check(card: str, model, label: str, opts: dict, kernel_ids, unused_ids):
    """`transcribe_batched` over the headline's audio with the JAX
    package's three switches on (WHISPER_AT_TPU_ENC_ATTN=flash,
    WHISPER_AT_TPU_CROSS_DECODE=stream, `models.decoder.FUSED_MLP`): a
    warm-up call whose kernel inputs are recorded and held against the
    plain versions, then the counted call, which must launch `kernel_ids`
    and none of `unused_ids`. Returns the launch counts and the
    throughput."""
    import whisper_at_tpu_torch as wat

    audio = synth_audio(BATCH * 30, SEED)
    with switches_on():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with Recorder() as rec:
            wat.transcribe_batched(model, audio, **opts)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        hold_path_inputs(card, label, rec.inputs)
        del rec
        torch.cuda.reset_peak_memory_stats()
        result, seconds, counts = run_counted(
            lambda: wat.transcribe_batched(model, audio, **opts), kernel_ids, unused_ids)
        peak = torch.cuda.max_memory_allocated()
    check_segments(result, len(audio), words=False)
    rate = len(audio) / 16000 / seconds
    print(f"transcribe_batched {label} {SIZE} batch {BATCH}: {len(audio) / 16000:.0f} s audio "
          f"in {seconds:.3f} s = {rate:.2f} audio-s/s (second call; the first took "
          f"{warm_s:.3f} s), {len(result['segments'])} segments, peak memory "
          f"{peak / 2**30:.2f} GiB, launches {counts} [{card}]", flush=True)
    return counts, rate


def probe_check(card: str):
    """(9) The streaming probe, `tools/probe_dma_torch.probe`, on the JAX
    probe's buffer (PROBE_MB MiB, PROBE_CHUNK_KB KiB chunks, seed 0) with
    the launch counts reset just before and read just after: every variant
    checked bitwise against the plain version (it raises otherwise) and
    timed. Returns (rows by kernel id for the kernels line, the counts)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
    import probe_dma_torch
    from whisper_at_tpu_torch.ops import probe_dma as pd

    n_rows, chunk_rows, n_chunks = pd.probe_geometry(PROBE_MB, PROBE_CHUNK_KB)
    x = pd.make_buffer(n_rows).cuda()
    lines = []
    result, seconds, counts = run_counted(
        lambda: probe_dma_torch.probe(x, chunk_rows, PROBE_ITERS, report=lines.append),
        tuple(PROBE_ROWS))
    print(f"streaming probe: {x.numel()} B int8 in {n_chunks} chunks of "
          f"{chunk_rows * pd.LANES} B, {PROBE_ITERS} timed calls a variant, {seconds:.2f} s, "
          f"launches {counts} [{card}]", flush=True)
    for line in lines:
        print(f"probe {line} [{card}]", flush=True)
    print(f"probe: library_ms of P1, P2-cp and P2-tma is torch.sum(x, dtype=int32), the stream "
          f"reference of the JAX probe's xla row; P2's rows are its depth-4 rings [{card}]",
          flush=True)
    del x
    nbytes = n_rows * pd.LANES + 4 * (pd.LANES + 1)  # x read once, sums and XOR written
    rows = {}
    for kid, name in PROBE_ROWS.items():
        kernel = result[name]["kernel"]
        rows[kid] = dict(kernel=kernel, ms=result[name]["ms"],
                         err=float(max(r["err"] for r in result.values()
                                       if r["kernel"] is kernel)),
                         plain_ms=result["plain"]["ms"], library_ms=result["library"]["ms"],
                         bound=bound(0.0, nbytes, PEAK_FP32_FLOPS))
    return rows, counts


# the mesh phase: the headline's options over 8 of its windows (240 s), one
# rank over NCCL, then two ranks sharing the card over gloo
MESH_WINDOWS = 8
MESH_TP = 2
MESH_DEADLINE_S = 480       # the two ranks' whole run; the parent kills them past it
MESH_GROUP_TIMEOUT_S = 120  # every collective of the two ranks
MESH_TP_KERNELS = ("K1", "K2-partial", "K3", "K4")
MESH_NOISE_STEPS = 24       # decode steps over which the tp split's noise is measured
# bf16 tolerances of the mesh phase against the mesh-free call, relative to
# the reference's largest magnitude: the encoder output and taps, and the
# tag logits (the TL-TR head over those taps)
MESH_ENC_REL = 2 ** -5
MESH_TAG_REL = 2 ** -5


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def window_results():
    """The results of every window of each `transcribe._decode_windows_batched`
    call of the block, one list a call (every window, after a mesh's dp
    gather)."""
    import importlib

    # the module: the package's `transcribe` attribute is the function
    tr = importlib.import_module("whisper_at_tpu_torch.transcribe")
    calls, run = [], tr._decode_windows_batched

    def keeping(*args, **kwargs):
        results = run(*args, **kwargs)
        calls.append([list(r.tokens) for r in results])
        return results

    tr._decode_windows_batched = keeping
    try:
        yield calls
    finally:
        tr._decode_windows_batched = run


def mesh_audio():
    audio = synth_audio(MESH_WINDOWS * 30, SEED)
    half = len(audio) // 2
    return audio, [audio[:half], audio[half:]]


def teacher_forced(model, windows, tokens, opts: dict, steps: int, feats=None):
    """The greedy loop's passes over `windows` (or their encoder output
    `feats`) teacher-forced on the first `steps` of each row of `tokens`,
    at the call's own options (its int8 weights, cross K/V and self cache),
    on the model as it is (whole or its tp shard): (raw logits [rows,
    steps, V], each step's decision margin [rows, steps]: the smaller of
    the filtered logits' top-two gap and the timestamp rule's margin, where
    a rounding difference could change the token). The difference of two
    configurations' raw logits is their rounding noise on the decode path
    (`mesh_check`)."""
    from whisper_at_tpu_torch import decoding
    from whisper_at_tpu_torch.models.decoder import (
        decoder_forward,
        init_cache,
        precompute_cross_kv,
        project_logits,
    )

    task = decoding.DecodingTask(model, decoding.DecodingOptions(**{
        k: v for k, v in opts.items() if k in decoding.DecodingOptions.__dataclass_fields__}))
    dtype = model.compute_dtype(True)
    heads = model.text_heads
    if feats is None:
        feats, _ = model.embed_audio(windows, True)
    params = model.decoder_params_decode(opts["weight_quant"])
    cross = precompute_cross_kv(params, feats, heads, dtype, quantize=opts["kv_quant"])
    init = list(task.initial_tokens)
    prefill = decoding._prefill_bucket(len(init))
    pad = prefill - len(init)
    rows, dev = windows.shape[0], windows.device
    buf = torch.zeros((rows, prefill + steps + 1), dtype=torch.long, device=dev)
    buf[:, pad:prefill] = torch.tensor(init, device=dev)
    buf[:, prefill:prefill + steps] = torch.tensor([t[:steps] for t in tokens], device=dev)
    cache = init_cache(len(params.blocks), rows, buf.shape[1], params.width, dtype, heads,
                       quantize=opts.get("self_kv_quant", False), device=dev)
    hidden = decoder_forward(params, buf[:, :prefill], cross, cache, 0, pad, heads, dtype)
    logits = project_logits(params, hidden[:, -1:])[:, 0]
    filt = dict(eot=task.tokenizer.eot, ts_begin=task.tokenizer.timestamp_begin,
                blank_token=task.blank_token, max_initial_ts_index=task.max_initial_ts_index,
                suppress_blank=task.options.suppress_blank, with_ts_rules=task.with_ts_rules)
    last_ts = torch.full((rows,), -1, dtype=torch.long, device=dev)
    raw, gaps = [], []
    for t in range(steps):
        slot = prefill + t
        raw.append(logits)
        f, rule = decoding.apply_logit_filters(
            logits, t, buf[:, slot - 1], buf[:, max(slot - 2, 0)], last_ts, task.suppress_mask,
            return_margin=True, **filt)
        top2 = f.topk(2, dim=-1).values
        gaps.append(torch.minimum(top2[:, 0] - top2[:, 1], rule.abs()).float())
        token = buf[:, slot]
        last_ts = torch.where(token >= filt["ts_begin"], token, last_ts)
        hidden = decoder_forward(params, token[:, None], cross, cache, slot, pad, heads, dtype)
        logits = project_logits(params, hidden)[:, 0]
    return torch.stack(raw, dim=1), torch.stack(gaps, dim=1)


def mesh_rank(rank: int, workdir: str) -> int:
    """One of the mesh phase's two ranks (run as `chip_smoke.py --mesh-rank
    RANK DIR`): both on card 0, in a gloo group through DIR."""
    from whisper_at_tpu_torch.parallel.mesh import init_distributed

    import torch.distributed as dist

    torch.cuda.set_device(0)
    init_distributed("cuda", backend="gloo", world_size=2, rank=rank,
                     init_method=f"file://{os.path.join(workdir, 'rendezvous')}",
                     timeout_s=MESH_GROUP_TIMEOUT_S)
    mesh_calls(os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()
    return 0


def mesh_calls(path: str) -> dict:
    """This rank's part of the mesh calls over every rank of the running
    process group (W ranks), each with large-v1 built from SEED on its
    device. dp = W: `transcribe_batched` and `transcribe_many`; pp = W and
    sp = W: the encoder over the MESH_WINDOWS windows, against
    `encoder_apply` in this rank; tp = W: the decode path's logits
    teacher-forced against the whole model's (the rounding noise of the
    split, `teacher_forced`), then the counted `transcribe_batched` (K1,
    K2-partial, K3, K4 at the rank's widths; never K2), its kernel inputs
    recorded and held against the plain versions. Saves the results to
    `path` and returns them."""
    import torch.distributed as dist

    import whisper_at_tpu_torch as wat
    from whisper_at_tpu_torch.audio import N_SAMPLES, log_mel_spectrogram
    from whisper_at_tpu_torch.parallel.inference import place_model_on_mesh, place_model_tp
    from whisper_at_tpu_torch.parallel.mesh import make_mesh
    from whisper_at_tpu_torch.parallel.pipeline import encoder_apply_pp, make_pp_mesh
    from whisper_at_tpu_torch.parallel.sequence import encoder_apply_sp, make_sp_mesh
    from whisper_at_tpu_torch.transcribe import _mel_to_windows

    torch.backends.cuda.matmul.allow_tf32 = False
    world, rank = dist.get_world_size(), dist.get_rank()
    card = card_line()
    out = {}
    dp = make_mesh(dp=world, tp=1)
    model = wat.build_model(SIZE, device=dp.device, dtype=torch.bfloat16, seed=SEED)
    audio, files = mesh_audio()
    windows, _ = _mel_to_windows(log_mel_spectrogram(audio, padding=N_SAMPLES,
                                                     device=model.device))
    with torch.no_grad():
        ref_x, ref_taps = model.embed_audio(windows)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, time.perf_counter() - t0

    # ---- dp = W ---------------------------------------------------------- #
    place_model_on_mesh(model, dp, broadcast=False)  # every rank built SEED's weights
    for name, call in (("dp batched", lambda: wat.transcribe_batched(
            model, audio, mesh=dp, **HEADLINE_OPTS)), ("dp many", lambda: wat.transcribe_many(
                model, files, mesh=dp, **HEADLINE_OPTS))):
        with window_results() as calls:
            result, seconds = timed(call)
        tags = [r["audio_tag"] for r in result] if isinstance(result, list) else \
            [result["audio_tag"]]
        out[name] = dict(tokens=calls[-1], tags=tags, seconds=seconds)
    model._mesh = None

    # ---- pp = W, sp = W: the encoder -------------------------------------- #
    with torch.no_grad():
        for name, make, apply in (("pp", make_pp_mesh, encoder_apply_pp),
                                  ("sp", make_sp_mesh, encoder_apply_sp)):
            mesh = make(world)
            (x, taps), seconds = timed(lambda: apply(model.encoder, windows, mesh, H,
                                                     torch.bfloat16))
            out[name] = dict(x_err=max_err(x, ref_x), taps_err=max_err(taps, ref_taps),
                             x_max=float(ref_x.float().abs().max()),
                             taps_max=float(ref_taps.float().abs().max()), seconds=seconds)
            del x, taps

    # ---- tp = W ------------------------------------------------------------ #
    tp = make_mesh(dp=1, tp=world)
    decoded = out["dp batched"]["tokens"]
    steps = min(MESH_NOISE_STEPS, *(len(t) for t in decoded))
    with torch.no_grad():
        ref_logits = teacher_forced(model, windows, decoded, HEADLINE_OPTS, steps, ref_x)[0]
        place_model_tp(model, tp, broadcast=False)
        x, taps = model.embed_audio(windows)
        noise = max_err(teacher_forced(model, windows, decoded, HEADLINE_OPTS, steps, x)[0],
                        ref_logits)
    out["tp encoder"] = dict(x_err=max_err(x, ref_x), taps_err=max_err(taps, ref_taps),
                             x_max=float(ref_x.float().abs().max()),
                             taps_max=float(ref_taps.float().abs().max()))
    del x, taps, ref_logits
    with Recorder() as rec, window_results() as calls:
        result, seconds, counts = run_counted(
            lambda: wat.transcribe_batched(model, audio, mesh=tp, **HEADLINE_OPTS),
            MESH_TP_KERNELS, ("K2",))
    # K1's q, K2-partial's w1, K3's wk, K4's q: the widths each ran at
    picks = {"K1": 0, "K2-partial": 3, "K3": 1, "K4": 0}
    shapes = {name: sorted({tuple(args[i].shape) for args in rec.inputs[name]})
              for name, i in picks.items()}
    hold_path_inputs(card, f"mesh tp {world} rank {rank}", rec.inputs)
    out["tp"] = dict(tokens=calls[-1], tags=[result["audio_tag"]], seconds=seconds,
                     counts=counts, noise=noise, shapes=shapes)
    torch.save(out, path)
    return out


def mesh_check(card: str, model) -> dict:
    """The mesh phase. (a) One rank over NCCL: a 1 x 1 mesh's
    `transcribe_batched` at the headline's options over MESH_WINDOWS windows,
    counted, its tokens and tags those of the mesh-free call exactly. (b) Two
    ranks on this one card over gloo (`mesh_rank`; NCCL puts no two ranks on
    one device), their rates labelled as two ranks sharing one card: dp 2
    (`transcribe_batched`, `transcribe_many` over two files), pp 2 and sp 2
    (the encoder), tp 2 (K1 and K4 at 10 heads, K2-partial at F 2560, K3 at
    N 640, counted in each rank). Each mesh call's windows are held to the
    mesh-free call's: equal, or differing first where the mesh-free greedy
    step's decision margin (its top-two gap, or the timestamp rule's
    margin) is within twice the rounding noise (`teacher_forced`,
    the decode path's logits at the call's own options, as
    `verify_noise_and_gaps` measures the verify pass's: dp as the two
    halves' batches against one, tp in the ranks against the whole model);
    encoder outputs, taps and tags within MESH_ENC_REL / MESH_TAG_REL of the
    reference's largest magnitude. Returns rank 0's tp launch counts."""
    import tempfile

    import torch.distributed as dist

    import whisper_at_tpu_torch as wat
    from whisper_at_tpu_torch.parallel.mesh import init_distributed, make_mesh

    t_phase = time.perf_counter()
    audio, _ = mesh_audio()
    seconds_audio = len(audio) / 16000
    refs = mesh_references(model)
    ref, ref_tokens = refs["batched"]

    # ---- (a) one rank over NCCL ------------------------------------------- #
    init_distributed("cuda", backend="nccl", init_method=f"tcp://localhost:{free_port()}",
                     world_size=1, rank=0, timeout_s=MESH_GROUP_TIMEOUT_S)
    mesh = make_mesh(dp=1, tp=1)
    with window_results() as calls:
        got, seconds, counts = run_counted(
            lambda: wat.transcribe_batched(model, audio, mesh=mesh, **HEADLINE_OPTS),
            HEADLINE_KERNELS)
    backend = mesh.backend
    model._mesh = None
    dist.destroy_process_group()
    if calls[-1] != ref_tokens or not np.array_equal(got["audio_tag"], ref["audio_tag"]):
        raise AssertionError("the 1 x 1 NCCL mesh's tokens or tags differ from the mesh-free "
                             "call's")
    print(f"mesh (a) 1 x 1 over {backend}: transcribe_batched {SIZE} {MESH_WINDOWS} windows "
          f"{seconds_audio:.0f} s audio in {seconds:.3f} s = {seconds_audio / seconds:.2f} "
          f"audio-s/s, tokens of all {len(ref_tokens)} windows and the tags equal to the "
          f"mesh-free call's, launches {counts} [{card}]", flush=True)

    # ---- (b) two ranks sharing the card over gloo ------------------------- #
    workdir = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    logs = [open(os.path.join(workdir, f"rank{r}.log"), "w") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mesh-rank", str(r),
                               workdir], stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(2)]
    t0 = time.perf_counter()
    try:
        for p in procs:
            p.wait(timeout=max(1.0, MESH_DEADLINE_S - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    ranks_s = time.perf_counter() - t0
    for r in range(2):
        with open(os.path.join(workdir, f"rank{r}.log")) as f:
            for line in f.read().splitlines():
                print(f"mesh rank {r}: {line}", flush=True)
    if any(p.returncode for p in procs):
        raise AssertionError(f"mesh ranks exited {[p.returncode for p in procs]} (killed "
                             f"past {MESH_DEADLINE_S} s: {ranks_s >= MESH_DEADLINE_S})")
    ranks = [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
             for r in range(2)]
    hold_mesh_ranks(card, model, ranks, refs,
                    "two ranks sharing one card over gloo, no scaling figure")
    print(f"mesh: the two ranks took {ranks_s:.1f} s, the phase "
          f"{time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    return ranks[0]["tp"]["counts"]


def mesh_references(model) -> dict:
    """The mesh-free calls the mesh calls are held to, at the headline's
    options over `mesh_audio`: {"batched": (result, tokens a window),
    "many": (results, tokens a window)}."""
    import whisper_at_tpu_torch as wat

    audio, files = mesh_audio()
    with window_results() as calls:
        ref = wat.transcribe_batched(model, audio, **HEADLINE_OPTS)
        ref_many = wat.transcribe_many(model, files, **HEADLINE_OPTS)
    return {"batched": (ref, calls[0]), "many": (ref_many, calls[1])}


def hold_mesh_ranks(card: str, model, ranks: list, refs: dict, setting: str) -> None:
    """Every rank's mesh calls (`mesh_calls`, W ranks) held to the mesh-free
    calls (`mesh_references`) on the whole `model`: each window's tokens
    equal, or differing first at a decision margin within twice the
    rounding noise (the larger of dp's, the windows decoded as W contiguous
    shares against one batch, and tp's, measured in the ranks); encoder
    output, taps and tags within MESH_ENC_REL / MESH_TAG_REL of the
    reference's largest magnitude; the tp kernels at the rank's widths.
    Prints a line a rank, rates labelled with `setting`; raises on any
    failure."""
    from whisper_at_tpu_torch.audio import N_SAMPLES, log_mel_spectrogram
    from whisper_at_tpu_torch.parallel.inference import share
    from whisper_at_tpu_torch.transcribe import _mel_to_windows

    world = len(ranks)
    audio, files = mesh_audio()
    seconds_audio = len(audio) / 16000
    (ref, ref_tokens), (ref_many, ref_many_tokens) = refs["batched"], refs["many"]

    windows, _ = _mel_to_windows(log_mel_spectrogram(audio, padding=N_SAMPLES,
                                                     device=model.device))
    many_windows = torch.cat([_mel_to_windows(log_mel_spectrogram(
        f, padding=N_SAMPLES, device=model.device))[0] for f in files])
    with torch.no_grad():
        steps = min(len(t) for t in ref_tokens)
        ref_logits, gaps = teacher_forced(model, windows, ref_tokens, HEADLINE_OPTS, steps)
        shares = [share(len(ref_tokens), world, i) for i in range(world)]
        split = torch.cat([teacher_forced(model, windows[sl], ref_tokens[sl], HEADLINE_OPTS,
                                          steps)[0] for sl in shares if sl.stop > sl.start])
        dp_noise = max_err(split, ref_logits)
        del ref_logits, split
        many_gaps = teacher_forced(model, many_windows, ref_many_tokens, HEADLINE_OPTS,
                                   min(len(t) for t in ref_many_tokens))[1].cpu().numpy()
    gaps = gaps.cpu().numpy()
    tp_noise = max(r["tp"]["noise"] for r in ranks)
    noise = max(tp_noise, dp_noise)
    failures = []

    def held(label, tokens, ref_rows, row_gaps):
        differing = []
        if len(tokens) != len(ref_rows):
            failures.append(f"mesh {label}: {len(tokens)} windows, not {len(ref_rows)}")
        for row, (want, have) in enumerate(zip(ref_rows, tokens)):
            if want == have:
                continue
            first = next((i for i, (a, b) in enumerate(zip(want, have)) if a != b),
                         min(len(want), len(have)))
            gap = float(row_gaps[row, first]) if first < row_gaps.shape[1] else float("inf")
            if not gap <= 2 * noise:
                failures.append(f"mesh {label}: window {row} differs first at token {first}, "
                                f"where the mesh-free step's decision margin {gap:.4g} exceeds "
                                f"twice the rounding noise {noise:.4g}")
            differing.append((row, first, round(gap, 5)))
        return differing

    def tags_within(label, tags, ref_tags):
        worst = 0.0
        for t, want in zip(tags, ref_tags):
            err = float(np.abs(np.asarray(t) - np.asarray(want)).max())
            tol = MESH_TAG_REL * float(np.abs(np.asarray(want)).max())
            if not err <= tol:
                failures.append(f"mesh {label}: tags differ by {err:.4g} > {tol:.4g}")
            worst = max(worst, err)
        return worst

    for r, out in enumerate(ranks):
        lines = []
        for label, ref_rows, ref_tags, row_gaps in (
                ("dp batched", ref_tokens, [ref["audio_tag"]], gaps),
                ("dp many", ref_many_tokens, [x["audio_tag"] for x in ref_many], many_gaps),
                ("tp", ref_tokens, [ref["audio_tag"]], gaps)):
            o = out[label]
            diff = held(f"rank {r} {label}", o["tokens"], ref_rows, row_gaps)
            tag_err = tags_within(f"rank {r} {label}", o["tags"], ref_tags)
            lines.append(f"{label} {seconds_audio / o['seconds']:.2f} audio-s/s, "
                         f"{len(diff)} of {len(ref_rows)} windows differ {diff}, tags "
                         f"max |diff| {tag_err:.4g}")
        for label in ("pp", "sp", "tp encoder"):
            o = out[label]
            for part in ("x", "taps"):
                tol = MESH_ENC_REL * o[f"{part}_max"]
                if not o[f"{part}_err"] <= tol:
                    failures.append(f"mesh rank {r} {label}: {part} differs by "
                                    f"{o[part + '_err']:.4g} > {tol:.4g}")
            rate = f", {seconds_audio / o['seconds']:.2f} audio-s/s" if "seconds" in o else ""
            lines.append(f"{label} encoder x max |diff| {o['x_err']:.4g} (of {o['x_max']:.4g}), "
                         f"taps {o['taps_err']:.4g} (of {o['taps_max']:.4g}){rate}")
        tp = out["tp"]
        print(f"mesh rank {r} of {world}, {setting}, {MESH_WINDOWS} windows "
              f"({seconds_audio:.0f} s audio): " + "; ".join(lines) + f"; tp {world} launches "
              f"{tp['counts']}, "
              f"kernel input shapes {tp['shapes']}, tp logit noise {tp['noise']:.4g} [{card}]",
              flush=True)
        widths = tp["shapes"]
        if not (all(s[-1] == D // world for s in widths["K1"])
                and all(s == (4 * D // world, D) for s in widths["K2-partial"])
                and all(s == (D // world, D) for s in widths["K3"])
                and all(s[1] % (H // world) == 0 for s in widths["K4"])):
            failures.append(f"mesh rank {r}: tp kernels ran at other widths {widths}")
    print(f"mesh: near-tie threshold twice {noise:.4g}, the larger rounding noise of the decode "
          f"path's logits teacher-forced at the headline's options (dp: {MESH_WINDOWS} windows "
          f"as {world} shares against one batch, {dp_noise:.4g}; tp {world} against the whole "
          f"model, {tp_noise:.4g}) [{card}]", flush=True)
    if failures:
        raise AssertionError("; ".join(failures))


# ---- (16) the research paths ----------------------------------------------- #
# (a) examples/esc50_probe_torch.py's 40 clips of 5 s (5 classes, 4 folds):
# all-layer features at n_frames 500 (T = 250 encoder positions) pooled over
# time, then the layer-wise probe at the example's 1000 epochs on the card and
# on the CPU; (b) examples/noise_robustness_torch.py's corpus (3 utterances of
# 3 s, 2 noise classes) at 3 SNRs through the sequential transcribe at its
# defaults; (c) the AudioSet evaluation over 4 clips of 10 s, each window
# decoded in full (224 tokens at ~70 ms a step on random weights), twice
PROBE_CLIPS = 40
PROBE_FRAMES = 500
PROBE_MAX_ITER = 1000
PROBE_TOL = 1e-9  # the probe's float64 coefficients against scikit-learn's (CPU tests)
NOISE_UTTS = 3
NOISE_SNRS = (-10, 0, 10)
NOISE_CLASSES = 50  # the class-wise scorer's columns (ESC-50)
AS_CLIPS = 4
AS_CLIP_S = 10
# the random decoder's end-of-text preference in (b): its final layer
# norm's bias moved EOT_BIAS along a seeded unit direction, the EOT embedding
# row EOT_ROW times it, so that EOT's logit leads every other by ~50
EOT_BIAS = 10.0
EOT_ROW = 5.0


def example_module(name: str):
    """examples/<name>.py of this checkout as a module."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@contextlib.contextmanager
def eot_preference(model):
    """Within the block, the random decoder ends every decode at once, as a
    trained decoder ends a window with nothing to say: each decode samples
    its forced first timestamp, then EOT. A random decoder otherwise samples
    all 224 tokens of every rung of the temperature ladder (~70 ms a step
    at one audio row: minutes a file). The two edited tensors are restored
    on exit."""
    from whisper_at_tpu_torch.tokenizer import get_tokenizer

    eot = get_tokenizer(model.is_multilingual).eot
    dec = model.decoder
    gen = torch.Generator(device=model.device)
    gen.manual_seed(SEED)
    e = torch.randn(model.dims.n_text_state, generator=gen, device=model.device)
    e = e / e.norm()
    bias, row = dec.ln.bias.detach().clone(), dec.token_embedding.weight[eot].detach().clone()
    with torch.no_grad():
        dec.ln.bias += (EOT_BIAS * e).to(bias.dtype)
        dec.token_embedding.weight[eot] = (EOT_ROW * e).to(row.dtype)
    model._decode_params = {}
    try:
        yield
    finally:
        with torch.no_grad():
            dec.ln.bias.copy_(bias)
            dec.token_embedding.weight[eot] = row
        model._decode_params = {}


@contextlib.contextmanager
def decodes_seen():
    """(temperature, tokens sampled) of every decode the sequential
    transcribe runs in the block (a list, filled as it runs)."""
    module = sys.modules["whisper_at_tpu_torch.transcribe"]
    seen, decode = [], module.decode

    def keeping(model, mel, opts):
        result = decode(model, mel, opts)
        seen.append((opts.temperature, len(result.tokens)))
        return result

    module.decode = keeping
    try:
        yield seen
    finally:
        module.decode = decode


def layer_probe_check(card: str, model, root: str) -> dict:
    """(16a) The ESC-50 probe: each clip through `extract_features(n_frames
    =500)` and pooled over time, K1 and K2 once a layer a clip, never K3 or
    K4; then `layer_wise_probe` in float64 on the card and on the CPU, every
    layer's fold accuracies equal; each fold's fits again on both, epoch
    counts equal, coefficients and epoch losses within PROBE_TOL."""
    from whisper_at_tpu_torch.research import feature_extract as fx
    from whisper_at_tpu_torch.research import layer_probe

    paths, labels, folds = example_module("esc50_probe_torch").make_clips(
        os.path.join(root, "esc50"), n=PROBE_CLIPS)
    n_layer = model.dims.n_audio_layer

    def extract():
        return np.stack([fx.extract_features(model, p, n_frames=PROBE_FRAMES).mean(axis=1)
                         for p in paths])

    with Recorder() as rec:
        feats, extract_s, counts = run_counted(extract, ("K1", "K2"), ("K3", "K4"))
    k1, k2 = kernels_of(("K1", "K2"))
    if counts[k1] != PROBE_CLIPS * n_layer or counts[k2] != PROBE_CLIPS * n_layer:
        raise AssertionError(f"the probe's extraction launched K1 {counts[k1]} and K2 "
                             f"{counts[k2]} times, not {PROBE_CLIPS * n_layer}")
    if feats.shape != (PROBE_CLIPS, n_layer, D) or not np.isfinite(feats).all():
        raise AssertionError(f"probe features {feats.shape}, or not finite")
    hold_path_inputs(card, "research probe extraction", rec.inputs)
    del rec

    feats64 = feats.astype(np.float64)
    seconds, results = {}, {}
    for device in ("cuda", "cpu"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results[device] = layer_probe.layer_wise_probe(feats64, labels, folds, PROBE_MAX_ITER,
                                                       device=device)
        torch.cuda.synchronize()
        seconds[device] = time.perf_counter() - t0
    on_card, card_s, cpu_s = results["cuda"], seconds["cuda"], seconds["cpu"]
    if [r["fold_accuracies"] for r in on_card] != [r["fold_accuracies"] for r in results["cpu"]]:
        raise AssertionError("the probe's fold accuracies differ between the card and the CPU")
    # each fold's fits again, on the card and on the CPU: equal epoch counts,
    # coefficients and loss curves within the CPU tests' tolerance
    epochs, coef_err, loss_err = [], 0.0, 0.0
    for train_idx, _ in layer_probe._fold_defs(len(labels), folds):
        a, b = (layer_probe.fit_linear_probe(feats64[train_idx], labels[train_idx],
                                             PROBE_MAX_ITER, device) for device in ("cuda", "cpu"))
        if not np.array_equal(a.n_iter, b.n_iter):
            raise AssertionError(f"the probe's epoch counts differ between the card "
                                 f"({a.n_iter}) and the CPU ({b.n_iter})")
        epochs.append(a.n_iter)
        coef_err = max(coef_err, float((a.coefs.cpu() - b.coefs).abs().max()),
                       float((a.intercepts.cpu() - b.intercepts).abs().max()))
        loss_err = max(loss_err, max(float(np.abs(np.subtract(ca, cb)).max())
                                     for ca, cb in zip(a.loss_curves, b.loss_curves)))
    if coef_err > PROBE_TOL or loss_err > PROBE_TOL:
        raise AssertionError(f"the probe's card and CPU fits differ by {coef_err:.3e} in "
                             f"coefficients and {loss_err:.3e} in losses (tolerance {PROBE_TOL})")
    accs = [r["accuracy"] for r in on_card]
    best = int(np.argmax(accs))
    print(f"research (a) ESC-50 probe {SIZE}: {PROBE_CLIPS} clips of 5 s, n_frames "
          f"{PROBE_FRAMES} (T = {PROBE_FRAMES // 2}), features {list(feats.shape)} in "
          f"{extract_s:.3f} s = {PROBE_CLIPS / extract_s:.2f} clips/s, launches K1 "
          f"{counts[k1]}, K2 {counts[k2]}; layer_wise_probe (float64, max_iter "
          f"{PROBE_MAX_ITER}, {len(epochs)} folds): card {card_s:.3f} s, CPU "
          f"{cpu_s:.3f} s; fold accuracies and epoch counts equal (epochs a fold, fewest-"
          f"most over the layers: {[f'{e.min()}-{e.max()}' for e in epochs]}); largest "
          f"difference in coefficients {coef_err:.3e} and in epoch losses {loss_err:.3e} "
          f"(tolerance {PROBE_TOL}, the CPU tests'); "
          f"accuracy layer 0 {accs[0]:.3f}, best layer {best} {accs[best]:.3f}, last "
          f"{accs[-1]:.3f} [{card}]", flush=True)
    return dict(clips_s=PROBE_CLIPS / extract_s, card_s=card_s, cpu_s=cpu_s, counts=counts)


def noise_check(card: str, model, root: str) -> dict:
    """(16b) The noise-robustness set: 3 utterances x 2 noise classes x 3
    SNRs mixed by `generate_noisy_set` (18 files), `transcribe_noisy_set` at
    its defaults (the sequential transcribe, the temperature ladder, the
    gates on; bf16 on the plain cross K/V, so K1 and K2, never K3 or K4);
    18 transcripts written and none by a second call; one finite WER a SNR;
    the class matrix [3, 50] filled in exactly the two classes' columns.
    The files are not cut; each decode is, to its first timestamp and EOT
    (`eot_preference`): every file climbs the whole ladder, six rungs of up
    to 224 tokens at ~70 ms a step on random weights."""
    from whisper_at_tpu_torch.research import noisy_speech, wer

    speech, noise_by_class, truth_dir = example_module("noise_robustness_torch").make_corpus(
        os.path.join(root, "noise"), n_utts=NOISE_UTTS)
    mixed_dir, text_dir = os.path.join(root, "noise", "mixed"), os.path.join(root, "noise", "hyp")
    mixed = noisy_speech.generate_noisy_set(speech, noise_by_class, mixed_dir,
                                            snr_levels=NOISE_SNRS, n_utterances=NOISE_UTTS)
    n_files = NOISE_UTTS * len(noise_by_class) * len(NOISE_SNRS)
    if len(mixed) != n_files:
        raise AssertionError(f"{len(mixed)} mixtures, not {n_files}")
    with eot_preference(model), decodes_seen() as decodes, Recorder() as rec:
        written, seconds, counts = run_counted(
            lambda: noisy_speech.transcribe_noisy_set(model, mixed_dir, text_dir),
            ("K1", "K2"), ("K3", "K4"))
        again = noisy_speech.transcribe_noisy_set(model, mixed_dir, text_dir)
    if len(written) != n_files or again:
        raise AssertionError(f"{len(written)} transcripts written, then {len(again)} more")
    by_snr = wer.eval_noise_wer(text_dir, truth_dir, os.path.join(root, "noise", "wer.csv"),
                                snr_levels=NOISE_SNRS)
    if sorted(by_snr) != sorted(NOISE_SNRS) or not np.isfinite(list(by_snr.values())).all():
        raise AssertionError(f"WER by SNR {by_snr}")
    cla = wer.eval_noise_wer_classwise(text_dir, truth_dir,
                                       os.path.join(root, "noise", "wer_cla.csv"),
                                       n_classes=NOISE_CLASSES, snr_levels=NOISE_SNRS)
    filled = sorted(np.flatnonzero(np.isfinite(cla).any(axis=0)).tolist())
    if cla.shape != (len(NOISE_SNRS), NOISE_CLASSES) or filled != sorted(noise_by_class) \
            or not np.isfinite(cla[:, filled]).all():
        raise AssertionError(f"class-wise WER {cla.shape}, columns filled {filled}")
    hold_path_inputs(card, "research noise set", rec.inputs)
    del rec
    k1, k2 = kernels_of(("K1", "K2"))
    print(f"research (b) noise-robustness set {SIZE}: {n_files} files (3 utterances x "
          f"{len(noise_by_class)} classes x SNRs {list(NOISE_SNRS)}) in {seconds:.3f} s = "
          f"{seconds / n_files:.3f} s a file, {len(decodes)} decodes, temperatures reached "
          f"{sorted({t for t, _ in decodes})}; CUT: every decode is its first timestamp and EOT (the "
          f"decoder's EOT preference), so these seconds time the encoder and 2-token "
          f"decodes, not full windows, and every transcript is empty; WER by SNR "
          f"{ {k: round(v, 4) for k, v in by_snr.items()} }; class-wise [3, 50] filled in "
          f"columns {filled}; launches K1 {counts[k1]}, K2 {counts[k2]}; a second call wrote "
          f"0 files [{card}]", flush=True)
    return dict(file_s=seconds / n_files, counts=counts)


def audioset_check(card: str, model, root: str) -> dict:
    """(16c) `evaluate_audioset` over AS_CLIPS WAVs of AS_CLIP_S s with an
    eval json (1-3 labels a clip) and the 527-row label csv: the sequential
    transcribe with the gates off, the random decoder as it is, so every
    window decodes in full at T = 0 (K1, K2); predictions [AS_CLIPS, 527],
    each row the first tag window of `transcribe` called directly on its
    clip, and `compute_map_from_saved` returns the same mAP. The lines of
    the 527 - 3 classes without a positive clip ("class k no true sample")
    are `train.stats.calculate_stats`' own."""
    from whisper_at_tpu_torch.research import as_eval

    as_root = os.path.join(root, "audioset")
    os.makedirs(as_root)
    label_csv = write_label_csv(as_root)
    rng = np.random.default_rng(1)
    data = []
    for i in range(AS_CLIPS):
        path = os.path.join(as_root, f"eval{i}.wav")
        with open(path, "wb") as f:
            f.write(wav_body(synth_audio(AS_CLIP_S, SEED + 50 + i)))
        labels = rng.choice(N_CLASSES, size=int(rng.integers(1, 4)), replace=False)
        data.append({"wav": path, "labels": ",".join(f"/m/{k}" for k in labels)})
    eval_json = os.path.join(as_root, "eval.json")
    with open(eval_json, "w") as f:
        json.dump({"data": data}, f)
    out_dir = os.path.join(as_root, "out")
    with decodes_seen() as decodes:
        res, seconds, counts = run_counted(
            lambda: as_eval.evaluate_audioset(model, eval_json, label_csv, out_dir,
                                              tag="smoke"),
            ("K1", "K2"), ("K3", "K4"))
    if {t for t, _ in decodes} != {0.0}:
        raise AssertionError(f"the gates off, a decode ran at another temperature: {decodes}")
    preds = np.load(os.path.join(out_dir, "smoke_pred.npy"))
    if preds.shape != (AS_CLIPS, N_CLASSES) or not np.isfinite(preds).all():
        raise AssertionError(f"AudioSet predictions {preds.shape}, or not finite")
    worst = 0.0
    for row, entry in zip(preds, data):
        direct = model.transcribe(entry["wav"], at_time_res=10, logprob_threshold=None,
                                  compression_ratio_threshold=None, verbose=None)
        worst = max(worst, float(np.abs(row - np.asarray(direct["audio_tag"])[0]).max()))
    if worst != 0.0:
        raise AssertionError(f"a saved prediction differs from its direct transcribe by {worst}")
    again = as_eval.compute_map_from_saved(out_dir, ["smoke"])
    if not np.isfinite(res["mAP"]) or again != {"smoke": res["mAP"]}:
        raise AssertionError(f"mAP {res['mAP']}, from the saved arrays {again}")
    k1, k2 = kernels_of(("K1", "K2"))
    print(f"research (c) AudioSet evaluation {SIZE}: {AS_CLIPS} clips of {AS_CLIP_S} s in "
          f"{seconds:.3f} s = {seconds / AS_CLIPS:.3f} s a clip, predictions "
          f"{list(preds.shape)} equal to each clip's direct transcribe, mAP {res['mAP']:.4f} "
          f"(the same from the saved arrays); {len(decodes)} windows decoded in full at T = 0, "
          f"tokens sampled a window {[n for _, n in decodes]}; launches K1 {counts[k1]}, K2 {counts[k2]} [{card}]", flush=True)
    return dict(clip_s=seconds / AS_CLIPS, counts=counts)


def research_check(card: str, model) -> dict:
    """(16) The research paths at large-v1 full width, in a temporary
    directory: the ESC-50 probe, the noise-robustness set and the AudioSet
    evaluation, each counted on its own."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_research_") as root:
        out = dict(probe=layer_probe_check(card, model, root),
                   noise=noise_check(card, model, root),
                   audioset=audioset_check(card, model, root))
    print(f"research phase: {time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--mesh-rank"]:
        return mesh_rank(int(sys.argv[2]), sys.argv[3])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # the stage profilers of the serving and streaming phases, read when the
    # package is imported
    os.environ["WHISPER_AT_TPU_SERVE_PROF"] = "1"
    os.environ["WHISPER_AT_TPU_STREAM_PROF"] = "1"
    from whisper_at_tpu_torch.ops import cuda

    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    build_s = cuda.build_all()
    print(f"kernel build: {build_s:.1f} s for {len(cuda.KERNELS)} kernels [{card}]",
          flush=True)
    for kernel in cuda.KERNELS.values():
        regs = [ln.strip() for ln in kernel.build_log().splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"ptxas {kernel.name}: {' | '.join(regs)}", flush=True)

    rows, k9_launches = kernel_checks(card)
    import whisper_at_tpu_torch as wat

    model = wat.build_model(SIZE, device="cuda", dtype=torch.bfloat16, seed=SEED)
    counts, rate = transcribe_check(card, model)
    int4_counts, int4_rate = int4_check(card, model)
    _, beam_rate = beam_check(card, model)
    a_counts, a_rate = switches_check(card, model, "switches (a)", HEADLINE_OPTS,
                                      SWITCHES_A_KERNELS, ("K1", "K4"))
    b_counts, b_rate = switches_check(card, model, "switches (b)", SWITCHES_B_OPTS,
                                      SWITCHES_B_KERNELS, ("K1", "K4-int4"))
    print(f"throughput in this process: headline {rate:.2f}, int4 {int4_rate:.2f}, "
          f"beam {BEAM} {beam_rate:.2f}, switches (a) {a_rate:.2f}, switches (b) "
          f"{b_rate:.2f} audio-s/s [{card}]", flush=True)
    words_counts, words_k6 = words_check(card, model)
    # K6's numbers in the kernels line come from the words call's own inputs
    words_k6["err"] = max(words_k6["err"], rows["K6"]["err"])
    rows["K6"].update(words_k6)
    sequential_check(card, model)
    serving_check(card, model, rate)
    streaming_check(card, model, rate)
    training_check(card, model)
    cli_check(card, model)
    spec_check(card, model)
    mesh_counts = mesh_check(card, model)
    research_check(card, model)
    probe_rows, probe_counts = probe_check(card)
    rows.update(probe_rows)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from start to here [{card}]",
          flush=True)

    # launches from the counted call of the path that runs each kernel
    # (K9 has no path: its launches are those of its kernel phase)
    path_counts = {"K6": words_counts, "K3-int4": int4_counts, "K4-int4": int4_counts,
                   "K5": int4_counts, "K7": a_counts, "K8-int8": a_counts, "K10": a_counts,
                   "K8": b_counts, "K10-int4": b_counts,
                   "K9": {rows["K9"]["kernel"].name: k9_launches},
                   "K2-partial": mesh_counts,
                   "P1": probe_counts, "P2-cp": probe_counts, "P2-tma": probe_counts}
    line = {"kernels": [
        {"name": name,
         "route": "cuda",
         "source": f"whisper_at_tpu_torch/csrc/{r['kernel'].source}",
         "replaces": r["kernel"].replaces,
         "launches": path_counts.get(name, counts)[r["kernel"].name],
         "max_abs_err": r["err"],
         "ms": r["ms"],
         "plain_ms": r["plain_ms"],
         "bound_ms": r["bound"][0],
         "bound_by": r["bound"][1],
         "library_ms": r["library_ms"],
         **({"chain_floor_ms": r["floor"]} if "floor" in r else {})}
        for name, r in rows.items()]}
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
