"""The per-layer readers on traces made up here: what each counts and
where it finds nothing to read."""

import os

import pytest

from portbench import bench

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH_DIR = os.path.join(ROOT, "portbench")


def trace_of(ops, layers=2, sample_len=3, calls=4, wall_s=8.0, busy_s=1.5):
    return {"profile": {"ops": ops, "busy_s": busy_s, "call_s": 3.0},
            "cell": {"dims": {"n_text_layer": layers}, "sample_len": sample_len},
            "window": {"calls": calls, "wall_s": wall_s}}


def decode_ops(layers, sample_len, per_layer, t=1000.0):
    """Made-up device records of one decode batch: an encoder kernel, then
    each step's layers with one K4 launch among `per_layer` kernels and a
    copy, then a tagging kernel."""
    ops = [("encoder_kernel", 0.0, 10.0)]
    for _ in range(sample_len):
        for _ in range(layers):
            ops.append(("ln_kernel", t, t + 1))
            ops.append(("cross_decode_kernel<int8>", t + 1, t + 2))
            ops += [("elementwise_kernel", t + 2 + i, t + 3 + i) for i in range(per_layer - 2)]
            ops.append(("Memcpy DtoD", t + per_layer, t + per_layer + 1))
            t += per_layer + 1
    return ops + [("tag_kernel", t + 5, t + 6)]


def test_launches_per_step_counts_the_greedy_loop_only():
    read = bench.load_reader(BENCH_DIR, "launches_per_step")
    ops = decode_ops(layers=2, sample_len=3, per_layer=7)
    assert read(trace_of(ops)) == 14  # 7 kernels a layer, 2 layers; no copy, encoder or tag
    assert read(trace_of(ops + decode_ops(2, 3, 7, t=5000.0))) == 14
    k4 = [i for i, op in enumerate(ops) if "cross_decode" in op[0]]
    assert read(trace_of(ops[:k4[-1]] + ops[k4[-1] + 1:])) is None  # a K4 launch missing
    assert read(dict(trace_of(ops), profile=None)) is None


def test_device_idle_share_reads_busy_against_a_plain_call():
    read = bench.load_reader(BENCH_DIR, "device_idle_share")
    # plain calls of 2 s (8 s over 4), 1.5 s busy in the profiled call
    assert read(trace_of([], busy_s=1.5)) == pytest.approx(25.0)
    assert read(trace_of([], busy_s=0.0)) is None
