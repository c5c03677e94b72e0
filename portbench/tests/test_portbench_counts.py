"""The operation and byte counts the roofline and mfu metrics read."""

import json
import os

import pytest

from portbench import counts

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def dims(name):
    with open(os.path.join(ROOT, "portbench", "configs", f"{name}.json")) as f:
        return json.load(f)["dims"]


LARGE = dims("large-v1")


def test_kernel_bounds_match_the_kernel_table_at_batch_24():
    # PERF.md's kernel table, large-v1 at batch 24: K1 0.2796, K2 0.9542,
    # K4 0.0293 ms
    assert counts.k1_bound_s(24, 1500, 1280) * 1e3 == pytest.approx(0.2796, abs=5e-5)
    assert counts.k2_bound_s(24 * 1500, 1280) * 1e3 == pytest.approx(0.9542, abs=5e-5)
    assert counts.k4_bound_s(24, 20, 1, 1500, 1280) * 1e3 == pytest.approx(0.0293, abs=5e-5)


@pytest.mark.parametrize("batch", [1, 24, 256])
def test_bounds_are_per_launch_at_any_batch(batch):
    # operation-bound K1 and K2 grow with the batch; K4's bytes nearly so
    # (its pad bias is read once a launch)
    assert counts.k1_bound_s(batch, 1500, 1280) == pytest.approx(
        batch * counts.k1_bound_s(1, 1500, 1280))
    assert counts.k2_bound_s(batch * 1500, 1280) == pytest.approx(
        batch * counts.k2_bound_s(1500, 1280), rel=1e-3)
    assert counts.k4_bound_s(batch, 20, 1, 1500, 1280) == pytest.approx(
        batch * counts.k4_bound_s(1, 20, 1, 1500, 1280), rel=2e-3)


def test_encoder_macs_of_large_v1():
    # conv stem 8.2944e9 + 32 blocks of 3.52512e10 = 1.1363328e12 (the
    # issue's 1.135e12, to 0.12%)
    assert counts.encoder_macs(LARGE) == 1_136_332_800_000
    assert counts.encoder_macs(LARGE) == pytest.approx(1.135e12, rel=2e-3)


def test_flops_are_twice_the_macs():
    assert counts.flops_from_macs(counts.encoder_macs(LARGE)) == 2 * 1_136_332_800_000
    assert counts.mfu_percent(989e12 / 2, 1.0) == pytest.approx(100.0)


def brute_decoder_macs(d, n_prompt, n_tokens):
    """Position by position: each forwarded position's products over its
    own keys, and the logit rows the greedy loop projects."""
    total = 0
    for p in range(n_prompt + n_tokens - 1):
        keys = p + 1
        total += d["n_text_layer"] * (4 * d["n_text_state"] ** 2 + 2 * keys * d["n_text_state"]
                                      + 2 * d["n_text_state"] ** 2
                                      + 2 * d["n_audio_ctx"] * d["n_text_state"]
                                      + 8 * d["n_text_state"] ** 2)
    return total + (n_tokens + 1) * d["n_text_state"] * d["n_vocab"]


@pytest.mark.parametrize("n_tokens", [1, 8, 96])
def test_decoder_macs_attend_over_each_positions_own_keys(n_tokens):
    assert counts.decoder_macs(LARGE, 4, n_tokens) == brute_decoder_macs(LARGE, 4, n_tokens)


def test_decoder_macs_below_the_all_keys_count():
    # ops/flops.py charged every token attention over all n_tokens keys
    n = 96
    d = LARGE
    all_keys = d["n_text_layer"] * (n + 3) * 2 * n * d["n_text_state"]
    own_keys = d["n_text_layer"] * 2 * d["n_text_state"] * sum(range(1, n + 4))
    assert own_keys < all_keys


def test_tltr_macs_of_one_window():
    d = LARGE
    block = lambda s: 4 * s * 1280 ** 2 + 2 * s * s * 1280 + 8 * s * 1280 ** 2  # noqa: E731
    assert counts.tltr_macs(d, "tl_tr_1_8") == 3 * (32 * block(25) + block(32) + 1280 * 527)
    with pytest.raises(ValueError):
        counts.tltr_macs(d, "tl_down_tr_512_1_8")


def test_chunks():
    assert counts.chunks(256, 256) == [256]
    assert counts.chunks(300, 256) == [256, 44]
