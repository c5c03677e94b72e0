"""Beam search and best-of sampling in the port against the JAX package.

Beam search is held token for token in fp32 against the JAX package's
`beam_sample_loop` (beams 2 to 5, with patience and length penalty, alone
and with the int8 and int4 options; the JAX side on its fused layout, so
its K4 runs in interpret mode at G = beam). The ranker is compared on
degenerate rows, and best-of's grouping and ranking with the same sampled
rows handed to both packages: their random generators differ, so samples
are not compared.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisper_at_tpu as jax_wat
from whisper_at_tpu import decoding as jax_decoding
from whisper_at_tpu.models.dims import ModelDimensions as JaxDims
from whisper_at_tpu.models.whisper import Whisper as JaxWhisper
import whisper_at_tpu_torch as wat
from whisper_at_tpu_torch import decoding
from whisper_at_tpu_torch.convert import from_jax_params

DIMS = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=128, n_audio_head=2,
            n_audio_layer=2, n_vocab=51865, n_text_ctx=448, n_text_head=2,
            n_text_state=128, n_text_layer=2)
INT8 = dict(kv_quant=True, weight_quant=True, self_kv_quant=True)
INT4 = dict(kv_quant=True, kv_bits=4, weight_quant=True, weight_bits=4,
            self_kv_quant=True, self_kv_bits=4)
NO_GATE = dict(logprob_threshold=None, compression_ratio_threshold=None,
               no_speech_threshold=None)
EOT = 50257  # the multilingual vocabulary's end of text


@pytest.fixture(scope="module")
def pair():
    jm = JaxWhisper(JaxDims(**DIMS), seed=3)
    tm = wat.Whisper(wat.ModelDimensions(**DIMS))
    tm.load_state_dict(from_jax_params(jm.params))
    return jm, tm


@pytest.fixture(scope="module")
def mel():
    return (np.random.default_rng(7).standard_normal((2, 80, 3000)) * 0.4).astype(np.float32)


def _decode_both(pair, mel, **options):
    jm, tm = pair
    opts = dict(language="en", fp16=False, **options)
    ref = jax_wat.decode(jm, jnp.asarray(mel), jax_wat.DecodingOptions(kv_layout="fused", **opts))
    out = wat.decode(tm, torch.from_numpy(mel), wat.DecodingOptions(**opts))
    return ref, out


def _assert_same(ref, out, logprob_tol=1e-4):
    assert len(ref) == len(out)
    for r, o in zip(ref, out):
        assert o.tokens == r.tokens
        assert o.text == r.text
        assert o.avg_logprob == pytest.approx(r.avg_logprob, abs=logprob_tol)
        assert o.no_speech_prob == pytest.approx(r.no_speech_prob, abs=1e-6)


@pytest.mark.parametrize("options", [
    dict(beam_size=2, sample_len=16),
    dict(beam_size=3, sample_len=20),
    dict(beam_size=4, sample_len=12, length_penalty=0.5),
    dict(beam_size=5, sample_len=12, patience=2.0),
    dict(beam_size=5, sample_len=16, patience=0.5, length_penalty=1.0),
    dict(beam_size=3, sample_len=12, without_timestamps=True),
    dict(beam_size=3, sample_len=12, prompt="hello there"),
], ids=lambda o: "-".join(f"{k}{v}" for k, v in o.items()))
def test_beam_tokens_exact(pair, mel, options):
    """Beams 2-5 over two windows, patience above and below 1, the GNMT
    length penalty, no timestamps, a prompt's 8-token prefill bucket. The
    test model's beams never emit EOT, so each result comes from the final
    beams; `test_beam_finishing_tokens_exact` covers beams that end."""
    _assert_same(*_decode_both(pair, mel, **options))


@pytest.mark.parametrize("quant", ["int8", "int4", "kv_int4"])
def test_beam_with_quantization_tokens_exact(pair, mel, quant):
    """Beam search over the int8 options, every int4 option, and int4
    cross K/V alone (its K4-int4 at G = beam): the self cache, its packed
    nibbles included, is reordered along the row axis every step."""
    options = {"int8": INT8, "int4": INT4, "kv_int4": dict(kv_quant=True, kv_bits=4)}[quant]
    # avg_logprob to 1e-3 with the int4 self cache: a code on a rounding
    # boundary in one package moves by 1/7 of its head's amax in the other
    _assert_same(*_decode_both(pair, mel, beam_size=3, sample_len=12, **options),
                 logprob_tol=1e-3 if quant == "int4" else 1e-4)


@functools.lru_cache(maxsize=None)
def _eot_pair(factor: float):
    """The test model with its EOT embedding row scaled by `factor`, so that
    beams finish: random weights otherwise rank EOT too low for any beam to
    end. Factor 3 leaves finished buffers part full at max_steps (topped up
    from the final beams); factor 5 fills them before max_steps, between
    two host checks."""
    jm = JaxWhisper(JaxDims(**DIMS), seed=3)
    emb = np.asarray(jm.params["decoder"]["token_embedding"]).copy()
    emb[EOT] *= factor
    jm.params["decoder"]["token_embedding"] = jnp.asarray(emb)
    tm = wat.Whisper(wat.ModelDimensions(**DIMS))
    tm.load_state_dict(from_jax_params(jm.params))
    return jm, tm


@pytest.mark.parametrize("factor", [3.0, 5.0])
@pytest.mark.parametrize("options", [
    dict(beam_size=5, sample_len=16, patience=0.5),
    dict(beam_size=3, sample_len=16),
    dict(beam_size=4, sample_len=16, patience=2.0),
    dict(beam_size=2, sample_len=20, length_penalty=0.5),
], ids=lambda o: "-".join(f"{k}{v}" for k, v in o.items()))
def test_beam_finishing_tokens_exact(mel, factor, options):
    """Beams that emit EOT: the finished buffer, its cap (beam_size x
    patience), the top-up from the final beams, and a loop that ends between
    two host checks, where the steps up to the check must change nothing."""
    _assert_same(*_decode_both(_eot_pair(factor), mel, **options))


def test_beam_finishing_int4_tokens_exact(mel):
    """The same with every int4 option (avg_logprob to 1e-3, as above)."""
    _assert_same(*_decode_both(_eot_pair(5.0), mel, beam_size=3, sample_len=16, **INT4),
                 logprob_tol=1e-3)


def test_transcribe_batched_beam_exact(pair):
    """transcribe_batched with beam_size=3, patience 1.5 and the int8
    options over 65 s: the JAX package's segments."""
    jm, tm = pair
    rng = np.random.default_rng(1)
    t = np.arange(16000 * 65) / 16000.0
    audio = (np.clip(0.3 * np.sin(2 * np.pi * 330 * t) + 0.05 * rng.standard_normal(len(t)),
                     -1, 1) * 32767).astype(np.int16)
    kw = dict(language="en", temperature=0.0, sample_len=16, fp16=False, max_batch=2,
              beam_size=3, patience=1.5, **NO_GATE, **INT8)
    ref = jax_wat.transcribe_batched(jm, audio, kv_layout="fused", **kw)
    out = wat.transcribe_batched(tm, audio, **kw)
    assert out["text"] == ref["text"]
    assert len(out["segments"]) == len(ref["segments"]) > 0
    for s, r in zip(out["segments"], ref["segments"]):
        assert s["tokens"] == r["tokens"]
        assert (s["seek"], s["start"], s["end"]) == (r["seek"], r["start"], r["end"])
        assert s["avg_logprob"] == pytest.approx(r["avg_logprob"], abs=1e-4)


def test_sequential_transcribe_beam_exact(pair):
    """The sequential `transcribe` (seek loop, prompt threading) with
    beam_size=2 and the int8 options over 40 s: the JAX package's segments."""
    jm, tm = pair
    rng = np.random.default_rng(2)
    t = np.arange(16000 * 40) / 16000.0
    audio = (np.clip(0.3 * np.sin(2 * np.pi * 330 * t) + 0.05 * rng.standard_normal(len(t)),
                     -1, 1) * 32767).astype(np.int16)
    kw = dict(language="en", temperature=0.0, sample_len=12, fp16=False, beam_size=2,
              condition_on_previous_text=True, **NO_GATE, **INT8)
    ref = jax_wat.transcribe(jm, audio, kv_layout="fused", **kw)
    out = wat.transcribe(tm, audio, **kw)
    assert out["text"] == ref["text"]
    assert len(out["segments"]) == len(ref["segments"]) > 0
    for s, r in zip(out["segments"], ref["segments"]):
        assert s["tokens"] == r["tokens"]
        assert (s["seek"], s["start"], s["end"]) == (r["seek"], r["start"], r["end"])


def test_beam_topk_orders_ties_by_index():
    """Equal logits come out in index order, as `lax.top_k` gives them."""
    logits = torch.tensor([[0.5, 2.0, 2.0, float("-inf"), 2.0, float("-inf"), 1.0],
                           [float("-inf")] * 7])
    values, index = decoding._beam_topk(logits, 5)
    ref_v, ref_i = jax_decoding._beam_topk(jnp.asarray(logits.numpy()), 5)
    assert index.tolist() == np.asarray(ref_i).tolist() == [[1, 2, 4, 6, 0], [0, 1, 2, 3, 4]]
    assert values.tolist() == np.asarray(ref_v).tolist()


@pytest.mark.parametrize("length_penalty", [None, 0.0, 0.5, 1.0])
def test_ranker_on_degenerate_rows(length_penalty):
    """Empty candidates, equal scores, -inf scores and one-candidate groups
    rank as in the JAX package."""
    tokens = [[[], [1, 2], [3]], [[], []], [[7]], [[1, 2, 3], [4, 5, 6], [9]]]
    logprobs = [[0.0, -1.0, -0.5], [-1.0, -2.0], [-3.0], [-3.0, -3.0, -float("inf")]]
    ours = decoding.MaximumLikelihoodRanker(length_penalty).rank(tokens, logprobs)
    ref = jax_decoding.MaximumLikelihoodRanker(length_penalty).rank(tokens, logprobs)
    assert ours == ref


def _fixed_rows(n_rows: int, prefill: int, total: int, eot: int, ts_begin: int):
    """Sampled rows of every kind: EOT at the first step (an empty sample),
    at the middle, at the last slot, never; timestamps among the text."""
    rng = np.random.default_rng(n_rows)
    buf = np.zeros((n_rows, total), np.int64)
    buf[:, prefill:] = rng.integers(300, 5000, (n_rows, total - prefill))
    buf[:, prefill] = ts_begin
    for r in range(n_rows):
        end = [prefill, prefill + 3, total - 1, total][r % 4]
        buf[r, end:] = eot
    return buf, (-rng.uniform(0.5, 8.0, n_rows)).astype(np.float32), \
        rng.uniform(0, 1, n_rows).astype(np.float32)


def test_best_of_groups_and_ranks_like_jax(pair, mel, monkeypatch):
    """best_of=3 at T=0.7 over two windows, with both packages' sampling loop
    replaced by one that hands back the same rows: the token rows are
    repeated per group, and the same candidate wins in each group, with the
    same text, avg_logprob and no-speech probability."""
    jm, tm = pair
    opts = dict(language="en", fp16=False, sample_len=8, temperature=0.7, best_of=3)
    task = wat.decoding.DecodingTask(tm, wat.DecodingOptions(**opts))
    tok = task.tokenizer
    prefill = decoding._prefill_bucket(len(task.initial_tokens))
    total = prefill + 8
    fixed, sum_lp, no_speech = _fixed_rows(6, prefill, total, tok.eot, tok.timestamp_begin)
    seen = {}

    def jax_loop(dec_params, ck, cv, buf, *args, **kwargs):
        seen["jax"] = np.asarray(buf)
        rows = np.asarray(buf).copy()
        rows[:, prefill:] = fixed[:, prefill:]
        return (jnp.asarray(rows, jnp.int32), jnp.asarray(sum_lp), jnp.asarray(no_speech),
                jnp.int32(total - prefill))

    def torch_loop(params, cross, buf, **kwargs):
        seen["torch"] = buf.clone().numpy()
        rows = buf.clone()
        rows[:, prefill:] = torch.from_numpy(fixed[:, prefill:])
        return rows, torch.from_numpy(sum_lp), torch.from_numpy(no_speech), total - prefill

    monkeypatch.setattr(jax_decoding, "greedy_sample_loop", jax_loop)
    monkeypatch.setattr(decoding, "greedy_sample_loop", torch_loop)
    ref = jax_wat.decode(jm, jnp.asarray(mel), jax_wat.DecodingOptions(**opts))
    out = wat.decode(tm, torch.from_numpy(mel), wat.DecodingOptions(**opts))
    assert seen["torch"].shape == (6, total)
    assert np.array_equal(seen["torch"][:, :prefill], seen["jax"][:, :prefill])
    assert (seen["torch"][0::3] == seen["torch"][1::3]).all()
    assert (seen["torch"][0::3] == seen["torch"][2::3]).all()
    _assert_same(ref, out)
    assert [o.temperature for o in out] == [0.7, 0.7]


def test_best_of_samples_run(pair, mel):
    """best_of=3 with the port's own sampler: one result per window, each a
    group's best by length-normalised logprob."""
    _, tm = pair
    out = wat.decode(tm, torch.from_numpy(mel), wat.DecodingOptions(
        language="en", fp16=False, sample_len=8, temperature=1.0, best_of=3))
    assert len(out) == 2
    assert all(np.isfinite(o.avg_logprob) and o.temperature == 1.0 for o in out)
