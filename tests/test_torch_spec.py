"""Speculative greedy decoding (draft and verify) in the port against the
JAX package's `spec_sample_loop` and against the port's own greedy loop.

Every case of the JAX package's speculative tests runs in fp32 through
both packages on the same seeded weights: tokens identical to the JAX spec
loop and to the port's greedy decode, sum logprobs to 1e-4 (with quantized
options, where the packages' kernels round apart, the spec loops' sums
differ as their greedy decodes' do, to 1e-4), and the same rounds and
commits as the JAX loop. The JAX side runs its quantized
verifier on its fused layout (its K4 in interpret mode at G = lookahead +
1). Also `decoder_forward_rows` against `decoder_forward`, the per-row
step of the logit filters, and the option refusals.
"""

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
from whisper_at_tpu_torch.models import decoder

DIMS = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4,
            n_audio_layer=2, n_vocab=51865, n_text_ctx=448, n_text_head=4,
            n_text_state=64, n_text_layer=2)
DRAFT_DIMS = dict(DIMS, n_audio_state=128, n_audio_head=2, n_text_state=128, n_text_head=2)
NO_GATE = dict(logprob_threshold=None, compression_ratio_threshold=None,
               no_speech_threshold=None)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These models are tiny: the port's passes run on one thread, which
    keeps the file's time steady when other test processes share the
    cores (a thread pool per process oversubscribes them)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(dims: dict, seed: int):
    jm = JaxWhisper(JaxDims(**dims), seed=seed)
    tm = wat.Whisper(wat.ModelDimensions(**dims))
    tm.load_state_dict(from_jax_params(jm.params))
    return jm, tm


@pytest.fixture(scope="module")
def model():
    return _pair(DIMS, 3)


@pytest.fixture(scope="module")
def draft():
    """Other weights and another width: random drafts rarely agree, which
    works the rejection and correction paths."""
    return _pair(DRAFT_DIMS, 21)


@pytest.fixture(scope="module")
def mel():
    return (np.random.default_rng(7).standard_normal((2, 80, 3000)) * 0.4).astype(np.float32)


def _sum_logprobs(results):
    return [r.avg_logprob * (len(r.tokens) + 1) for r in results]


def _assert_spec_matches(model, draft, mel, **opts):
    """The port's speculative decode against the JAX package's and against
    the port's greedy decode. Returns the port's spec stats."""
    (jm, tm), (jd, td) = model, draft
    opts = dict(language="en", temperature=0.0, fp16=False, **opts)
    jax_layout = {"kv_layout": "fused"} if opts.get("kv_quant") else {}
    ref = jax_wat.decode(jm, jnp.asarray(mel), jax_wat.DecodingOptions(
        draft_model=jd, **jax_layout, **opts))
    ref_stats = dict(jax_decoding._LAST_SPEC_STATS)
    out = wat.decode(tm, torch.from_numpy(mel), wat.DecodingOptions(draft_model=td, **opts))
    stats = decoding._LAST_SPEC_STATS
    greedy = wat.decode(tm, torch.from_numpy(mel), wat.DecodingOptions(**opts))
    if not isinstance(ref, list):
        ref, out, greedy = [ref], [out], [greedy]
    for r, o, g in zip(ref, out, greedy):
        assert list(o.tokens) == list(r.tokens) == list(g.tokens)
        assert o.text == r.text == g.text
        assert o.no_speech_prob == pytest.approx(r.no_speech_prob, abs=1e-6)
        assert o.no_speech_prob == pytest.approx(g.no_speech_prob, abs=1e-6)
        assert o.spec_stats == stats and g.spec_stats is None
    np.testing.assert_allclose(_sum_logprobs(out), _sum_logprobs(greedy), atol=1e-4, rtol=0)
    if jax_layout:
        # the two packages' quantized kernels round apart (JAX's greedy
        # decode and the port's differ by up to 4e-3 over 24 int4 steps);
        # the speculative loops must add nothing to that difference
        ref_greedy = jax_wat.decode(jm, jnp.asarray(mel), jax_wat.DecodingOptions(
            **jax_layout, **opts))
        ref_greedy = ref_greedy if isinstance(ref_greedy, list) else [ref_greedy]
        np.testing.assert_allclose(
            np.subtract(_sum_logprobs(out), _sum_logprobs(ref)),
            np.subtract(_sum_logprobs(greedy), _sum_logprobs(ref_greedy)), atol=1e-4, rtol=0)
    else:
        np.testing.assert_allclose(_sum_logprobs(out), _sum_logprobs(ref), atol=1e-4, rtol=0)
    assert (stats["rounds"], stats["commits"]) == (ref_stats["rounds"], ref_stats["commits"])
    assert stats["tokens_per_round"] == pytest.approx(ref_stats["tokens_per_round"])
    return stats


def test_spec_decode_matches_greedy_with_a_disagreeing_draft(model, draft, mel):
    stats = _assert_spec_matches(model, draft, mel, sample_len=32)
    assert stats["rounds"] > 1


def test_spec_decode_without_timestamps(model, draft, mel):
    _assert_spec_matches(model, draft, mel, sample_len=24, without_timestamps=True)


def test_spec_decode_with_prompt_and_prefix(model, draft, mel):
    _assert_spec_matches(model, draft, mel, sample_len=20, prompt="previous context",
                         prefix="and the")


def test_spec_decode_full_agreement_draft(model, mel):
    """The model as its own draft: every draft agrees, so each round takes
    the full lookahead and the bonus token and repairs the draft's cache."""
    stats = _assert_spec_matches(model, model, mel, sample_len=32)
    assert stats["tokens_per_round"] > 8.0


def test_spec_decode_lookahead_1(model, draft, mel):
    _assert_spec_matches(model, draft, mel, sample_len=16, draft_lookahead=1)


def test_spec_decode_rows_finish_at_different_times(model, draft):
    """Rows whose EOT lands at different steps: finished rows freeze while
    the others go on, the per-row positions at their widest spread."""
    mel4 = (np.random.default_rng(3).standard_normal((4, 80, 3000)) * 0.7).astype(np.float32)
    _assert_spec_matches(model, draft, mel4, sample_len=40)


@pytest.mark.parametrize("bits", [8, 4])
def test_spec_decode_with_a_quantized_verifier(model, draft, mel, bits):
    """Speculation over the verifier's quantized weights and cross K/V (the
    port's fused layout, its K4 entry at G = lookahead + 1 on the verify
    pass); the draft decodes on plain weights and a plain cross K/V."""
    _assert_spec_matches(model, draft, mel, sample_len=24, kv_quant=True, kv_bits=bits,
                         weight_quant=True, weight_bits=bits)


def test_spec_decode_verify_pass_reaches_k4_at_lookahead_plus_one(model, draft, mel,
                                                                  monkeypatch):
    """The verify pass hands the cross-attention L + 1 query rows a head,
    and the draft's passes on its plain cross K/V reach no kernel."""
    seen = []
    kernel = decoder.cross_attention_int8

    def recording(q, *args):
        seen.append(q.shape[1] // DIMS["n_text_head"])
        return kernel(q, *args)

    monkeypatch.setattr(decoder, "cross_attention_int8", recording)
    wat.decode(model[1], torch.from_numpy(mel), wat.DecodingOptions(
        language="en", fp16=False, sample_len=12, kv_quant=True, draft_model=draft[1],
        draft_lookahead=5))
    assert 6 in seen and set(seen) <= {6, 1, 4}


def test_spec_decode_through_the_transcribe_ladder(model, draft):
    """draft_model rides the decode options through transcribe; the ladder's
    T > 0 rungs drop it."""
    (jm, tm), (jd, td) = model, draft
    audio = (0.3 * np.random.default_rng(5).standard_normal(16000 * 6)).astype(np.float32)
    kw = dict(language="en", fp16=False, sample_len=16, verbose=None, **NO_GATE)
    base = wat.transcribe(tm, audio, temperature=0.0, **kw)
    spec = wat.transcribe(tm, audio, temperature=0.0, draft_model=td, **kw)
    ref = jax_wat.transcribe(jm, audio, temperature=0.0, draft_model=jd, **kw)
    assert spec["text"] == base["text"] == ref["text"]
    assert [s["tokens"] for s in spec["segments"]] == [s["tokens"] for s in base["segments"]] \
        == [s["tokens"] for s in ref["segments"]]
    ladder = wat.transcribe(tm, audio, draft_model=td, **kw)
    assert ladder["text"] == base["text"]


@pytest.mark.parametrize("options, match", [
    (dict(temperature=0.5), "temperature"),
    (dict(beam_size=5), "beam"),
    (dict(best_of=2, temperature=0.5), "temperature"),
    (dict(self_kv_quant=True), "self_kv_quant"),
    (dict(draft_lookahead=0), "draft_lookahead"),
    (dict(vocab=51864), "vocabulary"),
])
def test_spec_option_refusals_match_jax(model, draft, options, match):
    (jm, tm), (jd, td) = model, draft
    options = dict(options)
    if options.pop("vocab", None):
        jd, td = _pair(dict(DRAFT_DIMS, n_vocab=51864), 22)
    with pytest.raises(ValueError, match=match):
        jax_decoding.DecodingTask(jm, jax_wat.DecodingOptions(draft_model=jd, **options))
    with pytest.raises(ValueError, match=match):
        decoding.DecodingTask(tm, wat.DecodingOptions(draft_model=td, **options))


def test_decoder_forward_rows_equals_decoder_forward_at_equal_positions(model):
    """With every row at one write position, the per-row pass gives the
    uniform pass's hidden states and cache, on a prefill and on a step."""
    tm = model[1]
    params = tm.decoder_params_decode()
    gen = torch.Generator().manual_seed(0)
    feats = torch.randn(3, 1500, DIMS["n_text_state"], generator=gen)
    cross = decoder.precompute_cross_kv(params, feats, DIMS["n_text_head"])
    caches = [decoder.init_cache(2, 3, 40, DIMS["n_text_state"], torch.float32,
                                 DIMS["n_text_head"]) for _ in range(2)]
    tokens = torch.randint(0, 50000, (3, 8), generator=gen)
    pad = 2
    for write_pos, toks in ((0, tokens), (8, tokens[:, :1]), (9, tokens[:, 1:4])):
        ref = decoder.decoder_forward(params, toks, cross, caches[0], write_pos, pad,
                                      DIMS["n_text_head"])
        out = decoder.decoder_forward_rows(params, toks, cross, caches[1],
                                           torch.full((3,), write_pos), pad,
                                           DIMS["n_text_head"])
        torch.testing.assert_close(out, ref, atol=2e-5, rtol=1e-5)
        end = write_pos + toks.shape[1]
        torch.testing.assert_close(caches[1].k[:, :, :, :end], caches[0].k[:, :, :, :end],
                                   atol=2e-5, rtol=1e-5)
        torch.testing.assert_close(caches[1].v[:, :, :, :end], caches[0].v[:, :, :, :end],
                                   atol=2e-5, rtol=1e-5)
    quantized = decoder.init_cache(2, 3, 40, DIMS["n_text_state"], torch.float32,
                                   DIMS["n_text_head"], quantize=True)
    with pytest.raises(ValueError, match="plain self cache"):
        decoder.decoder_forward_rows(params, tokens, cross, quantized, torch.zeros(3), pad,
                                     DIMS["n_text_head"])


def test_logit_filters_take_a_step_per_row():
    """A [B] step gives each row what the same step as an int gives it."""
    rng = np.random.default_rng(0)
    v, ts_begin, eot = 51865, 50364, 50257
    logits = torch.from_numpy(rng.standard_normal((4, v)).astype(np.float32))
    prev1 = torch.tensor([ts_begin + 3, 10, ts_begin + 5, 11])
    prev2 = torch.tensor([12, ts_begin + 2, ts_begin + 4, 13])
    last_ts = torch.tensor([ts_begin + 3, ts_begin + 2, ts_begin + 5, -1])
    mask = torch.zeros(v)
    mask[[5, 7]] = float("-inf")
    kw = dict(eot=eot, ts_begin=ts_begin, blank_token=220, max_initial_ts_index=50,
              suppress_blank=True, with_ts_rules=True)
    steps = torch.tensor([0, 1, 2, 7])
    rows = decoding.apply_logit_filters(logits, steps, prev1, prev2, last_ts, mask, **kw)
    for i, t in enumerate(steps.tolist()):
        one = decoding.apply_logit_filters(logits, t, prev1, prev2, last_ts, mask, **kw)
        assert torch.equal(rows[i], one[i]), t
        ref = jax_decoding.apply_logit_filters(
            jnp.asarray(logits.numpy()), jnp.asarray(steps.numpy()), jnp.asarray(prev1.numpy()),
            jnp.asarray(prev2.numpy()), jnp.asarray(last_ts.numpy()),
            jnp.asarray(mask.numpy()), **kw)
        np.testing.assert_array_equal(np.isinf(np.asarray(ref[i])), torch.isinf(rows[i]).numpy())
