"""The port's int4 options against the JAX package: the packing, the int4
weights and K5, the int4 entries of K3 and K4, the int4 self cache, and
`decode` / `transcribe_batched` with each int4 option and all three.

On the CPU each kernel wrapper runs its plain PyTorch version; the JAX side
runs its Pallas kernels in interpret mode, as the JAX package's own tests
do. The JAX package packs halves of an axis and the port adjacent pairs
(`models/layers.pack4`), so payloads are compared as codes, after
unpacking. Inputs come from numpy with a seed; fp32 throughout.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisper_at_tpu as jax_wat
from whisper_at_tpu.models.decoder import _quantize_sym, _unpack_q
from whisper_at_tpu.models.decoder import decoder_forward as jax_decoder_forward
from whisper_at_tpu.models.decoder import init_cache as jax_init_cache
from whisper_at_tpu.models.decoder import precompute_cross_kv as jax_precompute_cross_kv
from whisper_at_tpu.models.dims import ModelDimensions as JaxDims
from whisper_at_tpu.models.layers import _quantize_w, pack4_last, unpack4_last
from whisper_at_tpu.models.layers import linear as jax_linear
from whisper_at_tpu.models.whisper import Whisper as JaxWhisper
from whisper_at_tpu.ops.cross_decode import cross_attention_int8 as jax_cross
from whisper_at_tpu.ops.kv_quant import project_quantize_kv as jax_project_quantize
from whisper_at_tpu.ops.w4_matmul import w4_matmul as jax_w4_matmul
import whisper_at_tpu_torch as wat
from whisper_at_tpu_torch.convert import from_jax_params
from whisper_at_tpu_torch.models.decoder import decoder_forward, init_cache, precompute_cross_kv
from whisper_at_tpu_torch.models.layers import Linear, QuantLinear4, pack4, quantize_linear, unpack4
from whisper_at_tpu_torch.ops.cross_decode import cross_attention_int4, pad_bias
from whisper_at_tpu_torch.ops.kv_quant import pad_ta, project_quantize_kv4, quantize_sym
from whisper_at_tpu_torch.ops.w4_matmul import w4_matmul, w4_matmul_plain

DIMS = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=128, n_audio_head=2,
            n_audio_layer=2, n_vocab=51865, n_text_ctx=448, n_text_head=2,
            n_text_state=128, n_text_layer=2)
NO_GATE = dict(logprob_threshold=None, compression_ratio_threshold=None,
               no_speech_threshold=None)
INT4_OPTIONS = {
    "kv": dict(kv_quant=True, kv_bits=4),
    "weights": dict(weight_quant=True, weight_bits=4),
    "self_kv": dict(self_kv_quant=True, self_kv_bits=4),
    "all": dict(kv_quant=True, kv_bits=4, weight_quant=True, weight_bits=4,
                self_kv_quant=True, self_kv_bits=4),
}


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _codes(x) -> np.ndarray:
    return np.asarray(x).astype(np.int8)


@pytest.fixture(scope="module")
def pair():
    jm = JaxWhisper(JaxDims(**DIMS), seed=3)
    tm = wat.Whisper(wat.ModelDimensions(**DIMS))
    tm.load_state_dict(from_jax_params(jm.params))
    return jm, tm


@pytest.fixture(scope="module")
def encoded(pair):
    jm, tm = pair
    mel = (np.random.default_rng(0).standard_normal((2, 80, 3000)) * 0.4).astype(np.float32)
    return (jm.embed_audio(jnp.asarray(mel), fp16=False)[0],
            tm.embed_audio(torch.from_numpy(mel), fp16=False)[0])


# ---- packing ------------------------------------------------------------ #

def test_pack4_layout_and_roundtrip():
    """Adjacent pairs along the last axis, low nibble first; every code of
    [-8, 7] survives the round trip, sign included."""
    codes = torch.tensor([[-7, 7, 0, -1, 3, -8, 5, 6]], dtype=torch.int8)
    packed = pack4(codes)
    assert packed.dtype == torch.int8 and packed.shape == (1, 4)
    expect = [(c0 & 0xF) | ((c1 & 0xF) << 4) for c0, c1 in
              zip(codes[0, 0::2].tolist(), codes[0, 1::2].tolist())]
    assert packed.view(torch.uint8)[0].tolist() == expect
    every = torch.arange(-8, 8, dtype=torch.int8).repeat(3, 2)
    assert torch.equal(unpack4(pack4(every)), every)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(-7, 8, (2, 3, 64)).astype(np.int8))
    assert torch.equal(unpack4(pack4(x)), x)


# ---- int4 weights and K5 ------------------------------------------------- #

@pytest.mark.parametrize("shape", [(64, 96), (128, 384), (512, 128)])
def test_int4_weight_codes_and_scales_bitwise(shape):
    """quantize_linear(bits=4) against JAX `_quantize_w(bits=4)`: the same
    codes after unpacking and the same scales, bit for bit."""
    n_in, n_out = shape
    rng = np.random.default_rng(n_in + n_out)
    w = rng.uniform(-n_in ** -0.5, n_in ** -0.5, (n_in, n_out)).astype(np.float32)
    w[:, 3] = 0.0                                  # an all-zero output channel
    w[5, 7] = 7 * w[:, 7].max() / 6.5              # a .5 tie after scaling
    payload, scale = _quantize_w(jnp.asarray(w), bits=4)
    lin = Linear(n_in, n_out)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T.copy()))
        lin.bias.zero_()
    q4 = quantize_linear(lin, bits=4)
    assert isinstance(q4, QuantLinear4) and q4.w_p.shape == (n_out, n_in // 2)
    assert np.array_equal(unpack4(q4.w_p).numpy(), _codes(unpack4_last(payload)).T)
    assert np.array_equal(q4.w_s.numpy(), np.asarray(scale)[0])


def test_int4_decoder_weights_match_jax(pair):
    """decoder_params_decode(weight_bits=4): every quantized linear of every
    layer has JAX's codes and scales."""
    jm, tm = pair
    jq = jm.decoder_params_decode(True, 4)["blocks"]
    tq = tm.decoder_params_decode(True, 4).blocks
    assert tm.decoder_params_decode(True, 8) is not tm.decoder_params_decode(True, 4)
    for i, blk in enumerate(tq):
        for ours, ref in ((blk.attn.qkv, jq["attn"]["qkv"]), (blk.attn.out, jq["attn"]["out"]),
                          (blk.cross_attn.query, jq["cross_attn"]["query"]),
                          (blk.cross_attn.out, jq["cross_attn"]["out"]),
                          (blk.mlp[0], jq["mlp"]["fc1"]), (blk.mlp[2], jq["mlp"]["fc2"])):
            assert isinstance(ours, QuantLinear4)
            assert np.array_equal(unpack4(ours.w_p).numpy(),
                                  _codes(unpack4_last(ref["w_q4"][i])).T)
            assert np.array_equal(ours.w_s.numpy(), np.asarray(ref["w_s"][i])[0])


@pytest.mark.parametrize("m", [1, 24, 96])
def test_w4_matmul_plain_matches_jax_kernel(m):
    """K5's plain version against the Pallas kernel in interpret mode on the
    same codes, each package in its own packing: fp32 sums of exact
    products, so only the summation order differs (atol 5e-5 at |y| <= 12,
    a few fp32 ulps)."""
    k, n = 256, 384
    rng = np.random.default_rng(m)
    x = (rng.standard_normal((m, k)) * 0.1).astype(np.float32)
    codes = rng.integers(-7, 8, (k, n)).astype(np.int8)       # [in, out]
    ref = np.asarray(jax_w4_matmul(jnp.asarray(x), pack4_last(jnp.asarray(codes)),
                                   interpret=True))
    wp = pack4(torch.from_numpy(codes.T.copy()))
    out = w4_matmul(_t(x), wp)
    assert out.dtype == torch.float32 and out.shape == (m, n)
    assert torch.equal(out, w4_matmul_plain(_t(x), wp))
    np.testing.assert_allclose(out.numpy(), ref, atol=5e-5, rtol=0)


def test_quant_linear4_matches_jax_linear():
    """QuantLinear4's forward against JAX `linear` with a "w_q4" payload
    (the XLA path on the CPU): the same rounding order, 1e-6 in fp32."""
    rng = np.random.default_rng(9)
    w = rng.uniform(-0.1, 0.1, (128, 256)).astype(np.float32)  # [in, out]
    b = rng.uniform(-0.1, 0.1, 256).astype(np.float32)
    x = rng.standard_normal((2, 5, 128)).astype(np.float32)
    payload, scale = _quantize_w(jnp.asarray(w), bits=4)
    ref = np.asarray(jax_linear({"w_q4": payload, "w_s": scale, "b": jnp.asarray(b)},
                                jnp.asarray(x)))
    lin = Linear(128, 256)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T.copy()))
        lin.bias.copy_(torch.from_numpy(b))
    out = quantize_linear(lin, bits=4)(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


# ---- K3 and K4, int4 entries --------------------------------------------- #

def test_quantize_sym_int4_bitwise():
    """quantize_sym(bits=4) gives `_quantize_sym(bits=4)`'s codes and
    scales, ties and all-zero slices included."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 7, 5, 64)).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[1, 2, 3, :4] = [7.0, -3.5, 0.5, -0.5]
    x[1, 2, 3, 4:] = 0.0
    ref = _quantize_sym(jnp.asarray(x), axis=-1, bits=4)
    q, s = quantize_sym(_t(x), dim=-1, bits=4)
    assert np.array_equal(q.numpy(), _codes(ref["q"]))
    assert np.array_equal(s.numpy(), np.asarray(ref["s"]))
    assert int(q.abs().max()) <= 7


def _kv_inputs(seed=7, b=2, ta=300, d=128):
    rng = np.random.default_rng(seed)
    xa = rng.standard_normal((b, ta, d)).astype(np.float32)
    wk, wv = (rng.uniform(-d ** -0.5, d ** -0.5, (d, d)).astype(np.float32)
              for _ in range(2))
    bv = rng.uniform(-d ** -0.5, d ** -0.5, d).astype(np.float32)
    return xa, wk, wv, bv


def test_project_quantize_kv4_matches_jax_kernel():
    """K3-int4 end to end through the projection, against the Pallas kernel
    at bits=4: codes within 1 LSB on at most 0.1% of entries (K3's rule),
    scales rel 1e-6, zero codes and scales past Ta, codes in [-7, 7]."""
    xa, wk, wv, bv = _kv_inputs()
    b, ta, d = xa.shape
    ta_pad, h = pad_ta(ta), d // 64
    xt = np.zeros((b, d, ta_pad), np.float32)
    xt[:, :, :ta] = xa.transpose(0, 2, 1)
    jk, jks, jv, jvs = (np.asarray(a) for a in jax_project_quantize(
        jnp.asarray(xt), jnp.asarray(wk), jnp.asarray(wv), jnp.asarray(bv), h,
        ta_valid=ta, bits=4, interpret=True))
    kp, ks, vp, vs = project_quantize_kv4(_t(xa), _t(wk.T.copy()), _t(wv.T.copy()), _t(bv))
    assert kp.shape == vp.shape == (b, ta_pad, d // 2)
    for ours, ref in ((unpack4(kp).numpy(), jk.transpose(0, 2, 1)),
                      (unpack4(vp).numpy(), jv.transpose(0, 2, 1))):
        diff = np.abs(ours.astype(np.int32) - ref.astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
        assert not ours[:, ta:].any() and np.abs(ours).max() <= 7
    for ours, ref in ((ks.numpy(), jks), (vs.numpy(), jvs)):
        np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=0)
        assert not ours[:, :, ta:].any()


def _halves(codes: np.ndarray, axis: int) -> np.ndarray:
    """int4 codes -> the JAX package's halves packing along `axis` (byte j:
    element j low nibble, element n/2 + j high nibble)."""
    lo, hi = np.split(codes.astype(np.int32), 2, axis=axis)
    return ((lo & 0xF) | ((hi & 0xF) << 4)).astype(np.uint8).view(np.int8)


@pytest.mark.parametrize("groups", [1, 4, 5])
def test_cross_attention_int4_matches_jax_kernel(groups):
    """K4-int4 over K3-int4's output (a decode step, the prefill bucket and
    a beam-5 step) against the Pallas kernel at bits=4, whose Ta-halves
    packing is made from the same codes: atol 1e-5, as the int8 test."""
    xa, wk, wv, bv = _kv_inputs(seed=9)
    b, ta, d = xa.shape
    h, ta_pad = d // 64, pad_ta(ta)
    kp, ks, vp, vs = project_quantize_kv4(_t(xa), _t(wk.T.copy()), _t(wv.T.copy()), _t(bv))
    kc, vc = unpack4(kp).numpy(), unpack4(vp).numpy()          # [B, Ta_pad, D]
    rng = np.random.default_rng(groups)
    q = (rng.standard_normal((b, h * groups, 64)) * 64 ** -0.5).astype(np.float32)
    bias = pad_bias(ta, ta_pad, "cpu")
    ref = np.asarray(jax_cross(
        jnp.asarray(q), jnp.asarray(_halves(kc.transpose(0, 2, 1), axis=2)),
        jnp.asarray(ks.numpy()), jnp.asarray(_halves(vc, axis=1)), jnp.asarray(vs.numpy()),
        jnp.asarray(bias.numpy()[None]), n_head=h, interpret=True, bits=4))
    out = cross_attention_int4(_t(q), kp, ks, vp, vs, bias, h).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_cross_kv_int4_artifacts(pair, encoded):
    """precompute_cross_kv(bits=4) against the JAX fused int4 layout: codes
    within 1 LSB on <= 0.1% of entries, the same pad bias, scales rel 4e-6
    (the two packages sum the fp32 projection in different orders, which
    moves a slice's amax by a few ulps)."""
    jm, tm = pair
    jx, tx = encoded
    jk, jv = jax_precompute_cross_kv(jm.decoder_params_fused, jx, 2, jnp.float32,
                                     quantize=True, layout="fused", bits=4)
    cross = precompute_cross_kv(tm.decoder_params_decode(False), tx, 2, torch.float32,
                                quantize=True, bits=4)
    assert cross.bits == 4 and cross.k.shape == (2, 2, 1536, 64)
    half = 1536 // 2
    for ours, ref, axis in ((cross.k, jk["q4"], -1), (cross.v, jv["q4"], 2)):
        p32 = np.asarray(ref).astype(np.int32)
        # the JAX Ta-halves bytes back to codes in natural order
        codes = np.concatenate([(p32 << 28) >> 28, p32 >> 4], axis=axis)
        if axis == -1:
            codes = codes.transpose(0, 1, 3, 2)                # K: [L, A, D, Ta]
        assert codes.shape[2] == 2 * half
        diff = np.abs(unpack4(ours).numpy().astype(np.int32) - codes)
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    np.testing.assert_allclose(cross.k_scale.numpy(), np.asarray(jk["s"]), rtol=4e-6, atol=0)
    np.testing.assert_allclose(cross.v_scale.numpy(), np.asarray(jv["s"]), rtol=4e-6, atol=0)
    assert np.array_equal(cross.bias.numpy(), np.asarray(jk["m"])[0, 0])


# ---- the int4 self cache ------------------------------------------------- #

@pytest.mark.parametrize("kv_bits", [8, 4])
def test_int4_self_cache_through_decoder_forward(pair, encoded, kv_bits):
    """decoder_forward with the int4 self cache: a prefill of 4 tokens,
    then one step written at slot 4, each against the JAX package's int4
    cache on the same weights; hidden states to 2e-4 and the written codes,
    unpacked, within 1 LSB on <= 0.1% (a projection on a rounding
    boundary), scales rel 1e-5 (the second layer's projections differ by
    fp32 summation order, a few ulps, in the two packages)."""
    jm, tm = pair
    jx, tx = encoded
    rng = np.random.default_rng(41)
    jp, tp = jm.decoder_params_fused, tm.decoder_params_decode(False)
    jk, jv = jax_precompute_cross_kv(jp, jx, 2, jnp.float32, quantize=True, layout="fused",
                                     bits=kv_bits)
    cross = precompute_cross_kv(tp, tx, 2, torch.float32, quantize=True, bits=kv_bits)
    jsk, jsv = jax_init_cache(2, 2, 16, 128, jnp.float32, 2, quantize=True, bits=4)
    cache = init_cache(2, 2, 16, 128, torch.float32, 2, quantize=True, bits=4)
    assert cache.bits == 4 and cache.k.shape == (2, 2, 2, 16, 32)
    for tokens, pos in ((rng.integers(0, 1000, (2, 4)), 0), (rng.integers(0, 1000, (2, 1)), 4)):
        jh, jsk, jsv = jax_decoder_forward(jp, jnp.asarray(tokens, jnp.int32), jk, jv, jsk, jsv,
                                           jnp.int32(pos), jnp.int32(0), 2, jnp.float32)
        th = decoder_forward(tp, torch.from_numpy(tokens), cross, cache, pos, 0, 2,
                             torch.float32)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=2e-4, rtol=0)
    for ours, scales, ref in ((cache.k, cache.k_scale, jsk), (cache.v, cache.v_scale, jsv)):
        codes = _codes(_unpack_q({"q4": ref["q4"]}))
        diff = np.abs(unpack4(ours).numpy().astype(np.int32) - codes)
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
        assert not unpack4(ours)[:, :, :, 5:].any()
        np.testing.assert_allclose(scales.numpy(), np.asarray(ref["s"]), rtol=1e-5, atol=0)


# ---- decode and transcribe_batched, token for token ----------------------- #

@pytest.mark.parametrize("name", list(INT4_OPTIONS))
def test_decode_int4_tokens_exact(pair, name):
    """decode() on two windows with each int4 option and all three; the JAX
    side on its fused layout (K4 in interpret mode). fp32: the same tokens
    and text, avg_logprob to 1e-4."""
    jm, tm = pair
    mel = (np.random.default_rng(7).standard_normal((2, 80, 3000)) * 0.4).astype(np.float32)
    opts = dict(language="en", fp16=False, sample_len=16, **INT4_OPTIONS[name])
    ref = jax_wat.decode(jm, jnp.asarray(mel), jax_wat.DecodingOptions(kv_layout="fused", **opts))
    out = wat.decode(tm, torch.from_numpy(mel), wat.DecodingOptions(**opts))
    for r, o in zip(ref, out):
        assert o.tokens == r.tokens
        assert o.text == r.text
        assert o.avg_logprob == pytest.approx(r.avg_logprob, abs=1e-4)
        assert o.no_speech_prob == pytest.approx(r.no_speech_prob, abs=1e-6)


def test_transcribe_batched_all_int4_exact(pair):
    """transcribe_batched over 65 s (three windows) with every int4 option:
    the JAX package's segments, tokens and text. avg_logprob to 1e-3: at
    +-7 levels a self-cache code on a rounding boundary in one package moves
    by 1/7 of its head's amax in the other, and the logprob sums follow."""
    jm, tm = pair
    rng = np.random.default_rng(1)
    t = np.arange(16000 * 65) / 16000.0
    audio = (np.clip(0.3 * np.sin(2 * np.pi * 330 * t) + 0.05 * rng.standard_normal(len(t)),
                     -1, 1) * 32767).astype(np.int16)
    kw = dict(language="en", temperature=0.0, sample_len=24, fp16=False, max_batch=2,
              **NO_GATE, **INT4_OPTIONS["all"])
    ref = jax_wat.transcribe_batched(jm, audio, kv_layout="fused", **kw)
    out = wat.transcribe_batched(tm, audio, **kw)
    assert out["text"] == ref["text"]
    assert len(out["segments"]) == len(ref["segments"]) > 0
    for s, r in zip(out["segments"], ref["segments"]):
        assert s["tokens"] == r["tokens"]
        assert (s["seek"], s["start"], s["end"]) == (r["seek"], r["start"], r["end"])
        assert s["avg_logprob"] == pytest.approx(r["avg_logprob"], abs=1e-3)
    np.testing.assert_allclose(out["audio_tag"], ref["audio_tag"], atol=1e-4, rtol=0)
