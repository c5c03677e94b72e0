"""The port's model modules against the JAX package on the same weights.

A small JAX model (2 layers, width 128, 2 heads) is converted with
`convert.from_jax_params`; inputs come from numpy with a seed. fp32
throughout, tolerances from the JAX package's own reference pins.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_at_tpu.models.decoder import (
    decoder_forward as jax_decoder_forward,
    init_cache as jax_init_cache,
    precompute_cross_kv as jax_precompute_cross_kv,
)
from whisper_at_tpu.models.dims import ModelDimensions as JaxDims
from whisper_at_tpu.models.whisper import Whisper as JaxWhisper
from whisper_at_tpu_torch.convert import from_jax_params
from whisper_at_tpu_torch.models.decoder import decoder_forward, init_cache, precompute_cross_kv
from whisper_at_tpu_torch.models.dims import ModelDimensions, dims_for
from whisper_at_tpu_torch.models.whisper import Whisper

pytestmark = pytest.mark.quick

DIMS = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=128, n_audio_head=2,
            n_audio_layer=2, n_vocab=51865, n_text_ctx=448, n_text_head=2,
            n_text_state=128, n_text_layer=2)


def _pair(low: bool = False, seed: int = 3):
    jm = JaxWhisper(JaxDims(**DIMS), at_low_compute=low, seed=seed)
    tm = Whisper(ModelDimensions(**DIMS), at_low_compute=low)
    tm.load_state_dict(from_jax_params(jm.params))
    return jm, tm


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.fixture(scope="module")
def mel():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((2, 80, 3000)) * 0.4).astype(np.float32)


@pytest.fixture(scope="module")
def encoded(pair, mel):
    jm, tm = pair
    return jm.embed_audio(jnp.asarray(mel), fp16=False), tm.embed_audio(
        torch.from_numpy(mel), fp16=False)


def test_state_dict_covers_every_parameter(pair):
    """The converter fills every port parameter (strict load) with the
    reference checkpoint names."""
    _, tm = pair
    names = set(tm.state_dict())
    assert "encoder.blocks.1.mlp.2.weight" in names
    assert "decoder.blocks.0.cross_attn.key.weight" in names
    assert "at_model.mlp_layer.1.bias" in names
    assert tm.encoder.conv1.weight.shape == (128, 80, 3)


def test_encoder_features_and_taps(encoded):
    (jx, jtaps), (tx, ttaps) = encoded
    assert ttaps.shape == (2, 2, 75, 128)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=2e-5, rtol=0)
    np.testing.assert_allclose(ttaps.numpy(), np.asarray(jtaps), atol=2e-5, rtol=0)


@pytest.mark.parametrize("res", [10, 2])
def test_tltr_logits(pair, encoded, res):
    jm, tm = pair
    (_, jtaps), (_, ttaps) = encoded
    ref = np.asarray(jm.at_forward(jtaps, res))
    out = tm.at_forward(ttaps, res).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def test_tltr_low_compute_logits(encoded):
    jm, tm = _pair(low=True, seed=4)
    (_, jtaps), (_, ttaps) = encoded
    ref = np.asarray(jm.at_forward(jtaps, 10))
    np.testing.assert_allclose(tm.at_forward(ttaps, 10).numpy(), ref, atol=1e-4, rtol=0)


def test_int8_decoder_weights_bitwise(pair):
    """fuse + quantize_decoder_blocks: the same int8 codes; the scales agree
    to one fp32 ulp (jitted on the CPU, XLA computes amax / 127 + 1e-12 as
    one fused multiply-add with the reciprocal)."""
    jm, tm = pair
    jq = jm.decoder_params_decode(True)["blocks"]
    tq = tm.decoder_params_decode(True).blocks
    for i, blk in enumerate(tq):
        for ours, ref in ((blk.attn.qkv, jq["attn"]["qkv"]), (blk.attn.out, jq["attn"]["out"]),
                          (blk.cross_attn.query, jq["cross_attn"]["query"]),
                          (blk.mlp[0], jq["mlp"]["fc1"]), (blk.mlp[2], jq["mlp"]["fc2"])):
            assert np.array_equal(ours.w_q.numpy(), np.asarray(ref["w_q"][i]).T)
            np.testing.assert_allclose(ours.w_s.numpy(), np.asarray(ref["w_s"][i])[0],
                                       rtol=2.4e-7, atol=0)


def test_cross_kv_int8_artifacts(pair, encoded):
    """precompute_cross_kv (K3 per layer) against the JAX fused int8 layout:
    codes within 1 LSB on <= 0.1% of entries, scales rel 1e-6, same pad bias."""
    jm, tm = pair
    (jx, _), (tx, _) = encoded
    jk, jv = jax_precompute_cross_kv(jm.decoder_params_fused, jx, 2, jnp.float32,
                                     quantize=True, layout="fused")
    cross = precompute_cross_kv(tm.decoder_params_decode(False), tx, 2, torch.float32,
                                quantize=True)
    for ours, ref in ((cross.k.numpy(), np.asarray(jk["q"]).transpose(0, 1, 3, 2)),
                      (cross.v.numpy(), np.asarray(jv["q"]))):
        diff = np.abs(ours.astype(np.int32) - ref.astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    np.testing.assert_allclose(cross.k_scale.numpy(), np.asarray(jk["s"]), rtol=1e-6, atol=0)
    np.testing.assert_allclose(cross.v_scale.numpy(), np.asarray(jv["s"]), rtol=1e-6, atol=0)
    assert np.array_equal(cross.bias.numpy(), np.asarray(jk["m"])[0, 0])


def _decoder_both(pair, encoded, tokens, group, write_pos, int8_weights_and_cache):
    jm, tm = pair
    (jx, _), (tx, _) = encoded
    b = tokens.shape[0]
    q = int8_weights_and_cache
    jp = jm.decoder_params_decode(q)
    jk, jv = jax_precompute_cross_kv(jp, jx, 2, jnp.float32, quantize=True, layout="fused")
    jsk, jsv = jax_init_cache(2, b, 96, 128, jnp.float32, 2, quantize=q)
    jh, _, _ = jax_decoder_forward(jp, jnp.asarray(tokens, jnp.int32), jk, jv, jsk, jsv,
                                   jnp.int32(write_pos), jnp.int32(0), 2, jnp.float32,
                                   group=group)
    tp = tm.decoder_params_decode(q)
    cross = precompute_cross_kv(tp, tx, 2, torch.float32, quantize=True)
    cache = init_cache(2, b, 96, 128, torch.float32, 2, quantize=q)
    th = decoder_forward(tp, torch.from_numpy(tokens), cross, cache, write_pos, 0, 2,
                         torch.float32, group=group)
    return th.numpy(), np.asarray(jh)


@pytest.mark.parametrize("tokens_shape, group", [((2, 4), 1), ((2, 1), 1), ((6, 1), 3),
                                                 ((2, 70), 1)])
def test_decoder_int8_cross_kv(pair, encoded, tokens_shape, group):
    """decoder_forward over int8 cross K/V: the prefill bucket and a decode
    step (K4 path), beams folded into the query axis (K4 with G=3), and a
    wide prefill (einsum path, H x S > 256); 2e-4 as the JAX package holds
    its own fused layout to."""
    rng = np.random.default_rng(tokens_shape[0] * 100 + tokens_shape[1])
    tokens = rng.integers(0, 1000, tokens_shape)
    write_pos = 3 if tokens_shape[1] == 1 else 0
    out, ref = _decoder_both(pair, encoded, tokens, group, write_pos, False)
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=0)


def test_decoder_all_int8(pair, encoded):
    """With int8 weights and the int8 self cache on as well, a projection
    that lands on a rounding boundary in one package flips one self-cache
    code (1 LSB = amax / 127 of its head) in the other; the hidden states
    then differ by up to ~1e-3 at unit scale, on a minority of entries."""
    tokens = np.random.default_rng(204).integers(0, 1000, (2, 4))
    out, ref = _decoder_both(pair, encoded, tokens, 1, 0, True)
    diff = np.abs(out - ref)
    assert diff.max() < 2e-3 and (diff > 2e-4).mean() < 0.2


def test_full_logits(pair, encoded):
    jm, tm = pair
    (jx, _), (tx, _) = encoded
    toks = np.asarray([[50258, 50259, 50359, 50364, 400, 500]] * 2)
    ref = np.asarray(jm.logits(jnp.asarray(toks, jnp.int32), jx, fp16=False))
    out = tm.logits(torch.from_numpy(toks), tx, fp16=False).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=0)


def test_dims_table():
    d = dims_for("large-v1")
    assert (d.n_audio_state, d.n_audio_head, d.n_audio_layer, d.n_vocab) == (1280, 20, 32, 51865)
    assert dims_for("tiny.en").n_vocab == 51864
    with pytest.raises(ValueError):
        dims_for("huge")
