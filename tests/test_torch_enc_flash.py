"""K7 (flash encoder attention) and the encoder's implementation switches
against the JAX package.

JAX's flash-attention kernel for the TPU has no interpret mode, so K7's
plain version is held against the function it computes, the JAX package's
`models/layers.attention`, in fp32 at 2e-5: at T = 1500 (padded to 1536)
and at T = 300 (padded to 512). The encoder is held against the JAX
encoder on the same weights with each attention ("single", "flash", "xla")
and MLP ("fused", "xla") implementation. Inputs come from numpy with a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_at_tpu.models.dims import ModelDimensions as JaxDims
from whisper_at_tpu.models.layers import attention as jax_attention
from whisper_at_tpu.models.whisper import Whisper as JaxWhisper
import whisper_at_tpu_torch as wat
from whisper_at_tpu_torch.convert import from_jax_params
from whisper_at_tpu_torch.models import encoder
from whisper_at_tpu_torch.models.encoder import encoder_apply
from whisper_at_tpu_torch.ops import enc_flash

pytestmark = pytest.mark.quick

DIMS = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=128, n_audio_head=2,
            n_audio_layer=2, n_vocab=51865, n_text_ctx=448, n_text_head=2,
            n_text_state=128, n_text_layer=2)


@pytest.mark.parametrize("t", [1500, 300])
def test_enc_flash_plain_matches_jax_attention(t):
    rng = np.random.default_rng(t)
    b, h = 2, 4
    q, k, v = (rng.standard_normal((b, t, h * 64)).astype(np.float32) for _ in range(3))
    want = np.asarray(jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h)[0])
    got = enc_flash.enc_flash(*(torch.from_numpy(x) for x in (q, k, v)), h).numpy()
    assert got.shape == (b, t, h * 64)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_enc_flash_plain_rounds_p_before_the_value_product():
    """In bf16 the flash formulation rounds the unnormalized P (not the
    normalized weights) and normalizes in fp32: the plain version does the
    same, so it differs from the one-pass attention by bf16 rounding only
    (2^-6 of the largest output)."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 200, 128)).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    got = enc_flash.enc_flash(q, k, v, 2).float()
    want = wat.models.layers.attention(q, k, v, 2).float()
    assert 0 < float((got - want).abs().max()) <= 2 ** -6 * float(want.abs().max())


@pytest.fixture(scope="module")
def pair():
    jm = JaxWhisper(JaxDims(**DIMS), seed=3)
    tm = wat.Whisper(wat.ModelDimensions(**DIMS))
    tm.load_state_dict(from_jax_params(jm.params))
    mel = (np.random.default_rng(0).standard_normal((2, 80, 3000)) * 0.4).astype(np.float32)
    return jm, tm, mel, jm.embed_audio(jnp.asarray(mel), fp16=False)


@pytest.mark.parametrize("attn_impl", ["single", "flash", "xla"])
@pytest.mark.parametrize("mlp_impl", ["fused", "xla"])
def test_encoder_impls_match_jax(pair, attn_impl, mlp_impl):
    """Features and taps of every implementation pair against the JAX
    encoder (fp32, 2e-5 as the port's encoder test)."""
    _, tm, mel, (jx, jtaps) = pair
    x, taps = encoder_apply(tm.encoder, torch.from_numpy(mel), 2, attn_impl=attn_impl,
                            mlp_impl=mlp_impl)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=2e-5, rtol=0)
    np.testing.assert_allclose(taps.numpy(), np.asarray(jtaps), atol=2e-5, rtol=0)


@pytest.mark.parametrize("value, site", [("", "enc_attention"), ("single", "enc_attention"),
                                         ("flash", "enc_flash"), ("xla", "attention")])
def test_embed_audio_reads_enc_attn_per_call(pair, monkeypatch, value, site):
    """WHISPER_AT_TPU_ENC_ATTN picks the attention on every embed_audio call."""
    _, tm, mel, _ = pair
    calls = []
    original = getattr(encoder, site)
    monkeypatch.setattr(encoder, site, lambda *a: calls.append(1) or original(*a))
    if value:
        monkeypatch.setenv("WHISPER_AT_TPU_ENC_ATTN", value)
    else:
        monkeypatch.delenv("WHISPER_AT_TPU_ENC_ATTN", raising=False)
    tm.embed_audio(torch.from_numpy(mel[:1]), fp16=False)
    assert len(calls) == DIMS["n_audio_layer"]


def test_embed_audio_reads_enc_mlp_per_call(pair, monkeypatch):
    _, tm, mel, _ = pair
    calls = []
    monkeypatch.setattr(encoder, "enc_mlp", lambda *a: calls.append(1))
    monkeypatch.setenv("WHISPER_AT_TPU_ENC_MLP", "xla")
    tm.embed_audio(torch.from_numpy(mel[:1]), fp16=False)
    assert not calls


@pytest.mark.parametrize("env", ["WHISPER_AT_TPU_ENC_ATTN", "WHISPER_AT_TPU_ENC_MLP"])
def test_embed_audio_rejects_unknown_impl(pair, monkeypatch, env):
    _, tm, mel, _ = pair
    monkeypatch.setenv(env, "pallas")
    with pytest.raises(ValueError, match="pallas"):
        tm.embed_audio(torch.from_numpy(mel[:1]), fp16=False)

