"""The port's kernel modules (K1-K4) and log-mel against the JAX package.

On the CPU each wrapper runs its kernel's plain PyTorch version; the JAX
side runs its Pallas kernel in interpret mode, as the JAX package's own
tests do. Inputs come from numpy with a seed and go to both packages.
All comparisons are fp32.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_at_tpu.audio import log_mel_spectrogram as jax_log_mel
from whisper_at_tpu.models.decoder import _quantize_sym
from whisper_at_tpu.ops.cross_decode import cross_attention_int8 as jax_cross
from whisper_at_tpu.ops.flash_enc import encoder_attention as jax_enc_attention
from whisper_at_tpu.ops.kv_quant import project_quantize_kv as jax_project_quantize
from whisper_at_tpu.ops.mlp_enc import mlp_block_fused as jax_mlp_block
from whisper_at_tpu_torch.audio import log_mel_spectrogram
from whisper_at_tpu_torch.ops import cuda, enc_mlp as enc_mlp_ops
from whisper_at_tpu_torch.ops.cross_decode import cross_attention_int8, pad_bias
from whisper_at_tpu_torch.ops.enc_attention import enc_attention
from whisper_at_tpu_torch.ops.enc_mlp import enc_mlp
from whisper_at_tpu_torch.ops.kv_quant import pad_ta, project_quantize_kv, quantize_sym

pytestmark = pytest.mark.quick


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_enc_attention_matches_jax_kernel():
    """K1: T=300 pads to 384 in the JAX kernel, so its pad mask is covered."""
    rng = np.random.default_rng(11)
    b, t, h = 2, 300, 4
    q, k, v = (rng.standard_normal((b, t, h * 64)).astype(np.float32) for _ in range(3))
    ref = np.asarray(jax_enc_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h,
                                       interpret=True))
    out = enc_attention(_t(q), _t(k), _t(v), h).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=0)


def test_enc_mlp_matches_jax_kernel():
    """K2: x + fc2(gelu(fc1(LN(x)))) with a non-trivial LN and ff tiling."""
    rng = np.random.default_rng(3)
    b, t, d, f = 2, 300, 128, 512
    x = (rng.standard_normal((b, t, d)) * 0.5).astype(np.float32)
    ln_w = (1.3 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    ln_b = (0.05 * rng.standard_normal(d)).astype(np.float32)
    w1 = rng.uniform(-d ** -0.5, d ** -0.5, (d, f)).astype(np.float32)
    b1 = rng.uniform(-d ** -0.5, d ** -0.5, f).astype(np.float32)
    w2 = rng.uniform(-f ** -0.5, f ** -0.5, (f, d)).astype(np.float32)
    b2 = rng.uniform(-f ** -0.5, f ** -0.5, d).astype(np.float32)
    ref = np.asarray(jax_mlp_block(
        jnp.asarray(x), {"scale": jnp.asarray(ln_w), "bias": jnp.asarray(ln_b)},
        {"w": jnp.asarray(w1), "b": jnp.asarray(b1)},
        {"w": jnp.asarray(w2), "b": jnp.asarray(b2)},
        block_m=128, block_ff=128, interpret=True))
    out = enc_mlp(_t(x), _t(ln_w), _t(ln_b), _t(w1.T.copy()), _t(b1), _t(w2.T.copy()),
                  _t(b2)).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=0)


@pytest.mark.parametrize("m", [1, 127, 129, 1500, 3001, 36000])
@pytest.mark.parametrize("d", [384, 512, 768, 1024, 1280])
def test_enc_mlp_plan(d, m):
    """K2's GEMM plan for fc1 (N = 4D) and fc2 (N = D) at every Whisper
    width: a block width the C entry is built for that divides N; 256 only
    where its tiles still give every one of 132 SMs a block, else 128; one
    persistent block an SM, fewer only where there are fewer tiles."""
    source = open(os.path.join(cuda.CSRC, "enc_mlp.cu")).read()
    for n in (4 * d, d):
        bn, blocks = enc_mlp_ops.plan(m, n, 132)
        assert bn in enc_mlp_ops.WIDTHS and n % bn == 0
        assert f"gemm_sm90::run<{bn}>" in source
        panels = -(-m // enc_mlp_ops.BM)
        assert blocks == min(132, panels * (n // bn))
        wide_fills = n % 256 == 0 and panels * (n // 256) >= 132
        assert bn == (256 if wide_fills else 128)
    assert enc_mlp_ops.plan(36000, 5120, 132) == enc_mlp_ops.plan(36000, 1280, 132) == (256, 132)
    assert enc_mlp_ops.plan(1500, 1280, 132) == (128, 120)


@pytest.mark.parametrize("b", [1, 5, 24])
@pytest.mark.parametrize("ta", [1, 300, 1500])
@pytest.mark.parametrize("d", [384, 512, 768, 1024, 1280])
def test_kv_quant_plan(d, ta, b):
    """K3's GEMM plan (K2's rule over b * Ta_pad rows and K and V as two runs
    of D columns): a block width the C entry is built for that divides D, so
    no tile straddles K and V; 256 only where its tiles still give every one
    of 132 SMs a block, else 128; one persistent block an SM, fewer only
    where there are fewer tiles."""
    from whisper_at_tpu_torch.ops import kv_quant as kv_quant_ops

    source = open(os.path.join(cuda.CSRC, "kv_quant.cu")).read()
    bn, blocks = kv_quant_ops.plan(b, ta, d, 132)
    assert bn in enc_mlp_ops.WIDTHS and d % bn == 0
    assert f"gemm_sm90::launch<{bn}>" in source
    tiles = b * pad_ta(ta) // 128 * 2 * (d // bn)
    assert blocks == min(132, tiles)
    wide_fills = d % 256 == 0 and b * pad_ta(ta) // 128 * 2 * (d // 256) >= 132
    assert bn == (256 if wide_fills else 128)
    assert kv_quant_ops.plan(24, 1500, 1280, 132) == (256, 132)   # 2880 tiles
    assert kv_quant_ops.plan(1, 1500, 1280, 132) == (128, 132)    # 240 tiles, not 120


def test_quantize_sym_bitwise():
    """The int8 formula gives the same codes and scales as _quantize_sym on
    the same input, including exact ties and all-zero slices."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 7, 5, 64)).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[1, 2, 3, :4] = [127.0, -63.5, 0.5, -0.5]
    x[1, 2, 3, 4:] = 0.0
    ref = _quantize_sym(jnp.asarray(x), axis=-1)
    q, s = quantize_sym(_t(x), dim=-1)
    assert np.array_equal(q.numpy(), np.asarray(ref["q"]))
    assert np.array_equal(s.numpy(), np.asarray(ref["s"]))


def _kv_inputs(seed=7, b=2, ta=300, d=128):
    rng = np.random.default_rng(seed)
    xa = rng.standard_normal((b, ta, d)).astype(np.float32)
    wk, wv = (rng.uniform(-d ** -0.5, d ** -0.5, (d, d)).astype(np.float32)
              for _ in range(2))
    bv = rng.uniform(-d ** -0.5, d ** -0.5, d).astype(np.float32)
    return xa, wk, wv, bv


def test_project_quantize_kv_matches_jax_kernel():
    """K3 end to end through the projection: codes within 1 LSB on at most
    0.1% of entries, scales rel 1e-6, zero codes and scales past Ta. The JAX
    kernel's transposed layout is converted for the comparison."""
    xa, wk, wv, bv = _kv_inputs()
    b, ta, d = xa.shape
    ta_pad, h = pad_ta(ta), d // 64
    xt = np.zeros((b, d, ta_pad), np.float32)
    xt[:, :, :ta] = xa.transpose(0, 2, 1)
    jk, jks, jv, jvs = (np.asarray(a) for a in jax_project_quantize(
        jnp.asarray(xt), jnp.asarray(wk), jnp.asarray(wv), jnp.asarray(bv), h,
        ta_valid=ta, interpret=True))
    kq, ks, vq, vs = (a.numpy() for a in project_quantize_kv(
        _t(xa), _t(wk.T.copy()), _t(wv.T.copy()), _t(bv)))
    for ours, ref in ((kq, jk.transpose(0, 2, 1)), (vq, jv.transpose(0, 2, 1))):
        diff = np.abs(ours.astype(np.int32) - ref.astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
        assert not ours[:, ta:].any()
    for ours, ref in ((ks, jks), (vs, jvs)):
        np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=0)
        assert not ours[:, :, ta:].any()


@pytest.mark.parametrize("groups", [1, 4])
def test_cross_attention_int8_matches_jax_kernel(groups):
    """K4 over K3's output (one decode step, G=1, and the prefill bucket,
    G=4): the port's [B, Ta_pad, D] codes are the JAX fused layout with K
    transposed."""
    xa, wk, wv, bv = _kv_inputs(seed=9)
    b, ta, d = xa.shape
    h, ta_pad = d // 64, pad_ta(ta)
    kq, ks, vq, vs = project_quantize_kv(_t(xa), _t(wk.T.copy()), _t(wv.T.copy()), _t(bv))
    rng = np.random.default_rng(groups)
    q = (rng.standard_normal((b, h * groups, 64)) * 64 ** -0.5).astype(np.float32)
    bias = pad_bias(ta, ta_pad, "cpu")
    ref = np.asarray(jax_cross(
        jnp.asarray(q), jnp.asarray(kq.numpy().transpose(0, 2, 1)), jnp.asarray(ks.numpy()),
        jnp.asarray(vq.numpy()), jnp.asarray(vs.numpy()), jnp.asarray(bias.numpy()[None]),
        n_head=h, interpret=True))
    out = cross_attention_int8(_t(q), kq, ks, vq, vs, bias, h).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("n, padding", [(16000 * 8, 0), (480000, 0), (16000 * 8 + 7, 0),
                                        (16000 * 5, 480000)])
def test_log_mel_matches_jax(n, padding):
    """Broadband input (as the JAX package's reference differential uses),
    as float32 and as int16 PCM: 1e-5."""
    rng = np.random.default_rng(n)
    audio = (0.2 * rng.standard_normal(n)).astype(np.float32)
    for a in (audio, (audio * 32767).astype(np.int16)):
        ref = np.asarray(jax_log_mel(a, padding=padding))
        out = log_mel_spectrogram(a, padding=padding, device="cpu").numpy()
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_log_mel_tone_matches_jax():
    """A tone with little noise puts bins near cancellation, where fp32 DFT
    sums in any order differ by ~1e-4 (the JAX package holds this case to
    2e-4 against torch.stft in tests/test_audio.py)."""
    rng = np.random.default_rng(0)
    t = np.arange(16000 * 20) / 16000.0
    audio = (0.5 * np.sin(2 * np.pi * (200 + 40 * t) * t)
             + 0.01 * rng.standard_normal(len(t))).astype(np.float32)
    ref = np.asarray(jax_log_mel(audio, padding=480000))
    out = log_mel_spectrogram(audio, padding=480000, device="cpu").numpy()
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=0)


@pytest.mark.parametrize("a, h, g, ta_pad, bits, split", [
    (24, 20, 1, 1536, 8, (1, 6, 256)),   # large-v1 at batch 24: 480 blocks fill a wave
    (24, 20, 5, 1536, 8, (1, 12, 128)),  # a beam step: every row in one block
    (24, 20, 5, 1536, 4, (1, 6, 256)),
    (24, 20, 1, 1536, 4, (1, 6, 256)),
    (1, 20, 1, 1536, 8, (6, 1, 256)),    # one audio row: 120 blocks in clusters of 6
    (1, 20, 5, 1536, 8, (6, 2, 128)),
    (6, 20, 1, 1536, 8, (3, 2, 256)),
    (12, 20, 4, 1536, 8, (2, 6, 128)),
    (1, 6, 20, 1536, 8, (6, 2, 128)),    # two row slices of 16
    (3, 4, 1, 64, 8, (1, 1, 256)),       # one stage, most of it past Ta_pad
    (2, 4, 12, 300, 4, (3, 1, 128)),
])
def test_cross_decode_plan_fills_one_wave(a, h, g, ta_pad, bits, split):
    """K4's positions split into runs of ring stages, the blocks of one
    cluster: as many as one wave of blocks allows, at most 8, none empty;
    the tensor cores above one query row, stages of 256 positions up to
    WIDE_STAGES_TO's G; an H100's wave of 528 blocks."""
    from whisper_at_tpu_torch.ops import cross_decode as cd

    slots = 4 * 132
    n_split, per, tensor_cores, chunk = cd.plan(a, h, g, ta_pad, bits, slots)
    assert (n_split, per, chunk) == split
    assert tensor_cores == (g > 1)
    assert chunk == (256 if g <= cd.WIDE_STAGES_TO[bits] else 128)
    n_stages = -(-ta_pad // chunk)
    assert 1 <= n_split <= cd.MAX_SPLIT
    assert (n_split - 1) * per < n_stages <= n_split * per
    blocks = a * h * -(-g // cd.block_rows(g))
    assert blocks * n_split <= max(blocks, slots)


def test_kernels_registered_with_sources():
    """Every kernel names an existing CUDA source and the TPU kernel it
    replaces (the JAX package's ops, or the JAX streaming probe for P1 and
    P2); nothing was built or launched by the CPU tests."""
    probes = {"probe_auto": "tools/probe_dma.py:88", "probe_ring_cp": "tools/probe_dma.py:137",
              "probe_ring_tma": "tools/probe_dma.py:137"}
    assert set(cuda.KERNELS) == {"enc_attention", "enc_mlp", "enc_mlp_partial", "kv_quant",
                                 "kv_quant4", "cross_decode", "cross_decode4", "w4_matmul", "dtw",
                                 "enc_flash", "fused_mlp", "fused_mlp_int8", "flash_decode",
                                 "cross_decode_stream", "cross_decode_stream4", *probes}
    for name, kernel in cuda.KERNELS.items():
        assert kernel.library_path().endswith(".so")
        if name in probes:
            assert kernel.replaces == probes[name]
        else:
            assert kernel.replaces.startswith("whisper_at_tpu/ops/")
        assert kernel._lib is None
    for name, replaces in (("enc_flash", "flash.py:63"), ("fused_mlp", "fused_mlp.py:101"),
                           ("enc_mlp_partial", "mlp_enc.py:93"),
                           ("fused_mlp_int8", "fused_mlp.py:101"),
                           ("flash_decode", "flash_decode.py:89"),
                           ("cross_decode_stream", "cross_decode_stream.py:218"),
                           ("cross_decode_stream4", "cross_decode_stream.py:218")):
        assert cuda.KERNELS[name].replaces == "whisper_at_tpu/ops/" + replaces

