"""K10 (streamed cross decode) and K9 (split-S flash decode) against the JAX
package's Pallas kernels, and the CROSS_DECODE switch of the port's decoder.

On the CPU each wrapper runs its kernel's plain PyTorch version; the JAX
side runs its Pallas kernel in interpret mode, as the JAX package's own
tests do. Inputs come from numpy with a seed and go to both packages, with
the layouts converted here: the JAX K10 takes K transposed and int4 packed
in Ta halves, the JAX K9 takes [BH, 64, S] / [BH, S, 64] codes; the port's
kernels take K3's row-major layout (int4 packed by `pack4`). fp32.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_cross_stream import _make_inputs
from whisper_at_tpu.models.decoder import _quantize_sym
from whisper_at_tpu.ops.cross_decode_stream import cross_attention_int8_stream as jax_stream
from whisper_at_tpu.ops.flash_decode import flash_decode_cross as jax_flash_decode
from whisper_at_tpu_torch.models import decoder
from whisper_at_tpu_torch.models.layers import pack4
from whisper_at_tpu_torch.ops import cross_decode
from whisper_at_tpu_torch.ops.cross_decode_stream import (
    cross_attention_stream,
    cross_attention_stream4,
)
from whisper_at_tpu_torch.ops.flash_decode import flash_decode_cross

pytestmark = pytest.mark.quick


def _t(x):
    return torch.from_numpy(np.array(x))


def _from_halves(p: np.ndarray, axis: int) -> np.ndarray:
    """The JAX package's Ta-halves int4 packing -> codes (low nibbles are
    the first half of the axis, high nibbles the second)."""
    p32 = p.astype(np.int32)
    return np.concatenate([(p32 << 28) >> 28, p32 >> 4], axis=axis).astype(np.int8)


def _exact(q, k, ks, v, vs, bias, n_head):
    """K4's function in float64 on row-major codes [B, Ta_pad, H*64]."""
    b, hg, dh = q.shape
    qh = q.astype(np.float64).reshape(b, n_head, hg // n_head, dh)
    kh = k.astype(np.float64).reshape(b, -1, n_head, dh).transpose(0, 2, 3, 1)
    logits = qh @ kh * ks[:, :, None, :] + bias
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    vh = v.astype(np.float64).reshape(b, -1, n_head, dh).transpose(0, 2, 1, 3)
    return ((p * vs[:, :, None, :]) @ vh).reshape(b, hg, dh)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("groups", [1, 3])
def test_stream_matches_jax_kernel(bits, groups):
    """K10 against the JAX stream kernel (its default ring) on
    test_cross_stream.py's inputs (Ta = 200 of 256, head width 64, codes
    over the whole int8 / int4 range), at that test's tolerance (rtol and
    atol 2e-5) widened by the JAX kernel's own fp32 error on these inputs,
    measured against a float64 evaluation. That error is near 0 but for
    int4 at G = 1 (1.2e-4): logits of ~180 a few units apart make the
    output sensitive to the fp32 summation order of q . k, which the two
    packages take differently. The port must also be no farther from the
    float64 result than the JAX kernel is, within 2e-5."""
    h, dh = 4, 64
    args = _make_inputs(np.random.default_rng(5), 2, h, dh, 200, groups, bits)
    want = np.asarray(jax_stream(*args, n_head=h, interpret=True, bits=bits))
    q, k, ks, v, vs, bias = (np.asarray(a) for a in args)
    if bits == 4:
        k, v = _from_halves(k, -1), _from_halves(v, 1)
    k = k.transpose(0, 2, 1)                       # [B, Ta_pad, H*64] codes
    kq, vq = _t(k), _t(v)
    if bits == 4:
        got = cross_attention_stream4(_t(q), pack4(kq), _t(ks), pack4(vq), _t(vs),
                                      _t(bias[0]), h)
    else:
        got = cross_attention_stream(_t(q), kq, _t(ks), vq, _t(vs), _t(bias[0]), h)
    exact = _exact(q, k, ks, v, vs, bias[0], h)
    jax_err = float(np.abs(want - exact).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5 + jax_err)
    assert float(np.abs(got.numpy() - exact).max()) <= jax_err + 2e-5


def test_stream_plain_equals_k4_plain_in_fp32():
    """In fp32 the online softmax is K4's softmax up to rounding: the same
    function over the same codes, held to 2e-5 relative."""
    h, dh = 4, 64
    args = _make_inputs(np.random.default_rng(6), 3, h, dh, 300, 2, 8)
    q, k, ks, v, vs, bias = (np.asarray(a) for a in args)
    inputs = (_t(q), _t(k.transpose(0, 2, 1)), _t(ks), _t(v), _t(vs), _t(bias[0]), h)
    got = cross_attention_stream(*inputs).numpy()
    want = cross_decode.cross_attention_int8(*inputs).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5 * np.abs(want).max())


@pytest.mark.parametrize("a, h, g, ta_pad, split", [
    (24, 20, 1, 1536, (1, 12)),   # large-v1 at batch 24: 480 blocks fill a wave
    (1, 20, 1, 1536, (12, 1)),    # one audio row: every stage a block of its own
    (24, 20, 12, 1536, (1, 12)),  # two row slices of 8
    (2, 4, 1, 192, (2, 1)),       # a last stage of 64 positions
    (6, 20, 1, 1536, (4, 3)),
])
def test_stream_splits_fill_one_wave(a, h, g, ta_pad, split):
    """K10's positions split into runs of 128-position stages, as many as
    one wave of blocks allows, none empty; the kernel and its plain version
    both take the split from here."""
    from whisper_at_tpu_torch.ops.cross_decode_stream import splits

    n_split, per = splits(a, h, g, ta_pad)
    assert (n_split, per) == split
    n_stages = -(-ta_pad // 128)
    assert (n_split - 1) * per < n_stages <= n_split * per


@pytest.mark.parametrize("a, ta, ta_pad", [(1, 150, 192), (2, 300, 320), (3, 1, 64)])
def test_stream_plain_equals_k4_plain_at_a_half_stage(a, ta, ta_pad):
    """Ta_pad a multiple of 64 but not of the kernel's 128-position stage:
    the tail past Ta_pad weighs nothing, and in fp32 the split online
    softmax is K4's softmax up to rounding (2e-5 relative)."""
    rng = np.random.default_rng(ta)
    h, dh, g = 4, 64, 3
    q = rng.standard_normal((a, h * g, dh)).astype(np.float32)
    kq, vq = (rng.integers(-127, 128, (a, ta_pad, h * dh)).astype(np.int8) for _ in range(2))
    ks, vs = (np.abs(rng.standard_normal((a, h, ta_pad))).astype(np.float32) * 0.02
              for _ in range(2))
    inputs = (_t(q), _t(kq), _t(ks), _t(vq), _t(vs),
              cross_decode.pad_bias(ta, ta_pad, "cpu"), h)
    got = cross_attention_stream(*inputs).numpy()
    want = cross_decode.cross_attention_int8(*inputs).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5 * np.abs(want).max())


@pytest.mark.parametrize("a, s, split", [(24, 1500, (1, 12)), (1, 1500, (6, 2)),
                                         (1, 1, (1, 1)), (1, 129, (2, 1)), (2, 2048, (8, 2)),
                                         (5, 700, (3, 2)), (26, 1500, (1, 12))])
def test_flash_decode_plan_fills_one_wave(a, s, split):
    """K9's split of the positions: one run a (head, audio row) block at
    batch 24 (480 blocks in one 528-block wave), six of two stages at one
    audio row; no run is empty and the runs cover every stage."""
    from whisper_at_tpu_torch.ops.flash_decode import CHUNK, MAX_SPLIT, plan

    n_split, per = plan(a, 20, s, 528)
    assert (n_split, per) == split
    n_stages = -(-s // CHUNK)
    assert 1 <= n_split <= MAX_SPLIT and (n_split - 1) * per < n_stages <= n_split * per


@pytest.mark.parametrize("name", ["CHUNK", "MAX_SPLIT", "BLOCKS_PER_SM"])
def test_flash_decode_plan_constants_are_its_kernels(name):
    """The stage length, the cluster's largest size and the blocks an SM
    that K9's `plan` counts on are the ones csrc/flash_decode.cu declares."""
    from whisper_at_tpu_torch.ops import flash_decode

    source = os.path.join(os.path.dirname(flash_decode.__file__), os.pardir, "csrc",
                          "flash_decode.cu")
    with open(source) as f:
        found = re.findall(rf"constexpr int {name} = (\d+);", f.read())
    assert [int(v) for v in found] == [getattr(flash_decode, name)]


def test_flash_decode_matches_jax_kernel():
    """K9 against the JAX kernel at bh = 32, s = 700 (700 % 512 != 0: the
    tail is masked), at the JAX test's tolerance (atol 2e-5). The JAX
    layout ([BH, 64, S] K, [BH, S, 64] V, [BH, 1, S] scales) is converted to
    K3's ([A, S, H*64], [A, H, S]) with 4 heads a row."""
    rng = np.random.default_rng(1)
    bh, dh, s, h = 32, 64, 700, 4
    q = rng.standard_normal((bh, dh)).astype(np.float32)
    k = rng.standard_normal((bh, dh, s)).astype(np.float32)
    v = rng.standard_normal((bh, s, dh)).astype(np.float32)
    kq = _quantize_sym(jnp.asarray(k), axis=-2)
    vq = _quantize_sym(jnp.asarray(v), axis=-1)
    vs_t = vq["s"][:, :, 0][:, None, :]
    want = np.asarray(jax_flash_decode(jnp.asarray(q), kq["q"], kq["s"], vq["q"], vs_t,
                                       interpret=True))
    a = bh // h
    k_rows = np.asarray(kq["q"]).reshape(a, h, dh, s).transpose(0, 3, 1, 2).reshape(a, s, h * dh)
    v_rows = np.asarray(vq["q"]).reshape(a, h, s, dh).transpose(0, 2, 1, 3).reshape(a, s, h * dh)
    ks = np.asarray(kq["s"]).reshape(a, h, s)
    vs = np.asarray(vs_t).reshape(a, h, s)
    got = flash_decode_cross(_t(q), _t(k_rows), _t(ks), _t(v_rows), _t(vs), h).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)
    # positions >= s are masked: K3's padding (to 768 here) changes nothing
    rows, scales = ((0, 0), (0, 68), (0, 0)), ((0, 0), (0, 0), (0, 68))
    got_pad = flash_decode_cross(_t(q), _t(np.pad(k_rows, rows)), _t(np.pad(ks, scales)),
                                 _t(np.pad(v_rows, rows)), _t(np.pad(vs, scales)), h,
                                 s=s).numpy()
    np.testing.assert_allclose(got_pad, got, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("value, streamed", [("", False), ("stream", True)])
def test_cross_decode_switch(monkeypatch, value, streamed):
    monkeypatch.setenv(decoder.CROSS_DECODE_ENV, value)
    assert decoder.cross_decode_streamed() is streamed


def test_cross_decode_switch_rejects_unknown(monkeypatch):
    monkeypatch.setenv(decoder.CROSS_DECODE_ENV, "ring")
    with pytest.raises(ValueError, match="ring"):
        decoder.cross_decode_streamed()

