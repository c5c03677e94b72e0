"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and the CUDA toolkit (nvcc); without a
card they skip. Run them on the card with `pytest -m cuda
tests/test_torch_cuda.py`. `chip_smoke.py` makes the same comparisons at
the full headline shapes. Tolerances are bf16-level: the kernels and the
plain versions round at different points; the DTW trace (K6) is exact.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _randn(gen, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)


def _close(out, ref, rel=2 ** -6):
    err = float((out.float() - ref.float()).abs().max())
    assert err <= 1e-3 + rel * float(ref.float().abs().max()), err


def test_enc_attention_kernel(dev):
    from whisper_at_tpu_torch.ops.enc_attention import enc_attention, enc_attention_plain

    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (_randn(gen, 2, 300, 256) for _ in range(3))
    _close(enc_attention(q, k, v, 4), enc_attention_plain(q, k, v, 4))


def test_enc_mlp_kernel(dev):
    from whisper_at_tpu_torch.ops.enc_mlp import enc_mlp, enc_mlp_plain

    gen = torch.Generator(device=dev).manual_seed(1)
    d, f = 256, 1024
    args = (_randn(gen, 2, 300, d), 1 + _randn(gen, d, scale=0.1), _randn(gen, d, scale=0.1),
            _randn(gen, f, d, scale=d ** -0.5), _randn(gen, f, scale=0.02),
            _randn(gen, d, f, scale=f ** -0.5), _randn(gen, d, scale=0.02))
    _close(enc_mlp(*args), enc_mlp_plain(*args))


@pytest.mark.parametrize("groups", [1, 4])
def test_kv_quant_and_cross_decode_kernels(dev, groups):
    from whisper_at_tpu_torch.ops.cross_decode import (
        cross_attention_int8, cross_attention_int8_plain, pad_bias)
    from whisper_at_tpu_torch.ops.kv_quant import (
        pad_ta, project_quantize_kv, project_quantize_kv_plain)

    gen = torch.Generator(device=dev).manual_seed(2)
    b, ta, d, h = 2, 300, 256, 4
    xa = _randn(gen, b, ta, d)
    wk, wv = _randn(gen, d, d, scale=d ** -0.5), _randn(gen, d, d, scale=d ** -0.5)
    bv = _randn(gen, d, scale=0.02)
    kern = project_quantize_kv(xa, wk, wv, bv)
    plain = project_quantize_kv_plain(xa, wk, wv, bv)
    for i in (0, 2):
        diff = (kern[i].int() - plain[i].int()).abs()
        assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) <= 1e-3
    for i in (1, 3):
        rel = ((kern[i] - plain[i]).abs() / plain[i].clamp_min(1e-30)).max()
        assert float(rel) <= 2 ** -7
    q = _randn(gen, b, h * groups, 64, scale=0.125)
    bias = pad_bias(ta, pad_ta(ta), dev)
    out = cross_attention_int8(q, *kern[:2], *kern[2:], bias, h)
    ref = cross_attention_int8_plain(q, *kern[:2], *kern[2:], bias, h)
    _close(out, ref, rel=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dtw_kernel(dev, dtype):
    """K6 against its plain version, bit for bit: a ragged batch with ties
    (integer costs) and NaN past each row's length, then one long row."""
    from whisper_at_tpu_torch.ops.dtw import dtw_trace, dtw_trace_plain

    rng = np.random.default_rng(4)
    x = rng.integers(-2, 3, (3, 37, 90)).astype(np.float32)
    lengths = [37, 5, 20]
    for g, n in enumerate(lengths):
        x[g, n:] = np.nan
    for x, lengths in ((x, lengths),
                       (rng.standard_normal((1, 300, 700)).astype(np.float32), [300])):
        xt = torch.from_numpy(x).to(dev)
        n = torch.tensor(lengths, dtype=torch.int32, device=dev)
        out = dtw_trace(xt, n, dtype)
        ref = dtw_trace_plain(xt, n, dtype)
        torch.cuda.synchronize()
        assert torch.equal(out, ref)


def test_transcribe_batched_runs_through_every_kernel(dev):
    """With word timestamps the call reaches K1-K4 and K6."""
    import whisper_at_tpu_torch as wat
    from whisper_at_tpu_torch.ops import cuda

    model = wat.build_model("tiny", device=dev, dtype=torch.bfloat16, seed=0)
    audio = (np.random.default_rng(0).standard_normal(16000 * 40) * 3000).astype(np.int16)
    cuda.reset_launch_counts()
    result = wat.transcribe_batched(model, audio, language="en", temperature=0.0,
                                    sample_len=8, kv_quant=True, weight_quant=True,
                                    self_kv_quant=True, logprob_threshold=None,
                                    compression_ratio_threshold=None,
                                    no_speech_threshold=None, word_timestamps=True)
    assert all(n > 0 for n in cuda.launch_counts().values()), cuda.launch_counts()
    assert result["audio_tag"].shape == (4, 527) and np.isfinite(result["audio_tag"]).all()
    assert any(seg["words"] for seg in result["segments"])
