"""The port's CUDA kernels against their plain versions, on the card
(K1-K10, the int4 entries of K3, K4 and K10, the int8 entry of K8, the
streaming probes P1 and P2; K4 on both of its paths, tensor cores and CUDA
cores, and with its positions split over clusters; K8 at every Whisper
width, in forced tilings and in a CUDA graph).

Every test here needs an NVIDIA GPU and the CUDA toolkit (nvcc); without a
card they skip. Run them on the card with `pytest -m cuda
tests/test_torch_cuda.py`. `chip_smoke.py` makes the same comparisons at
the full headline shapes. Tolerances are bf16-level: the kernels and the
plain versions round at different points; the DTW trace (K6) and the
probes' integer sums and XOR word are exact.
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


def _within_k1_bound(out, ref):
    """chip_smoke.k1_compare's bound: |out - ref| <= 2^-10 + 2^-7 |ref| per element."""
    diff = (out.float() - ref.float()).abs()
    worst = float((diff / (2 ** -10 + 2 ** -7 * ref.float().abs())).max())
    assert worst <= 1.0, f"|out - ref| exceeds 2^-10 + 2^-7 |ref| by {worst:.3f}x"


def _exact_attention(q, k, v, h):
    """softmax(q k^T / 8) v per head in float64."""
    b, t, d = q.shape
    qh, kh, vh = (x.double().view(b, t, h, d // h).transpose(1, 2) for x in (q, k, v))
    out = torch.softmax(qh @ kh.transpose(-1, -2) / 8, dim=-1) @ vh
    return out.transpose(1, 2).reshape(b, t, d)


@pytest.mark.parametrize("kernel", ["K1", "K7"])
@pytest.mark.parametrize("b, t, h", [(1, 64, 1)] + [(3, t, 4) for t in
                                                    (1, 64, 65, 127, 128, 129, 300, 1500)])
def test_encoder_attention_kernels(dev, kernel, b, t, h):
    """K1 and K7 (one TMA + wgmma template) at the edges of their tiles: one
    64-row tile (B = H = 1, T = 64: the descriptors of one tile), T below,
    at and above the 64-row warpgroup tile and the 128-key tile, a ragged
    last tile, and the encoder's 1500.

    Both are held per element at k1_compare's bound to enc_flash_plain, the
    plain version that rounds as the template does (P = exp(S - max) in
    bf16, normalised at the end). K1's own plain version rounds the
    normalised weights instead; below T = 1500 that version's error alone
    can exceed the bound's slack, so K1 is held to it at the tolerance of
    the earlier K1 test, and to be no farther from the float64 result."""
    from whisper_at_tpu_torch.ops import enc_attention, enc_flash

    fast = enc_attention.enc_attention if kernel == "K1" else enc_flash.enc_flash
    gen = torch.Generator(device=dev).manual_seed(t)
    q, k, v = (_randn(gen, b, t, h * 64) for _ in range(3))
    out = fast(q, k, v, h)
    _within_k1_bound(out, enc_flash.enc_flash_plain(q, k, v, h))
    if kernel == "K1":
        ref = enc_attention.enc_attention_plain(q, k, v, h)
        _close(out, ref)
        exact = _exact_attention(q, k, v, h)
        err, ref_err = ((x.double() - exact).abs().max() for x in (out, ref))
        assert float(err) <= float(ref_err), (float(err), float(ref_err))


@pytest.mark.parametrize("kernel", ["K1", "K7"])
def test_encoder_attention_kernels_keep_batch_rows_apart(dev, kernel):
    """At T = 300 (not a multiple of the 128-key tile) the key tiles of batch
    row 0 run past T. Batch row 1's values are +inf: if its rows were read
    as row 0's keys past T, 0 * inf would put NaN into row 0's output."""
    from whisper_at_tpu_torch.ops import enc_attention, enc_flash

    fast = enc_attention.enc_attention if kernel == "K1" else enc_flash.enc_flash
    gen = torch.Generator(device=dev).manual_seed(7)
    b, t, h = 2, 300, 4
    q, k, v = (_randn(gen, b, t, h * 64) for _ in range(3))
    v[1] = float("inf")
    out = fast(q, k, v, h)[0]
    assert bool(torch.isfinite(out).all())
    _within_k1_bound(out, enc_flash.enc_flash_plain(q[:1], k[:1], v[:1], h)[0])


def _enc_mlp_args(gen, b, t, d):
    f = 4 * d
    return (_randn(gen, b, t, d), 1 + _randn(gen, d, scale=0.1), _randn(gen, d, scale=0.1),
            _randn(gen, f, d, scale=d ** -0.5), _randn(gen, f, scale=0.02),
            _randn(gen, d, f, scale=f ** -0.5), _randn(gen, d, scale=0.02))


@pytest.mark.parametrize("d", [256, 384, 512, 768, 1024, 1280])
@pytest.mark.parametrize("b, t", [(2, 300), (1, 1), (1, 127), (1, 129), (1, 1500), (3, 1000),
                                  (1, 3001)])
def test_enc_mlp_kernel(dev, d, b, t):
    """K2 at every Whisper width (and 256) with F = 4D: M = b * t below,
    at and above one 128-row panel, ragged last panels, one audio row and
    3000-3001 rows, so `plan` gives both block widths; a ragged last panel
    is where a residual read at the wrong row would show."""
    from whisper_at_tpu_torch.ops.enc_mlp import enc_mlp, enc_mlp_plain

    gen = torch.Generator(device=dev).manual_seed(1)
    args = _enc_mlp_args(gen, b, t, d)
    _close(enc_mlp(*args), enc_mlp_plain(*args))


@pytest.mark.parametrize("t", [500, 250])
def test_k1_and_k2_at_the_extraction_shapes(dev, t):
    """K1 and K2 at the feature extraction's [4, T, 1280]: T = 500 (10 s
    AudioSet clips) and 250 (5 s ESC-50 clips), neither a multiple of the
    128-row tiles, so the last query and key tiles are partial."""
    from whisper_at_tpu_torch.ops import enc_attention, enc_flash
    from whisper_at_tpu_torch.ops.enc_mlp import enc_mlp, enc_mlp_plain

    gen = torch.Generator(device=dev).manual_seed(t)
    q, k, v = (_randn(gen, 4, t, 1280) for _ in range(3))
    out = enc_attention.enc_attention(q, k, v, 20)
    _within_k1_bound(out, enc_flash.enc_flash_plain(q, k, v, 20))
    _close(out, enc_attention.enc_attention_plain(q, k, v, 20))
    args = _enc_mlp_args(gen, 4, t, 1280)
    _close(enc_mlp(*args), enc_mlp_plain(*args))


def test_enc_mlp_kernel_at_the_headline_rows(dev):
    """K2 at large-v1 batch 24 (M = 36000 = 281 x 128 + 32, D = 1280), where
    both products take 256-wide blocks and every block runs ~11 tiles."""
    from whisper_at_tpu_torch.ops.enc_mlp import enc_mlp, enc_mlp_plain, plan

    assert plan(36000, 1280, 132)[0] == plan(36000, 5120, 132)[0] == 256
    gen = torch.Generator(device=dev).manual_seed(2)
    args = _enc_mlp_args(gen, 24, 1500, 1280)
    _close(enc_mlp(*args), enc_mlp_plain(*args))


@pytest.mark.parametrize("d, tp", [(1280, 2), (1280, 4), (1024, 2), (512, 4), (384, 3)])
@pytest.mark.parametrize("b, t", [(2, 300), (1, 1500), (1, 129)])
def test_enc_mlp_partial_kernel_at_rank_widths(dev, d, tp, b, t):
    """K2-partial over a tensor-parallel rank's F = 4D / tp hidden units
    (2560 and 1280 at large-v1's tp 2 and 4): its output against its plain
    version, and the ranks' outputs summed plus x + b2 against the whole
    K2's at bf16 level."""
    from whisper_at_tpu_torch.ops.enc_mlp import enc_mlp, enc_mlp_partial, enc_mlp_partial_plain

    gen = torch.Generator(device=dev).manual_seed(d + tp)
    x, ln_w, ln_b, w1, b1, w2, b2 = _enc_mlp_args(gen, b, t, d)
    total = torch.zeros_like(x, dtype=torch.float32)
    for r in range(tp):
        part = (x, ln_w, ln_b, w1.chunk(tp)[r], b1.chunk(tp)[r],
                w2.chunk(tp, dim=1)[r].contiguous())
        out = enc_mlp_partial(*part)
        _close(out, enc_mlp_partial_plain(*part))
        total += out.float()
    whole = enc_mlp(x, ln_w, ln_b, w1, b1, w2, b2)
    _close((x.float() + total + b2.float()).to(torch.bfloat16), whole)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("d, tp", [(1280, 2), (1280, 4), (1024, 4), (768, 3), (512, 8)])
def test_kv_quant_kernels_at_rank_widths(dev, bits, d, tp):
    """K3 and K3-int4 on a tensor-parallel rank's [D / tp, D] weights (640
    and 320 columns at large-v1's tp 2 and 4; 320 is not a multiple of the
    128-wide tile): held to the plain version as at full width, and each
    rank's codes and scales are its heads of the whole layer's within the
    same bounds."""
    from whisper_at_tpu_torch.models.layers import unpack4
    from whisper_at_tpu_torch.ops.kv_quant import project_quantize_kv, project_quantize_kv4

    project = project_quantize_kv4 if bits == 4 else project_quantize_kv
    gen = torch.Generator(device=dev).manual_seed(d * tp + bits)
    xa, wk, wv, bv = _kv_quant_args(gen, 3, 300, d)
    whole = project(xa, wk, wv, bv)
    n = d // tp
    codes = (lambda t: unpack4(t).int()) if bits == 4 else (lambda t: t.int())
    for r in range(tp):
        rows = slice(r * n, (r + 1) * n)
        part = _kv_quant_holds(xa, wk[rows].contiguous(), wv[rows].contiguous(),
                               bv[rows].contiguous(), bits)
        for i in (0, 2):
            assert torch.equal(codes(part[i]), codes(whole[i])[..., rows])
        for i in (1, 3):
            assert torch.equal(part[i], whole[i][:, r * n // 64:(r + 1) * n // 64])


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


def _kv_quant_holds(xa, wk, wv, bv, bits):
    """K3 (or K3-int4) against project_quantize_kv_plain: codes within 1 LSB
    on <= 1e-3 of the entries, scales within 2^-7 relative; the pad rows
    t >= Ta exactly zero, codes and scales; a second call bit for bit.
    Returns the kernel's output."""
    from whisper_at_tpu_torch.models.layers import unpack4
    from whisper_at_tpu_torch.ops.kv_quant import (
        project_quantize_kv, project_quantize_kv4, project_quantize_kv_plain)

    project = project_quantize_kv4 if bits == 4 else project_quantize_kv
    kern = project(xa, wk, wv, bv)
    plain = project_quantize_kv_plain(xa, wk, wv, bv, bits=bits)
    codes = (lambda t: unpack4(t).int()) if bits == 4 else (lambda t: t.int())
    for i in (0, 2):
        diff = (codes(kern[i]) - codes(plain[i])).abs()
        assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) <= 1e-3
    for i in (1, 3):
        rel = ((kern[i] - plain[i]).abs() / plain[i].clamp_min(1e-30)).max()
        assert float(rel) <= 2 ** -7
    ta = xa.shape[1]
    for i in (0, 2):
        assert not bool(kern[i][:, ta:].any()) and not bool(kern[i + 1][:, :, ta:].any())
    for out, again in zip(kern, project(xa, wk, wv, bv)):
        assert torch.equal(out, again)
    return kern


def _kv_quant_args(gen, b, ta, d):
    return (_randn(gen, b, ta, d), _randn(gen, d, d, scale=d ** -0.5),
            _randn(gen, d, d, scale=d ** -0.5), _randn(gen, d, scale=0.02))


# every Whisper width x Ta below, at and past one 128-row panel, a ragged
# 300 and the full 1500, the audio rows B in {1, 5, 24} taken in turn
_KV_QUANT_SHAPES = [(b, ta, d) for i, d in enumerate([384, 512, 768, 1024, 1280])
                    for j, ta in enumerate([1, 127, 128, 129, 300, 1500])
                    for b in [(1, 5, 24)[(i + j) % 3]]]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("b, ta, d", _KV_QUANT_SHAPES)
def test_kv_quant_kernels_at_every_width(dev, bits, b, ta, d):
    """K3 and K3-int4 on gemm_sm90.cuh at every Whisper width, through the
    block width `plan` picks (128 where 256-wide tiles would leave SMs
    idle), with the pad rows of each audio row zero."""
    gen = torch.Generator(device=dev).manual_seed(b * ta + d)
    _kv_quant_holds(*_kv_quant_args(gen, b, ta, d), bits)


@pytest.mark.parametrize("bits", [8, 4])
def test_kv_quant_kernels_at_the_headline_shape(dev, bits):
    """K3 and K3-int4 at large-v1 batch 24 (xa [24, 1500, 1280]), where the
    plan takes 256-wide tiles on 132 blocks, 2880 tiles."""
    from whisper_at_tpu_torch.ops.kv_quant import plan

    assert plan(24, 1500, 1280, 132) == (256, 132)
    gen = torch.Generator(device=dev).manual_seed(11)
    _kv_quant_holds(*_kv_quant_args(gen, 24, 1500, 1280), bits)


@pytest.mark.parametrize("bits", [8, 4])
def test_kv_quant_kernels_in_a_cuda_graph(dev, bits):
    """K3's launches over three layers' weights captured in a CUDA graph
    give the eager calls' bits."""
    from whisper_at_tpu_torch.ops.kv_quant import project_quantize_kv, project_quantize_kv4

    project = project_quantize_kv4 if bits == 4 else project_quantize_kv
    gen = torch.Generator(device=dev).manual_seed(12)
    xa = _randn(gen, 5, 300, 512)
    layers = [_kv_quant_args(gen, 1, 1, 512)[1:] for _ in range(3)]
    eager = [project(xa, *w) for w in layers]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        [project(xa, *w) for w in layers]
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [project(xa, *w) for w in layers]
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for out, want in zip(outs, eager):
            for o, w in zip(out, want):
                assert torch.equal(o, w)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("case", ["d", "out_shape", "out_dtype", "xa_dtype"])
def test_kv_quant_refuses_inputs_outside_its_contract(dev, bits, case):
    """D not a multiple of 128, an `out` of the wrong shape or dtype, or xa
    not bf16 raise ValueError before anything launches."""
    from whisper_at_tpu_torch.ops import cuda
    from whisper_at_tpu_torch.ops.kv_quant import (
        _allocate, pad_ta, project_quantize_kv, project_quantize_kv4)

    project = project_quantize_kv4 if bits == 4 else project_quantize_kv
    b, ta, d = 2, 300, 192 if case == "d" else 256
    gen = torch.Generator(device=dev).manual_seed(13)
    xa, wk, wv, bv = _kv_quant_args(gen, b, ta, d)
    out = None
    if case == "out_shape":
        out = _allocate(b, pad_ta(ta), d, dev, 8 if bits == 4 else 4)
    elif case == "out_dtype":
        kq, ks, vq, vs = _allocate(b, pad_ta(ta), d, dev, bits)
        out = (kq, ks.double(), vq, vs)
    elif case == "xa_dtype":
        xa = xa.float()
    name = "kv_quant4" if bits == 4 else "kv_quant"
    before = cuda.launch_counts()[name]
    with pytest.raises(ValueError):
        project(xa, wk, wv, bv, out=out)
    assert cuda.launch_counts()[name] == before


@pytest.mark.parametrize("weight_quant", [False, True])
@pytest.mark.parametrize("b, s", [(24, 16), (120, 4), (24, 4)])
def test_decoder_forward_with_fused_mlp_over_a_prefill(dev, monkeypatch, weight_quant, b, s):
    """`decoder_forward` with FUSED_MLP over a prefill of B*S rows: past K8's
    MAX_ROWS (a batch of 24 at bucket 16, beam 5 at batch 24) no row goes to
    K8 and the hidden states are the unfused path's bit for bit; within it
    (the greedy prefill, 96 rows) K8 takes each layer's MLP and the result
    holds to the unfused path at bf16 level."""
    import whisper_at_tpu_torch as wat
    from whisper_at_tpu_torch.models import decoder
    from whisper_at_tpu_torch.ops import cuda, fused_mlp

    model = wat.build_model("tiny", device=dev, dtype=torch.bfloat16, seed=0)
    params = model.decoder_params_decode(weight_quant=weight_quant)
    dims = model.dims
    gen = torch.Generator(device=dev).manual_seed(14)
    xa = _randn(gen, b, 1500, dims.n_audio_state)
    cross = decoder.precompute_cross_kv(params, xa, dims.n_text_head, torch.bfloat16,
                                        quantize=True)
    tokens = torch.randint(0, dims.n_vocab, (b, s), generator=gen, device=dev)
    entry = "fused_mlp_int8" if weight_quant else "fused_mlp"
    hidden, launches = {}, {}
    for fused in (False, True):
        monkeypatch.setattr(decoder, "FUSED_MLP", fused)
        cache = decoder.init_cache(dims.n_text_layer, b, 32, dims.n_text_state, torch.bfloat16,
                                   dims.n_text_head, quantize=True, device=dev)
        before = cuda.launch_counts()[entry]
        hidden[fused] = decoder.decoder_forward(params, tokens, cross, cache, 0, 0,
                                                dims.n_text_head, torch.bfloat16)
        launches[fused] = cuda.launch_counts()[entry] - before
    assert launches[False] == 0
    if b * s > fused_mlp.MAX_ROWS:
        assert launches[True] == 0
        assert torch.equal(hidden[True], hidden[False])
    else:
        assert launches[True] == dims.n_text_layer
        _close(hidden[True], hidden[False], rel=2 ** -5)


# large-v1's four decode weight shapes (K, N): qkv, out, fc1, fc2
_W4_SHAPES = [(1280, 3840), (1280, 1280), (1280, 5120), (5120, 1280)]


@pytest.mark.parametrize("m, k, n", [(1, 256, 128), (24, 1280, 384), (96, 512, 256),
                                     (120, 5120, 128), (256, 96, 64)] +
                         [(m, k, n) for m in (1, 16, 17, 24, 33, 96, 120, 256)
                          for k, n in _W4_SHAPES])
def test_w4_matmul_kernel(dev, m, k, n):
    """K5 against its plain version: the products of bf16 x int4 are exact
    in fp32, so only the summation order differs (2^-18 of sum |x| |w|)."""
    from whisper_at_tpu_torch.models.layers import pack4
    from whisper_at_tpu_torch.ops.w4_matmul import w4_matmul, w4_matmul_plain

    gen = torch.Generator(device=dev).manual_seed(m + k)
    x = _randn(gen, m, k)
    codes = torch.randint(-7, 8, (n, k), generator=gen, device=dev, dtype=torch.int8)
    wp = pack4(codes)
    out = w4_matmul(x, wp)
    ref = w4_matmul_plain(x, wp)
    torch.cuda.synchronize()
    scale = float((x.float().abs() @ codes.float().abs().t()).max())
    assert float((out - ref).abs().max()) <= 2 ** -18 * scale


@pytest.mark.parametrize("m, k, n", [(0, 1280, 1280), (257, 1280, 1280), (24, 1280, 96),
                                     (24, 1280, 0), (24, 48, 128), (24, 5152, 128)])
def test_w4_matmul_refuses_shapes_outside_its_contract(dev, m, k, n):
    """1 <= M <= 256, N a multiple of 64, K a multiple of 32 up to 5120: the
    wrapper raises before launching anything else."""
    from whisper_at_tpu_torch.ops.w4_matmul import KERNEL, w4_matmul

    x = torch.zeros((m, k), device=dev, dtype=torch.bfloat16)
    wp = torch.zeros((n, k // 2), device=dev, dtype=torch.int8)
    before = KERNEL.launches
    with pytest.raises(ValueError):
        w4_matmul(x, wp)
    with pytest.raises(ValueError, match="pack"):
        w4_matmul(torch.zeros((24, 1280), device=dev, dtype=torch.bfloat16),
                  torch.zeros((128, 320), device=dev, dtype=torch.int8))
    assert KERNEL.launches == before


@pytest.mark.parametrize("groups", [1, 5])
def test_kv_quant4_and_cross_decode4_kernels(dev, groups):
    """K3-int4 (codes within 1 LSB on <= 0.1%, scales rel 2^-7, as K3) and
    K4-int4 over its output."""
    from whisper_at_tpu_torch.models.layers import unpack4
    from whisper_at_tpu_torch.ops.cross_decode import (
        cross_attention_int4, cross_attention_int4_plain, pad_bias)
    from whisper_at_tpu_torch.ops.kv_quant import (
        pad_ta, project_quantize_kv4, project_quantize_kv_plain)

    gen = torch.Generator(device=dev).manual_seed(3)
    b, ta, d, h = 2, 300, 256, 4
    xa = _randn(gen, b, ta, d)
    wk, wv = _randn(gen, d, d, scale=d ** -0.5), _randn(gen, d, d, scale=d ** -0.5)
    bv = _randn(gen, d, scale=0.02)
    kern = project_quantize_kv4(xa, wk, wv, bv)
    plain = project_quantize_kv_plain(xa, wk, wv, bv, bits=4)
    for i in (0, 2):
        diff = (unpack4(kern[i]).int() - unpack4(plain[i]).int()).abs()
        assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) <= 1e-3
    for i in (1, 3):
        rel = ((kern[i] - plain[i]).abs() / plain[i].clamp_min(1e-30)).max()
        assert float(rel) <= 2 ** -7
    q = _randn(gen, b, h * groups, 64, scale=0.125)
    bias = pad_bias(ta, pad_ta(ta), dev)
    out = cross_attention_int4(q, *kern[:2], *kern[2:], bias, h)
    ref = cross_attention_int4_plain(q, *kern[:2], *kern[2:], bias, h)
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


def _dtw_inputs(rng, g, n_max, m):
    """Costs with ties (small integers), +inf, -inf and NaN sprinkled in."""
    x = rng.integers(-2, 3, (g, n_max, m)).astype(np.float32)
    x += rng.standard_normal(x.shape).astype(np.float32) * (rng.random(x.shape) < 0.5)
    for value, share in ((np.inf, 0.01), (-np.inf, 0.005), (np.nan, 0.005)):
        x[rng.random(x.shape) < share] = value
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", [1, 2, 33, 1500])
@pytest.mark.parametrize("n_max", [1, 31, 32, 33, 64, 65, 97, 448, 511])
def test_dtw_kernel_at_warp_and_handover_edges(dev, n_max, m, dtype):
    """K6 bit for bit against its plain version at row counts on each side of
    a warp (32 rows) and of a hand-over between warps, up to the 16 warps
    of 511 rows; M from one frame to 1500; a ragged batch (a count past
    N_max acts as N_max, 0 leaves only row 0) with ties and infinities."""
    from whisper_at_tpu_torch.ops.dtw import dtw_trace, dtw_trace_plain

    rng = np.random.default_rng(n_max * 7 + m)
    lengths = sorted({n_max, max(n_max // 2, 1), 1, 0, n_max + 3}, reverse=True)
    x = torch.from_numpy(_dtw_inputs(rng, len(lengths), n_max, m)).to(dev)
    n = torch.tensor(lengths, dtype=torch.int32, device=dev)
    out = dtw_trace(x, n, dtype)
    ref = dtw_trace_plain(x, n, dtype)
    torch.cuda.synchronize()
    assert torch.equal(out, ref), int((out != ref).sum())


def test_transcribe_batched_runs_through_every_kernel(dev):
    """With word timestamps and the int8 options the call reaches K1-K4 and
    K6, and no int4 entry."""
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
    counts = cuda.launch_counts()
    for name in ("enc_attention", "enc_mlp", "kv_quant", "cross_decode", "dtw"):
        assert counts[name] > 0, counts
    assert counts["kv_quant4"] == counts["cross_decode4"] == counts["w4_matmul"] == 0, counts
    assert result["audio_tag"].shape == (4, 527) and np.isfinite(result["audio_tag"]).all()
    assert any(seg["words"] for seg in result["segments"])


def test_transcribe_batched_int4_runs_through_its_kernels(dev):
    """With every int4 option the call reaches K1, K2, K3-int4, K4-int4 and
    K5, and neither int8 entry of K3 or K4."""
    import whisper_at_tpu_torch as wat
    from whisper_at_tpu_torch.ops import cuda

    model = wat.build_model("tiny", device=dev, dtype=torch.bfloat16, seed=0)
    audio = (np.random.default_rng(0).standard_normal(16000 * 40) * 3000).astype(np.int16)
    cuda.reset_launch_counts()
    result = wat.transcribe_batched(model, audio, language="en", temperature=0.0,
                                    sample_len=8, kv_quant=True, kv_bits=4, weight_quant=True,
                                    weight_bits=4, self_kv_quant=True, self_kv_bits=4,
                                    logprob_threshold=None, compression_ratio_threshold=None,
                                    no_speech_threshold=None)
    counts = cuda.launch_counts()
    for name in ("enc_attention", "enc_mlp", "kv_quant4", "cross_decode4", "w4_matmul"):
        assert counts[name] > 0, counts
    assert counts["kv_quant"] == counts["cross_decode"] == 0, counts
    assert result["audio_tag"].shape == (4, 527) and np.isfinite(result["audio_tag"]).all()


def test_transcribe_batched_beam_runs_through_its_kernels(dev):
    """Beam search (beam 3, int8) reaches K3 and K4, K4 at G = 3 per step."""
    import whisper_at_tpu_torch as wat
    from whisper_at_tpu_torch.ops import cuda

    model = wat.build_model("tiny", device=dev, dtype=torch.bfloat16, seed=0)
    audio = (np.random.default_rng(0).standard_normal(16000 * 40) * 3000).astype(np.int16)
    cuda.reset_launch_counts()
    result = wat.transcribe_batched(model, audio, language="en", temperature=0.0,
                                    sample_len=8, beam_size=3, kv_quant=True, weight_quant=True,
                                    self_kv_quant=True, logprob_threshold=None,
                                    compression_ratio_threshold=None, no_speech_threshold=None)
    counts = cuda.launch_counts()
    assert counts["kv_quant"] > 0 and counts["cross_decode"] > 0, counts
    assert all(np.isfinite(seg["avg_logprob"]) for seg in result["segments"])


def _mlp_pair(dev, d, quantized, seed):
    """fc1 [4d, d], fc2 [d, 4d] Linear modules (random, from seed), or their
    int8 QuantLinear pairs."""
    from whisper_at_tpu_torch.models.layers import Linear, quantize_linear

    gen = torch.Generator(device=dev).manual_seed(seed)
    fc1 = Linear(d, 4 * d, device=dev, dtype=torch.bfloat16)
    fc2 = Linear(4 * d, d, device=dev, dtype=torch.bfloat16)
    fc1.reset_random(gen)
    fc2.reset_random(gen)
    fc1.requires_grad_(False)
    fc2.requires_grad_(False)
    if quantized:
        fc1, fc2 = quantize_linear(fc1), quantize_linear(fc2)
    return gen, fc1, fc2


def _fused_mlp_holds(x, fc1, fc2):
    """K8 against fused_mlp_plain at 2^-7 of the output's largest magnitude
    (+ 1e-3), and a second call on the same inputs bit for bit."""
    from whisper_at_tpu_torch.ops import fused_mlp

    out = fused_mlp.fused_mlp(x, fc1, fc2)
    ref = fused_mlp.fused_mlp_plain(x, *fused_mlp.linear_weights(fc1),
                                    *fused_mlp.linear_weights(fc2))
    _close(out, ref, rel=2 ** -7)
    torch.testing.assert_close(fused_mlp.fused_mlp(x, fc1, fc2), out, rtol=0, atol=0)
    return out


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("d", [384, 512, 768, 1024, 1280])
@pytest.mark.parametrize("m", [1, 7, 24, 96, 120, 256])
def test_fused_mlp_kernel(dev, quantized, d, m):
    """K8, bf16 and int8 entries, at every Whisper width (F = 4D): one row,
    a ragged 7, a greedy step, the greedy prefill, a beam-5 step and the
    largest prefill bucket, through the tilings `plan` picks."""
    gen, fc1, fc2 = _mlp_pair(dev, d, quantized, 6)
    _fused_mlp_holds(_randn(gen, m, d), fc1, fc2)


# (M, fc1 and fc2 tilings (bn, split, stages, kgroups)) forced on large-v1's
# widths: K split over clusters of 2, 4 and 8 (fc2 with 8: 16 or 80
# clusters add their own partials, 2 to 10 columns a block), rings of 1-4
# stages that wrap many times, taken by both warpgroups in turn (M <= 64)
# or by one each
_FORCED_TILINGS = [
    (24, (80, 2, 1, 1), (80, 8, 2, 2)), (24, (64, 4, 3, 1), (16, 1, 4, 2)),
    (24, (32, 2, 4, 2), (64, 2, 1, 1)), (24, (16, 1, 2, 2), (64, 4, 3, 1)),
    (24, (32, 4, 3, 1), (80, 8, 1, 1)), (24, (80, 4, 2, 2), (16, 8, 2, 2)),
    (120, (80, 2, 1, 1), (80, 8, 2, 1)), (120, (64, 4, 3, 1), (16, 1, 3, 1)),
    (120, (32, 2, 4, 1), (64, 2, 1, 1)), (120, (16, 1, 2, 1), (64, 4, 3, 1)),
    (120, (32, 4, 3, 1), (80, 8, 1, 1)), (120, (80, 4, 2, 1), (16, 8, 2, 1))]


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("m, fc1_tiling, fc2_tiling", _FORCED_TILINGS)
def test_fused_mlp_kernel_in_forced_tilings(dev, monkeypatch, quantized, m, fc1_tiling,
                                            fc2_tiling):
    """K8 at large-v1's widths under tilings `plan` does not pick: the
    cluster's partials add in rank order at every split and width of a
    block's share, and the ring's phases hold over many wraps."""
    from whisper_at_tpu_torch.ops import fused_mlp

    fc1_t, fc2_t = fused_mlp.Tiling(*fc1_tiling), fused_mlp.Tiling(*fc2_tiling)
    wb = 1 if quantized else 2
    p = fused_mlp.Plan(fc1_t, fc2_t, (fused_mlp.smem_bytes(m, fc1_t, wb),
                                      fused_mlp.smem_bytes(m, fc2_t, wb)), 2 * m * 5120)
    monkeypatch.setattr(fused_mlp, "_plan", lambda *a: p)
    gen, fc1, fc2 = _mlp_pair(dev, 1280, quantized, 8)
    _fused_mlp_holds(_randn(gen, m, 1280), fc1, fc2)


@pytest.mark.parametrize("quantized", [False, True])
def test_fused_mlp_kernel_in_a_cuda_graph(dev, quantized):
    """K8's two launches (fc2 by programmatic dependent launch) captured in
    a CUDA graph over three layers' pairs give the eager calls' bits."""
    from whisper_at_tpu_torch.ops import fused_mlp

    pairs = [_mlp_pair(dev, 1280, quantized, 20 + i)[1:] for i in range(3)]
    x = _randn(torch.Generator(device=dev).manual_seed(9), 24, 1280)
    eager = [fused_mlp.fused_mlp(x, *p) for p in pairs]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        [fused_mlp.fused_mlp(x, *p) for p in pairs]
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fused_mlp.fused_mlp(x, *p) for p in pairs]
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for out, want in zip(outs, eager):
            torch.testing.assert_close(out, want, rtol=0, atol=0)


@pytest.mark.parametrize("m, d, f", [(257, 1280, 5120), (24, 1280 + 32, 5120),
                                     (24, 1280, 5120 + 32)])
def test_fused_mlp_refuses_shapes_outside_its_contract(dev, m, d, f):
    """More rows than the largest prefill bucket, or D or F off the 64-column
    chunk, raise ValueError before anything launches."""
    from whisper_at_tpu_torch.models.layers import Linear
    from whisper_at_tpu_torch.ops import cuda, fused_mlp

    fc1 = Linear(d, f, device=dev, dtype=torch.bfloat16).requires_grad_(False)
    fc2 = Linear(f, d, device=dev, dtype=torch.bfloat16).requires_grad_(False)
    x = torch.zeros((m, d), device=dev, dtype=torch.bfloat16)
    before = cuda.launch_counts()["fused_mlp"]
    with pytest.raises(ValueError):
        fused_mlp.fused_mlp(x, fc1, fc2)
    assert cuda.launch_counts()["fused_mlp"] == before


def test_flash_decode_kernel(dev):
    """K9 on K3's output (S = 300 of 384 valid) at one query row per head."""
    from whisper_at_tpu_torch.ops.flash_decode import flash_decode_cross, flash_decode_cross_plain
    from whisper_at_tpu_torch.ops.kv_quant import project_quantize_kv

    gen = torch.Generator(device=dev).manual_seed(7)
    b, ta, d, h = 3, 300, 256, 4
    xa = _randn(gen, b, ta, d)
    kq, ks, vq, vs = project_quantize_kv(xa, _randn(gen, d, d, scale=d ** -0.5),
                                         _randn(gen, d, d, scale=d ** -0.5),
                                         _randn(gen, d, scale=0.02))
    q = _randn(gen, b * h, 64)
    out = flash_decode_cross(q, kq, ks, vq, vs, h, ta)
    ref = flash_decode_cross_plain(q, kq, ks, vq, vs, h, ta)
    _close(out, ref, rel=2 ** -7)


def _k9_inputs(gen, a, h, s_pad):
    kq, vq = (torch.randint(-127, 128, (a, s_pad, h * 64), generator=gen, device="cuda",
                            dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand((a, h, s_pad), generator=gen, device="cuda") * 0.02 for _ in range(2))
    return _randn(gen, a * h, 64), kq, ks, vq, vs


def _within_k9_bound(out, ref):
    """chip_smoke.k9_compare's bound: 1e-5 + 2^-7 |ref| per element."""
    diff = (out.float() - ref.float()).abs()
    worst = float((diff / (1e-5 + 2 ** -7 * ref.float().abs())).max())
    assert worst <= 1.0, f"|out - ref| exceeds 1e-5 + 2^-7 |ref| by {worst:.3f}x"


@pytest.mark.parametrize("a, h, s, s_pad", [(1, 20, 1500, 1536), (24, 20, 1500, 1536),
                                            (1, 4, 1, 128), (1, 4, 129, 256), (2, 4, 300, 384),
                                            (3, 2, 2048, 2048), (1, 20, 1024, 1024)])
def test_flash_decode_kernel_splits_and_ragged_stages(dev, a, h, s, s_pad):
    """K9 at S not a multiple of a stage (1, 129, 300, 1500), one audio row
    (the positions split over a cluster) and 24 (one run a block), a full
    last stage, and a run of eight stages."""
    from whisper_at_tpu_torch.ops.flash_decode import flash_decode_cross, flash_decode_cross_plain

    gen = torch.Generator(device=dev).manual_seed(a * 1000 + s)
    args = _k9_inputs(gen, a, h, s_pad)
    out = flash_decode_cross(*args, h, s)
    ref = flash_decode_cross_plain(*args, h, s)
    _within_k9_bound(out, ref)
    assert torch.equal(out, flash_decode_cross(*args, h, s))  # no atomics: a repeat is exact


@pytest.mark.parametrize("a", [1, 24])
def test_flash_decode_kernel_in_a_cuda_graph(dev, a):
    """K9 captured in a CUDA graph and replayed on new inputs gives what an
    eager call gives on them, bit for bit."""
    from whisper_at_tpu_torch.ops.flash_decode import flash_decode_cross

    gen = torch.Generator(device=dev).manual_seed(a)
    args = _k9_inputs(gen, a, 20, 1536)
    flash_decode_cross(*args, 20, 1500)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = flash_decode_cross(*args, 20, 1500)
    for t, fresh in zip(args, _k9_inputs(gen, a, 20, 1536)):
        t.copy_(fresh)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, flash_decode_cross(*args, 20, 1500))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("groups", [1, 3, 12])
def test_cross_decode_stream_kernels(dev, bits, groups):
    """K10 and K10-int4 on K3's output; G = 12 takes two row slices."""
    from whisper_at_tpu_torch.ops import cross_decode_stream as cs
    from whisper_at_tpu_torch.ops.cross_decode import pad_bias
    from whisper_at_tpu_torch.ops.kv_quant import (
        pad_ta, project_quantize_kv, project_quantize_kv4)

    gen = torch.Generator(device=dev).manual_seed(8)
    b, ta, d, h = 2, 300, 256, 4
    xa = _randn(gen, b, ta, d)
    project = project_quantize_kv4 if bits == 4 else project_quantize_kv
    kern = project(xa, _randn(gen, d, d, scale=d ** -0.5), _randn(gen, d, d, scale=d ** -0.5),
                   _randn(gen, d, scale=0.02))
    q = _randn(gen, b, h * groups, 64, scale=0.125)
    bias = pad_bias(ta, pad_ta(ta), dev)
    kernel, plain = ((cs.cross_attention_stream4, cs.cross_attention_stream4_plain) if bits == 4
                     else (cs.cross_attention_stream, cs.cross_attention_stream_plain))
    _close(kernel(q, *kern, bias, h), plain(q, *kern, bias, h), rel=1e-3)


def _stream_inputs(gen, a, h, ta, ta_pad, groups, bits):
    """Random K3-layout codes over the whole range, positive scales, K4's pad
    bias and q as the decoder scales it."""
    from whisper_at_tpu_torch.models.layers import pack4
    from whisper_at_tpu_torch.ops.cross_decode import pad_bias

    lim = 7 if bits == 4 else 127
    kq, vq = (torch.randint(-lim, lim + 1, (a, ta_pad, h * 64), generator=gen, device="cuda",
                            dtype=torch.int8) for _ in range(2))
    if bits == 4:
        kq, vq = pack4(kq), pack4(vq)
    ks, vs = ((torch.rand((a, h, ta_pad), generator=gen, device="cuda") + 0.5) * s
              for s in (0.02 if bits == 8 else 0.3, 0.01))
    q = _randn(gen, a, h * groups, 64, scale=0.125)
    return q, kq, ks, vq, vs, pad_bias(ta, ta_pad, "cuda")


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("a", [1, 24])
@pytest.mark.parametrize("groups", [1, 5, 8, 9, 12])
@pytest.mark.parametrize("ta", [1, 63, 64, 65, 300, 1500])
def test_cross_decode_stream_kernels_at_edges(dev, bits, a, groups, ta):
    """K10 and K10-int4 at large-v1's 20 heads, one and 24 audio rows, the
    greedy step, a beam step and G around the 8 rows of a block, and Ta on
    both sides of a 64-position boundary, against the plain version that
    splits the positions as the kernel does."""
    from whisper_at_tpu_torch.ops import cross_decode_stream as cs
    from whisper_at_tpu_torch.ops.kv_quant import pad_ta

    gen = torch.Generator(device=dev).manual_seed(ta * 100 + groups + a)
    args = _stream_inputs(gen, a, 20, ta, pad_ta(ta), groups, bits)
    kernel, plain = ((cs.cross_attention_stream4, cs.cross_attention_stream4_plain) if bits == 4
                     else (cs.cross_attention_stream, cs.cross_attention_stream_plain))
    _close(kernel(*args, 20), plain(*args, 20), rel=1e-3)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("a, ta_pad", [(2, 192), (1, 64)])
def test_cross_decode_stream_kernels_take_half_a_stage(dev, bits, a, ta_pad):
    """Ta_pad a multiple of 64 but not of the kernel's 128-position stage:
    the last stage's tail weighs nothing."""
    from whisper_at_tpu_torch.ops import cross_decode_stream as cs

    gen = torch.Generator(device=dev).manual_seed(ta_pad + a)
    args = _stream_inputs(gen, a, 4, ta_pad - 10, ta_pad, 3, bits)
    kernel, plain = ((cs.cross_attention_stream4, cs.cross_attention_stream4_plain) if bits == 4
                     else (cs.cross_attention_stream, cs.cross_attention_stream_plain))
    _close(kernel(*args, 4), plain(*args, 4), rel=1e-3)


@pytest.mark.parametrize("bits", [8, 4])
def test_cross_decode_stream_kernels_keep_rows_apart(dev, bits):
    """An inf scale in another head, and every scale of another audio row
    inf, reach no output but their own."""
    from whisper_at_tpu_torch.ops import cross_decode_stream as cs

    gen = torch.Generator(device=dev).manual_seed(11)
    q, kq, ks, vq, vs, bias = _stream_inputs(gen, 2, 20, 1500, 1536, 1, bits)
    kernel = cs.cross_attention_stream4 if bits == 4 else cs.cross_attention_stream
    clean = kernel(q, kq, ks, vq, vs, bias, 20)
    ks, vs = ks.clone(), vs.clone()
    ks[1], vs[1] = float("inf"), float("inf")
    ks[0, 3, 700], vs[0, 3, 5] = float("inf"), float("inf")
    out = kernel(q, kq, ks, vq, vs, bias, 20)
    torch.cuda.synchronize()
    keep = [h for h in range(20) if h != 3]
    assert torch.equal(out[0, keep], clean[0, keep])


def _cross_decode_pair(bits):
    from whisper_at_tpu_torch.ops import cross_decode as cd

    return ((cd.cross_attention_int4, cd.cross_attention_int4_plain) if bits == 4
            else (cd.cross_attention_int8, cd.cross_attention_int8_plain))


# G: the greedy step (CUDA cores), the prefill bucket and a beam step
# (tensor cores; int4 in stages of 256 positions), G = 8 (stages of 128)
# and G = 12 (two row slices of 16)
_K4_ROWS = [1, 4, 5, 8, 12]


@pytest.mark.parametrize("groups", _K4_ROWS)
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("a", [1, 24])
@pytest.mark.parametrize("ta", [1, 63, 64, 65, 127, 128, 129, 300, 1500])
def test_cross_decode_kernels_at_edges(dev, groups, bits, a, ta):
    """K4 and K4-int4 at large-v1's 20 heads, one audio row (the positions
    split over a cluster) and 24 (one run), at _K4_ROWS, Ta on both sides of
    the 64- and 128-position boundaries, against the unchanged plain
    version."""
    from whisper_at_tpu_torch.ops.kv_quant import pad_ta

    gen = torch.Generator(device=dev).manual_seed(ta * 100 + groups + a)
    args = _stream_inputs(gen, a, 20, ta, pad_ta(ta), groups, bits)
    kernel, plain = _cross_decode_pair(bits)
    _close(kernel(*args, 20), plain(*args, 20), rel=1e-3)


@pytest.mark.parametrize("groups", [1, 5, 8, 12])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("ta", [1500, 1000, 700])
def test_cross_decode_kernels_in_forced_clusters(dev, monkeypatch, groups, bits, ta):
    """At batch 24 the wrapper takes one run; with the wave's slots unbounded
    it splits the positions over clusters of up to 8 blocks (stages of 128:
    1536 positions in 6 runs of 2, 1024 in 8 of 1, 768 in 6 of 1; of 256:
    6, 4 and 3 runs of 1), for every kernel the wrapper chooses."""
    from whisper_at_tpu_torch.ops import cross_decode as cd
    from whisper_at_tpu_torch.ops.kv_quant import pad_ta

    monkeypatch.setattr(cd, "wave_slots", lambda index: 10 ** 9)
    assert cd.plan(24, 20, groups, pad_ta(ta), bits, 10 ** 9)[0] > 1
    gen = torch.Generator(device=dev).manual_seed(ta + groups)
    args = _stream_inputs(gen, 24, 20, ta, pad_ta(ta), groups, bits)
    kernel, plain = _cross_decode_pair(bits)
    _close(kernel(*args, 20), plain(*args, 20), rel=1e-3)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("a, ta_pad", [(2, 132), (1, 68), (3, 4)])
def test_cross_decode_kernels_take_part_of_a_stage(dev, bits, a, ta_pad):
    """Ta_pad a multiple of 4 but not of the 128-position stage: the copy
    engine's rows past it weigh nothing."""
    gen = torch.Generator(device=dev).manual_seed(ta_pad + a)
    args = _stream_inputs(gen, a, 4, max(1, ta_pad - 3), ta_pad, 3, bits)
    kernel, plain = _cross_decode_pair(bits)
    _close(kernel(*args, 4), plain(*args, 4), rel=1e-3)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("a, groups", [(2, 1), (2, 5), (24, 1), (24, 5)])
def test_cross_decode_kernels_keep_rows_apart(dev, bits, a, groups):
    """An inf scale in another head, and every scale of another audio row
    inf, reach no output but their own, within a cluster (A = 2) and
    without (A = 24)."""
    gen = torch.Generator(device=dev).manual_seed(13 + a + groups)
    q, kq, ks, vq, vs, bias = _stream_inputs(gen, a, 20, 1500, 1536, groups, bits)
    kernel = _cross_decode_pair(bits)[0]
    clean = kernel(q, kq, ks, vq, vs, bias, 20)
    ks, vs = ks.clone(), vs.clone()
    ks[1], vs[1] = float("inf"), float("inf")
    ks[0, 3, 700], vs[0, 3, 5] = float("inf"), float("inf")
    out = kernel(q, kq, ks, vq, vs, bias, 20).view(a, 20, groups, 64)
    torch.cuda.synchronize()
    keep = [h for h in range(20) if h != 3]
    assert torch.equal(out[0, keep], clean.view(a, 20, groups, 64)[0, keep])
    if a > 2:
        assert torch.equal(out[2:], clean.view(a, 20, groups, 64)[2:])


@pytest.mark.parametrize("variant", ["a", "b"])
def test_transcribe_batched_switches_run_through_their_kernels(dev, monkeypatch, variant):
    """With ENC_ATTN=flash, CROSS_DECODE=stream and FUSED_MLP the call
    reaches K7, K8 and K10 in place of K1, the unfused MLP and K4: (a) with
    int8 weights and cross K/V, (b) with bf16 weights and int4 cross K/V."""
    import whisper_at_tpu_torch as wat
    from whisper_at_tpu_torch.models import decoder
    from whisper_at_tpu_torch.ops import cuda

    monkeypatch.setenv("WHISPER_AT_TPU_ENC_ATTN", "flash")
    monkeypatch.setenv("WHISPER_AT_TPU_CROSS_DECODE", "stream")
    monkeypatch.setattr(decoder, "FUSED_MLP", True)
    model = wat.build_model("tiny", device=dev, dtype=torch.bfloat16, seed=0)
    audio = (np.random.default_rng(0).standard_normal(16000 * 40) * 3000).astype(np.int16)
    opts = (dict(kv_quant=True, weight_quant=True) if variant == "a"
            else dict(kv_quant=True, kv_bits=4))
    cuda.reset_launch_counts()
    result = wat.transcribe_batched(model, audio, language="en", temperature=0.0,
                                    sample_len=8, self_kv_quant=True, logprob_threshold=None,
                                    compression_ratio_threshold=None, no_speech_threshold=None,
                                    **opts)
    counts = cuda.launch_counts()
    used = (("enc_flash", "fused_mlp_int8", "cross_decode_stream") if variant == "a"
            else ("enc_flash", "fused_mlp", "cross_decode_stream4"))
    for name in used:
        assert counts[name] > 0, counts
    assert counts["enc_attention"] == counts["cross_decode"] == counts["cross_decode4"] == 0, counts
    assert result["audio_tag"].shape == (4, 527) and np.isfinite(result["audio_tag"]).all()


@pytest.mark.parametrize("mb, chunk_kb", [(8, 256), (1, 1024), (3, 8), (1, 12), (2, 24),
                                          (64, 1024)])
def test_probe_kernels(dev, mb, chunk_kb):
    """P1 and both P2 rings at every depth, bitwise the plain version: many
    and few stages a block (1 MiB: 64 stages for up to 132 blocks, fewer
    than the ring's depth), the smallest chunk (8 KB, the sliver itself),
    stages smaller than the sliver (12 KB chunks: 4 KB stages) and chunks
    that are no power of two."""
    from whisper_at_tpu_torch.ops import probe_dma as pd

    n_rows, chunk_rows, _ = pd.probe_geometry(mb, chunk_kb)
    x = pd.make_buffer(n_rows, seed=1).to(dev)
    sums, xor = pd.stream_plain(x, chunk_rows)
    outs = {"auto": pd.stream_auto(x, chunk_rows)}
    for engine in pd.ENGINES:
        for nbuf in pd.RING_DEPTHS:
            outs[f"{engine}-{nbuf}"] = pd.stream_ring(x, chunk_rows, nbuf, engine)
    torch.cuda.synchronize()
    for name, (s, w) in outs.items():
        assert torch.equal(s, sums), name
        assert torch.equal(w, xor), name
