"""K8 (the fused decode MLP) against the JAX package's Pallas kernel, the
port's FUSED_MLP switch in the decoder, and `transcribe_batched` with all
three of the port's switches against the JAX package's default path.

On the CPU each kernel wrapper runs its plain PyTorch version; the JAX side
runs its Pallas kernels in interpret mode, as the JAX package's own tests
do. Inputs come from numpy with a seed and go to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisper_at_tpu as jax_wat
from whisper_at_tpu.models.dims import ModelDimensions as JaxDims
from whisper_at_tpu.models.layers import quantize_linear as jax_quantize_linear
from whisper_at_tpu.models.whisper import Whisper as JaxWhisper
from whisper_at_tpu.ops.fused_mlp import fused_mlp as jax_fused_mlp
import whisper_at_tpu_torch as wat
from whisper_at_tpu_torch.convert import from_jax_params
from whisper_at_tpu_torch.models import decoder
from whisper_at_tpu_torch.models.decoder import decoder_forward, init_cache, precompute_cross_kv
from whisper_at_tpu_torch.models.layers import Linear, QuantLinear, quantize_linear
from whisper_at_tpu_torch.ops import fused_mlp as k8

pytestmark = pytest.mark.quick


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These models are tiny: the port's passes run on one thread, which
    keeps the file's time steady when other test processes share the
    cores (a thread pool per process oversubscribes them)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


DIMS = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=128, n_audio_head=2,
            n_audio_layer=2, n_vocab=51865, n_text_ctx=448, n_text_head=2,
            n_text_state=128, n_text_layer=2)
NO_GATE = dict(logprob_threshold=None, compression_ratio_threshold=None,
               no_speech_threshold=None)


def _t(x):
    return torch.from_numpy(np.array(x))


def _mlp_params(seed: int, d: int = 256, f: int = 1024):
    """fc1, fc2 as the JAX package stores them ({"w": [in, out], "b"})."""
    rng = np.random.default_rng(seed)
    fc1 = {"w": rng.uniform(-d ** -0.5, d ** -0.5, (d, f)).astype(np.float32),
           "b": rng.uniform(-d ** -0.5, d ** -0.5, f).astype(np.float32)}
    fc2 = {"w": rng.uniform(-f ** -0.5, f ** -0.5, (f, d)).astype(np.float32),
           "b": rng.uniform(-f ** -0.5, f ** -0.5, d).astype(np.float32)}
    return fc1, fc2


def _port_linear(p: dict, dtype) -> torch.nn.Module:
    """A JAX linear ({"w"} or int8 {"w_q", "w_s"}) as the port's module."""
    bias = _t(np.asarray(p["b"])).to(dtype)
    if "w_q" in p:
        return QuantLinear(_t(np.asarray(p["w_q"]).T), _t(np.asarray(p["w_s"])[0]), bias)
    lin = Linear(1, 1, device="meta")
    lin.weight = torch.nn.Parameter(_t(np.asarray(p["w"]).T).to(dtype), requires_grad=False)
    lin.bias = torch.nn.Parameter(bias, requires_grad=False)
    return lin


@pytest.mark.parametrize("m", [1, 8, 24])
@pytest.mark.parametrize("quantized", [False, True])
def test_fused_mlp_matches_jax_kernel_fp32(m, quantized):
    """fp32: the JAX test's tolerance (tests/test_timing.py), atol 2e-5."""
    fc1, fc2 = _mlp_params(m)
    if quantized:
        fc1, fc2 = jax_quantize_linear(fc1), jax_quantize_linear(fc2)
    x = (np.random.default_rng(100 + m).standard_normal((m, 256)) * 0.5).astype(np.float32)
    want = np.asarray(jax_fused_mlp(jnp.asarray(x), {"fc1": fc1, "fc2": fc2}, interpret=True))
    got = k8.fused_mlp(_t(x), _port_linear(fc1, torch.float32),
                       _port_linear(fc2, torch.float32)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("m", [1, 8, 24])
@pytest.mark.parametrize("quantized", [False, True])
def test_fused_mlp_matches_jax_kernel_bf16(m, quantized):
    """bf16 x, weights and biases (int8 codes with fp32 scales): both round
    h to bf16 before fc2 and the output to bf16. Tolerance: 2^-7 of the
    output's largest magnitude, one bf16 ulp at that scale (an h entry
    that rounds the other way moves the sums by one ulp of h times its
    fc2 row; the JAX kernel's rational erf differs from the exact one by
    1.5e-7)."""
    fc1, fc2 = _mlp_params(m)
    if quantized:
        fc1, fc2 = jax_quantize_linear(fc1), jax_quantize_linear(fc2)
    bf = jnp.bfloat16
    fc1, fc2 = ({k: (v if k in ("w_q", "w_s") else jnp.asarray(v, bf)) for k, v in p.items()}
                for p in (fc1, fc2))
    x = (np.random.default_rng(100 + m).standard_normal((m, 256)) * 0.5).astype(np.float32)
    want = np.asarray(jax_fused_mlp(jnp.asarray(x, bf), {"fc1": fc1, "fc2": fc2},
                                    interpret=True).astype(jnp.float32))
    port = [_port_linear({k: np.asarray(v.astype(jnp.float32)) if v.dtype == bf
                          else np.asarray(v) for k, v in p.items()}, torch.bfloat16)
            for p in (fc1, fc2)]
    got = k8.fused_mlp(_t(x).to(torch.bfloat16), *port)
    assert got.dtype == torch.bfloat16
    tol = 2 ** -7 * float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


def test_fused_mlp_refuses_int4_weights():
    lin = Linear(128, 512)
    lin.reset_random(torch.Generator().manual_seed(0))
    fc1 = quantize_linear(lin, bits=4)
    fc2 = quantize_linear(Linear(512, 128), bits=4)
    with pytest.raises(ValueError, match="int4"):
        k8.fused_mlp(torch.zeros(3, 128), fc1, fc2)


@pytest.mark.parametrize("weight_bytes", [1, 2])
@pytest.mark.parametrize("d", [384, 512, 768, 1024, 1280])
def test_fused_mlp_plan(d, weight_bytes):
    """K8's tilings of fc1 (N = 4D, K = D) and fc2 (N = D, K = 4D) at every
    Whisper width and every M from 1 to 256 on 132 SMs: blocks of 1 to 5
    strips of 16 weight rows dividing N; at most one wave (132 blocks); K
    split over a cluster of at most 8 blocks, each with a chunk (two where
    both warpgroups take its stages in turn, which they do up to 64 rows)
    and an even share of the block's columns to add; a ring of 1 to
    MAX_STAGES stages, a multiple of kgroups where it wraps, within an SM's
    227 KB. The scratch is h [M, F] bf16 alone, no fp32 partials. Where both
    blocks fit in half an SM the ring keeps at least MIN_SHARED_STAGES
    stages (or every chunk)."""
    f = 4 * d
    for m in range(1, k8.MAX_ROWS + 1):
        p = k8.plan(m, d, f, 132, weight_bytes)
        assert p.scratch_bytes == 2 * m * f
        for t, n, k, smem in ((p.fc1, f, d, p.smem[0]), (p.fc2, d, f, p.smem[1])):
            chunks, per = k // k8.CHUNK, -(-(k // k8.CHUNK) // t.split)
            assert t.bn in (16, 32, 48, 64, 80) and n % t.bn == 0
            assert t.split in (1, 2, 4, 8) and (t.bn // t.split) % 2 == 0
            assert n // t.bn * t.split <= 132
            assert t.kgroups == (2 if m <= 64 else 1)  # every width has 6+ chunks
            assert chunks - (t.split - 1) * per >= t.kgroups
            assert 1 <= t.stages <= min(per, k8.MAX_STAGES)
            assert t.stages == per or t.stages % t.kgroups == 0
            assert smem == k8.smem_bytes(m, t, weight_bytes) <= k8.SMEM_MAX
            if smem <= k8.SMEM_SHARED:
                assert t.stages >= min(per, k8.MAX_STAGES, k8.MIN_SHARED_STAGES)


@pytest.mark.parametrize("weight_bytes, stages", [(1, 8), (2, 6)])
def test_fused_mlp_plan_fills_the_card_at_large_v1(weight_bytes, stages):
    """At large-v1 and a greedy step's 24 rows each product runs 128 blocks
    of 132 (the old kernel 80 of 128 threads): fc1 80 hidden units a block,
    K split by 2; fc2 80 outputs a block, K split by 8; both warpgroups take
    a block's stages in turn, and a block of each product fits one SM."""
    p = k8.plan(24, 1280, 5120, 132, weight_bytes)
    assert p.fc1 == k8.Tiling(80, 2, stages, 2) and p.fc2 == k8.Tiling(80, 8, stages, 2)
    assert sum(p.smem) + 2 * 1024 <= 228 * 1024
    assert p.scratch_bytes == 24 * 5120 * 2


@pytest.mark.parametrize("m, d, f", [(0, 1280, 5120), (257, 1280, 5120), (24, 1312, 5120),
                                     (24, 1280, 5152)])
def test_fused_mlp_plan_refuses_shapes_outside_its_contract(m, d, f):
    with pytest.raises(ValueError):
        k8.plan(m, d, f, 132)


@pytest.fixture(scope="module")
def pair():
    jm = JaxWhisper(JaxDims(**DIMS), seed=3)
    tm = wat.Whisper(wat.ModelDimensions(**DIMS))
    tm.load_state_dict(from_jax_params(jm.params))
    return jm, tm


def test_fused_mlp_switch_raises_with_int4_weights(pair, monkeypatch):
    """FUSED_MLP with weight_bits=4: K8 has no int4 entry, so the decode
    refuses loudly rather than skipping the kernel."""
    _, tm = pair
    monkeypatch.setattr(decoder, "FUSED_MLP", True)
    mel = torch.zeros((1, 80, 3000))
    with pytest.raises(ValueError, match="int4"):
        wat.decode(tm, mel, wat.DecodingOptions(language="en", fp16=False, sample_len=2,
                                                weight_quant=True, weight_bits=4))


@pytest.mark.parametrize("weight_quant", [False, True])
def test_fused_mlp_over_a_prefill_covers_every_row(pair, monkeypatch, weight_quant):
    """decoder_forward over a 5-token prefill: with FUSED_MLP every row's
    hidden state equals the unfused MLP's (fp32, 1e-5). The JAX decoder
    feeds its kernel the first position only (`normed[:, 0]`), which would
    give every row the first row's MLP; that fault is not carried over."""
    _, tm = pair
    params = tm.decoder_params_decode(weight_quant=weight_quant)
    xa = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 1500, 128))
                          .astype(np.float32))
    cross = precompute_cross_kv(params, xa, 2, quantize=True)
    tokens = torch.tensor([[50258, 50259, 50359, 440, 1002], [50258, 50259, 50359, 50363, 11]])
    hidden = {}
    for fused in (False, True):
        monkeypatch.setattr(decoder, "FUSED_MLP", fused)
        cache = init_cache(2, 2, 16, 128, torch.float32, 2, quantize=True)
        hidden[fused] = decoder_forward(params, tokens, cross, cache, 0, 0, 2)
    np.testing.assert_allclose(hidden[True].numpy(), hidden[False].numpy(), atol=1e-5, rtol=0)
    # the rows differ from one another, so a first-row broadcast would fail
    assert float((hidden[True][:, 1:] - hidden[True][:, :1]).abs().min()) > 0


@pytest.mark.parametrize("weight_quant", [False, True])
def test_fused_mlp_switch_leaves_a_prefill_over_max_rows_unfused(pair, monkeypatch,
                                                                 weight_quant):
    """With FUSED_MLP on and K8's row cap below a prefill's B*S rows, the
    decoder sends none of them to K8 and gives the unfused path's hidden
    states bit for bit; a prefill within the cap still goes through it, one
    call a layer."""
    _, tm = pair
    params = tm.decoder_params_decode(weight_quant=weight_quant)
    xa = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 1500, 128))
                          .astype(np.float32))
    cross = precompute_cross_kv(params, xa, 2, quantize=True)
    tokens = torch.tensor([[50258, 50259, 50359, 440, 1002], [50258, 50259, 50359, 50363, 11]])
    calls = []
    monkeypatch.setattr(decoder, "fused_mlp", lambda *a: calls.append(a) or k8.fused_mlp(*a))

    def forward(fused: bool, max_rows: int):
        monkeypatch.setattr(decoder, "FUSED_MLP", fused)
        monkeypatch.setattr(k8, "MAX_ROWS", max_rows)
        cache = init_cache(2, 2, 16, 128, torch.float32, 2, quantize=True)
        return decoder_forward(params, tokens, cross, cache, 0, 0, 2)

    unfused = forward(False, 256)
    over = forward(True, tokens.numel() - 1)
    assert calls == []
    assert torch.equal(over, unfused)
    forward(True, tokens.numel())
    assert len(calls) == len(params.blocks)
    assert all(a[0].shape == (tokens.numel(), 128) for a in calls)


def test_transcribe_batched_with_every_switch_matches_jax(pair, monkeypatch):
    """The port's transcribe_batched with ENC_ATTN=flash (K7),
    CROSS_DECODE=stream (K10) and FUSED_MLP (K8, int8 weights) against the
    JAX package's default path on the same weights (its fused layout, K4 in
    interpret mode), int8 cross K/V, weights and self cache, over 65 s: the
    same segments, tokens and text in fp32, tags to 1e-4."""
    jm, tm = pair
    rng = np.random.default_rng(1)
    t = np.arange(16000 * 65) / 16000.0
    audio = (np.clip(0.3 * np.sin(2 * np.pi * 330 * t) + 0.05 * rng.standard_normal(len(t)),
                     -1, 1) * 32767).astype(np.int16)
    kw = dict(language="en", temperature=0.0, sample_len=24, fp16=False, max_batch=2,
              kv_quant=True, weight_quant=True, self_kv_quant=True, **NO_GATE)
    ref = jax_wat.transcribe_batched(jm, audio, kv_layout="fused", **kw)
    monkeypatch.setenv("WHISPER_AT_TPU_ENC_ATTN", "flash")
    monkeypatch.setenv(decoder.CROSS_DECODE_ENV, "stream")
    monkeypatch.setattr(decoder, "FUSED_MLP", True)
    out = wat.transcribe_batched(tm, audio, **kw)
    assert out["text"] == ref["text"]
    assert len(out["segments"]) == len(ref["segments"]) > 0
    for s, r in zip(out["segments"], ref["segments"]):
        assert s["tokens"] == r["tokens"]
        assert s["text"] == r["text"]
        assert (s["seek"], s["start"], s["end"]) == (r["seek"], r["start"], r["end"])
        assert s["avg_logprob"] == pytest.approx(r["avg_logprob"], abs=1e-4)
    np.testing.assert_allclose(out["audio_tag"], ref["audio_tag"], atol=1e-4, rtol=0)

