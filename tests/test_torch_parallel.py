"""The port's parallelism (`whisper_at_tpu_torch/parallel`) against the JAX
package on its mesh tests' tiny dims (D 64, 4 heads, 2 layers).

Each world size runs once: a module fixture starts 2 (then 4) rank
processes on a gloo group (`torch_mesh_worker.py`), which run every case of
the suite; each test below asserts its own case. The JAX package runs here,
in the test process, on the same weights (`convert.from_jax_params`); the
ranks import only torch and the port. fp32 throughout, with the JAX mesh
tests' tolerances: tokens exact, features and taps 2e-5 (pp 1e-5 absolute,
sp 1e-5), avg_logprob 1e-4, tags 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisper_at_tpu as jax_wat
from whisper_at_tpu.models.dims import ModelDimensions as JaxDims
from whisper_at_tpu.models.encoder import encoder_apply as jax_encoder_apply
from whisper_at_tpu.models.encoder import init_encoder
from whisper_at_tpu.models.whisper import Whisper as JaxWhisper
import whisper_at_tpu_torch as wat
from whisper_at_tpu_torch.convert import from_jax_params

from torch_mesh_worker import run_ranks, value

DIMS = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4,
            n_audio_layer=2, n_vocab=51865, n_text_ctx=448, n_text_head=4,
            n_text_state=64, n_text_layer=2)
ENC_DIMS = dict(DIMS, n_audio_layer=4, n_vocab=100)
NO_GATE = dict(logprob_threshold=None, compression_ratio_threshold=None,
               no_speech_threshold=None)
BASE = dict(language="en", fp16=False, temperature=0.0, sample_len=24, **NO_GATE)
INT8 = dict(kv_quant=True, weight_quant=True)
DECODE = {"greedy": dict(language="en", fp16=False, sample_len=12),
          "int8": dict(language="en", fp16=False, sample_len=12, **INT8),
          "beam": dict(language="en", fp16=False, sample_len=12, beam_size=2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's passes here run on one thread, which keeps the file's time
    steady when other test processes share the cores (a thread pool per
    process oversubscribes them)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _audio(seconds: int, seed: int) -> np.ndarray:
    return (0.2 * np.random.default_rng(seed).standard_normal(16000 * seconds)
            ).astype(np.float32)


@pytest.fixture(scope="module")
def jax_model():
    return JaxWhisper(JaxDims(**DIMS), seed=7)


@pytest.fixture(scope="module")
def port_model(jax_model):
    model = wat.Whisper(wat.ModelDimensions(**DIMS))
    model.load_state_dict(from_jax_params(jax_model.params))
    return model.eval()


@pytest.fixture(scope="module")
def enc_params():
    return init_encoder(jax.random.PRNGKey(0), JaxDims(**ENC_DIMS))


def _payload(jax_model, enc_params, max_batch: int) -> dict:
    # the pp / sp model: the JAX encoder of 4 layers in a port model of its dims
    enc_model = wat.Whisper(wat.ModelDimensions(**ENC_DIMS))
    state = enc_model.state_dict()
    converted = from_jax_params(dict(jax_model.params, encoder=enc_params))
    state.update({k: v for k, v in converted.items() if k.startswith("encoder.")})
    mel = (np.random.default_rng(5).standard_normal((1, 80, 3000)) * 0.4).astype(np.float32)
    return dict(
        model=dict(dims=DIMS, state=from_jax_params(jax_model.params)),
        encoder_model=dict(dims=ENC_DIMS, state=state),
        enc_mel=np.random.default_rng(0).standard_normal((4, 80, 3000)).astype(np.float32),
        mel=mel,
        decode=DECODE,
        transcribe={"greedy": (_audio(65, 2), dict(BASE, max_batch=max_batch)),
                    "int8": (_audio(35, 5), dict(BASE, max_batch=max_batch, **INT8))},
        many=([_audio(s, 10 + s) for s in (12, 40, 0)], dict(BASE, max_batch=max_batch)),
        tp_words=(_audio(20, 3), dict(BASE, word_timestamps=True)),
        stream=(_audio(40, 4), dict(language="en", fp16=False, temperature=0.0,
                                    sample_len=24, **NO_GATE)),
    )


@pytest.fixture(scope="module")
def ranks2(jax_model, enc_params, tmp_path_factory):
    return run_ranks(2, "parallel2", _payload(jax_model, enc_params, 2),
                     tmp_path_factory.mktemp("mesh2"))


@pytest.fixture(scope="module")
def ranks4(jax_model, enc_params, tmp_path_factory):
    return run_ranks(4, "parallel4", _payload(jax_model, enc_params, 4),
                     tmp_path_factory.mktemp("mesh4"))


@pytest.fixture(scope="module")
def jax_transcribe(jax_model):
    payload = _payload_inputs()
    return {name: jax_wat.transcribe_batched(jax_model, audio, **dict(kw, max_batch=2))
            for name, (audio, kw) in payload.items()}


def _payload_inputs():
    return {"greedy": (_audio(65, 2), BASE), "int8": (_audio(35, 5), dict(BASE, **INT8))}


@pytest.fixture(scope="module")
def port_single(port_model):
    return {name: wat.transcribe_batched(port_model, audio, **dict(kw, max_batch=2))
            for name, (audio, kw) in _payload_inputs().items()}


def _assert_same_result(got: dict, ref: dict, tag_atol: float = 1e-4):
    assert got["text"] == ref["text"]
    assert got["tokens"] == [s["tokens"] for s in ref["segments"]]
    np.testing.assert_allclose(got["avg_logprob"], [s["avg_logprob"] for s in ref["segments"]],
                               atol=1e-4)
    np.testing.assert_allclose(got["audio_tag"], ref["audio_tag"], atol=tag_atol)


def _ranks(request, world: int):
    return request.getfixturevalue(f"ranks{world}")


# ---------------------------------------------------------------------- #
# mesh and batch
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("world", [2, 4])
def test_make_mesh_shapes(request, world):
    results = _ranks(request, world)
    for rank in range(world):
        got = value(results, "mesh_shapes", rank)
        shape, coords, ranks = got["shapes"][1]
        assert shape == {"dp": world, "tp": 1}
        assert coords == {"dp": rank, "tp": 0}
        assert ranks["dp"] == list(range(world)) and ranks["tp"] == [rank]
        shape, coords, ranks = got["shapes"][2]
        assert shape == {"dp": world // 2, "tp": 2}
        assert coords == {"dp": rank // 2, "tp": rank % 2}
        assert ranks["tp"] == [rank - rank % 2, rank - rank % 2 + 1]
        assert got["refused"]


def test_shard_batch_gives_each_rank_its_slice(ranks2):
    x = np.arange(32, dtype=np.float32).reshape(8, 4)
    for rank in range(2):
        got = value(ranks2, "batch_slices", rank)
        np.testing.assert_array_equal(got["batch"], x[4 * rank:4 * rank + 4])
        assert got["pair"].tolist() == list(range(4 * rank, 4 * rank + 4))
        assert got["share"] == [[0, 1, 2, 3], [4, 5, 6]][rank]
        assert got["windows"] == [[0, 1, 2], [3, 4]][rank]


def test_tltr_param_shardings_split_heads():
    """The JAX package's `_tltr_param_spec`, in torch's [out, in] layout:
    query / key / value / fc1 split on the output axis with their biases,
    out / fc2 on the input axis, everything else whole."""
    from whisper_at_tpu.parallel.mesh import _tltr_param_spec
    from whisper_at_tpu.train.tltr import init_tltr as jax_init_tltr
    from whisper_at_tpu_torch.convert import tltr_from_jax_params
    from whisper_at_tpu_torch.parallel.mesh import tltr_param_shardings
    from whisper_at_tpu_torch.train.tltr import TLTR

    head = TLTR(8, 2, 64, "lw_tr_1_4")
    rules = tltr_param_shardings(head)
    assert rules["time_tr.attn.query.weight"] == 0 and rules["time_tr.attn.query.bias"] == 0
    assert rules["layer_tr.attn.key.weight"] == 0 and rules["time_tr.mlp.0.bias"] == 0
    assert rules["time_tr.attn.out.weight"] == 1 and rules["layer_tr.mlp.2.weight"] == 1
    for name in ("time_tr.attn.out.bias", "time_tr.attn_ln.weight", "mlp.weight", "mlp.bias",
                 "mlp_ln.weight", "layer_tr.mlp.2.bias"):
        assert rules[name] is None, name
    # the JAX rule, leaf for leaf: its [in, out] axis of the split as a
    # torch [out, in] axis, under the port's name of the leaf
    params = jax_init_tltr(jax.random.PRNGKey(0), label_dim=8, n_layer=2, rep_dim=64,
                           mode="lw_tr_1_4")
    names = {"fc1": "0", "fc2": "2", "w": "weight", "b": "bias", "scale": "weight"}
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    jax_rules = {}
    for path, leaf in flat:
        parts = [getattr(k, "key", str(k)) for k in path]
        spec = tuple(_tltr_param_spec(parts, leaf))
        port_name = ".".join(names.get(p, p) for p in parts)
        jax_rules[port_name] = None if "tp" not in spec else leaf.ndim - 1 - spec.index("tp")
    assert set(tltr_from_jax_params(params, list(head.state_dict()))) == set(rules)
    assert jax_rules == rules


# ---------------------------------------------------------------------- #
# dp inference
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("world", [2, 4])
def test_batched_transcribe_on_mesh(request, world, jax_transcribe, port_single):
    """dp-split windows give every rank the single-device result: the JAX
    package's and the port's own."""
    results = _ranks(request, world)
    for rank in range(world):
        got = value(results, "dp_transcribe", rank)["greedy"]
        _assert_same_result(got, jax_transcribe["greedy"])
        _assert_same_result(got, port_single["greedy"], tag_atol=1e-5)


def test_mesh_inference_with_quantization(ranks2, jax_transcribe, port_single):
    """int8 cross K/V and weights on the mesh: the single-device text."""
    for rank in range(2):
        got = value(ranks2, "dp_transcribe", rank)["int8"]
        assert got["text"] == jax_transcribe["int8"]["text"]
        _assert_same_result(got, port_single["int8"], tag_atol=1e-5)


def test_transcribe_many_on_mesh(ranks2, port_model):
    audios, kwargs = _payload_inputs_many()
    ref = wat.transcribe_many(port_model, audios, **kwargs)
    for rank in range(2):
        got = value(ranks2, "dp_transcribe_many", rank)
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _assert_same_result(g, r, tag_atol=1e-5)


def _payload_inputs_many():
    return [_audio(s, 10 + s) for s in (12, 40, 0)], dict(BASE, max_batch=2)


# ---------------------------------------------------------------------- #
# tp inference
# ---------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def jax_tp_refs(jax_model):
    mel = jnp.asarray((np.random.default_rng(5).standard_normal((1, 80, 3000)) * 0.4
                       ).astype(np.float32))
    feats, at = jax_model.embed_audio(mel, fp16=False)
    decoded = {name: jax_wat.decode(jax_model, mel[0], jax_wat.DecodingOptions(**options))
               for name, options in DECODE.items()}
    return dict(features=np.asarray(feats), taps=np.asarray(at), **decoded)


@pytest.mark.parametrize("world", [2, 4])
def test_tensor_parallel_encoder_matches_single_device(request, world, jax_tp_refs):
    results = _ranks(request, world)
    for rank in range(world):
        got = value(results, "tp_decode", rank)
        assert got["heads"] == (2, 2)
        assert got["qkv"] == (3 * 32, 64)  # this rank's [q|k|v] rows: 2 heads of 16 each
        np.testing.assert_allclose(got["features"].numpy(), jax_tp_refs["features"],
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got["taps"].numpy(), jax_tp_refs["taps"],
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["greedy", "int8", "beam"])
def test_tensor_parallel_decode_matches_single_device(request, world, name, jax_tp_refs,
                                                      port_model):
    """Megatron-split decoder (tp 2; dp 2 x tp 2 on four ranks): the
    unsharded tokens, greedy, int8 and beam 2."""
    results = _ranks(request, world)
    ref = jax_tp_refs[name]
    mel = torch.from_numpy((np.random.default_rng(5).standard_normal((1, 80, 3000)) * 0.4
                            ).astype(np.float32))
    own = wat.decode(port_model, mel[0], wat.DecodingOptions(**DECODE[name]))
    for rank in range(world):
        got = value(results, "tp_decode", rank)[name]
        assert got["tokens"] == list(ref.tokens) == list(own.tokens)
        assert got["avg_logprob"] == pytest.approx(float(ref.avg_logprob), abs=1e-4)


def test_tensor_parallel_word_timestamps(ranks2, port_model):
    """The alignment heads' logits gathered from the tp ranks give the
    single-device word times."""
    audio, kwargs = _audio(20, 3), dict(BASE, word_timestamps=True)
    ref = [[(w["word"], w["start"], w["end"]) for w in s["words"]]
           for s in wat.transcribe_batched(port_model, audio, **kwargs)["segments"]]
    assert sum(map(len, ref)) > 0
    for rank in range(2):
        assert value(ranks2, "tp_decode", rank)["words"] == ref


# ---------------------------------------------------------------------- #
# pp and sp encoders
# ---------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def jax_encoder_refs(enc_params):
    mel = jnp.asarray(np.random.default_rng(0).standard_normal((4, 80, 3000)), jnp.float32)
    x, taps = jax_encoder_apply(enc_params, mel, 4, attn_impl="off")
    return np.asarray(x), np.asarray(taps)


@pytest.mark.parametrize("world", [2, 4])
def test_pipeline_parallel_encoder_matches_single_device(request, world, jax_encoder_refs):
    """GPipe over `world` stages, one microbatch a row and two
    microbatches: the single-device hidden states and pooled taps."""
    x0, taps0 = jax_encoder_refs
    results = _ranks(request, world)
    for rank in range(world):
        for n_micro, (x, taps) in value(results, "pp_encoder", rank).items():
            assert x.shape == x0.shape and taps.shape == taps0.shape, n_micro
            np.testing.assert_allclose(x.numpy(), x0, rtol=0, atol=1e-5)
            np.testing.assert_allclose(taps.numpy(), taps0, rtol=0, atol=1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_sequence_parallel_encoder_matches_single_device(request, world, jax_encoder_refs):
    """Ring attention over `world` shards (375-frame chunks at 4: the pooled
    windows straddle every chunk edge)."""
    x0, taps0 = jax_encoder_refs
    results = _ranks(request, world)
    for rank in range(world):
        x, taps = value(results, "sp_encoder", rank)
        assert x.shape == x0[:2].shape and taps.shape == taps0[:2].shape
        np.testing.assert_allclose(x.numpy(), x0[:2], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(taps.numpy(), taps0[:2], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------- #
# services
# ---------------------------------------------------------------------- #

def test_transcription_service_on_a_mesh(ranks2, port_model):
    """Rank 0 takes the requests and leads each batch; rank 1 follows and
    refuses requests of its own; the results are the mesh-free ones."""
    audios, kwargs = _payload_inputs_many()
    ref = wat.transcribe_many(port_model, audios, **kwargs)
    got = value(ranks2, "services", 0)["serving"]
    for g, r in zip(got, ref):
        _assert_same_result(g, r, tag_atol=1e-5)
    assert value(ranks2, "services", 1)["refused"]


def test_streaming_service_on_a_mesh(ranks2, port_model):
    audio, options = _audio(40, 4), dict(language="en", fp16=False, temperature=0.0,
                                         sample_len=24, **NO_GATE)
    service = wat.StreamingService(port_model, max_batch=4)
    session = service.open(**options)
    for lo in range(0, len(audio), 16000 * 7):
        session.feed(audio[lo:lo + 16000 * 7])
    ref = session.finish()
    service.close()
    got = value(ranks2, "services", 0)["streaming"]
    assert got["text"] == ref["text"]
    assert got["tokens"] == [s["tokens"] for s in ref["segments"]]


# ---------------------------------------------------------------------- #
# single-process rules of the slice
# ---------------------------------------------------------------------- #

def test_heads_layout_decodes_through_the_fused_layout(port_model):
    mel = torch.from_numpy((np.random.default_rng(6).standard_normal((2, 80, 3000)) * 0.4
                            ).astype(np.float32))
    opts = dict(language="en", fp16=False, sample_len=12, **INT8)
    fused = wat.decode(port_model, mel, wat.DecodingOptions(**opts))
    heads = wat.decode(port_model, mel, wat.DecodingOptions(kv_layout="heads", **opts))
    for f, h in zip(fused, heads):
        assert h.tokens == f.tokens and h.avg_logprob == f.avg_logprob
    with pytest.raises(ValueError, match="kv_layout"):
        wat.DecodingOptions(kv_layout="rows") and wat.decode(
            port_model, mel, wat.DecodingOptions(kv_layout="rows", **opts))


@pytest.mark.parametrize("tp", [2, 4])
def test_k2_partial_twins_sum_to_the_whole(tp):
    """K2-partial's plain version over each rank's F / tp hidden units,
    summed over the ranks, plus x + b2: the whole K2 twin's output."""
    from whisper_at_tpu_torch.ops.enc_mlp import enc_mlp_partial, enc_mlp_plain

    gen = torch.Generator().manual_seed(tp)
    d, f = 128, 512
    x = torch.randn(2, 30, d, generator=gen)
    ln_w, ln_b = torch.rand(d, generator=gen) + 0.5, torch.randn(d, generator=gen) * 0.1
    w1, b1 = torch.randn(f, d, generator=gen) * d ** -0.5, torch.randn(f, generator=gen) * 0.1
    w2, b2 = torch.randn(d, f, generator=gen) * f ** -0.5, torch.randn(d, generator=gen) * 0.1
    parts = sum(enc_mlp_partial(x, ln_w, ln_b, w1.chunk(tp)[r], b1.chunk(tp)[r],
                                w2.chunk(tp, dim=1)[r]) for r in range(tp))
    np.testing.assert_allclose((x + parts + b2).numpy(),
                               enc_mlp_plain(x, ln_w, ln_b, w1, b1, w2, b2).numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("bits", [8, 4])
def test_k3_twin_at_a_rank_width_is_its_heads(tp, bits):
    """K3's plain version on a rank's [D / tp, D] weights: that rank's
    heads of the whole layer's codes and scales, bit for bit."""
    from whisper_at_tpu_torch.ops.kv_quant import project_quantize_kv_plain

    gen = torch.Generator().manual_seed(bits + tp)
    d, b, ta = 256, 2, 150
    xa = torch.randn(b, ta, d, generator=gen)
    wk, wv = (torch.randn(d, d, generator=gen) * d ** -0.5 for _ in range(2))
    bv = torch.randn(d, generator=gen) * 0.02
    whole = project_quantize_kv_plain(xa, wk, wv, bv, bits=bits)
    n = d // tp
    for r in range(tp):
        rows = slice(r * n, (r + 1) * n)
        part = project_quantize_kv_plain(xa, wk[rows], wv[rows], bv[rows], bits=bits)
        code_rows = slice(r * n * bits // 8, (r + 1) * n * bits // 8)
        heads = slice(r * n // 64, (r + 1) * n // 64)
        for i in (0, 2):
            assert torch.equal(part[i], whole[i][..., code_rows])
        for i in (1, 3):
            assert torch.equal(part[i], whole[i][:, heads])
