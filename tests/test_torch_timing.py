"""The port's word-timing pieces against the JAX package: DTW (K6's plain
version and the host backtrace), the median filter, the alignment-head
masks, word splitting, the alignment forward, the weight chain, token
probabilities, `find_alignment` (solo and batched) and the word carving.

Inputs come from numpy with a seed and go to both packages. The JAX side
runs its Pallas DTW in interpret mode where the Pallas kernel is the
reference, as the JAX package's own tests do. All model comparisons are
fp32 on a 2-layer, 128-wide model with the real vocabulary.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_at_tpu import timing as jax_timing
from whisper_at_tpu.models.decoder import decoder_forward_with_qk as jax_forward_with_qk
from whisper_at_tpu.models.dims import ModelDimensions as JaxDims
from whisper_at_tpu.models.whisper import Whisper as JaxWhisper
from whisper_at_tpu.models.whisper import decode_alignment_heads as jax_decode_heads
from whisper_at_tpu.ops.dtw import dtw as jax_dtw
from whisper_at_tpu.ops.dtw_pallas import _dtw_device
from whisper_at_tpu.ops.median import median_filter as jax_median
from whisper_at_tpu.registry import _ALIGNMENT_HEADS as JAX_HEADS
from whisper_at_tpu.tokenizer import get_tokenizer as jax_get_tokenizer
import whisper_at_tpu_torch as wat
from whisper_at_tpu_torch import timing
from whisper_at_tpu_torch.convert import from_jax_params
from whisper_at_tpu_torch.models.decoder import decoder_forward_with_qk
from whisper_at_tpu_torch.models.dims import dims_for
from whisper_at_tpu_torch.models.whisper import decode_alignment_heads, default_alignment_heads
from whisper_at_tpu_torch.ops import dtw as port_dtw
from whisper_at_tpu_torch.ops.median import median_filter
from whisper_at_tpu_torch.registry import _ALIGNMENT_HEADS
from whisper_at_tpu_torch.tokenizer import get_tokenizer

pytestmark = pytest.mark.quick

DIMS = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=128, n_audio_head=2,
            n_audio_layer=2, n_vocab=51865, n_text_ctx=448, n_text_head=2,
            n_text_state=128, n_text_layer=2)
HEADS = np.array([[True, False], [True, True]])  # 3 of the 4 heads, both layers


@pytest.fixture(scope="module")
def pair():
    jm = JaxWhisper(JaxDims(**DIMS), seed=5)
    jm.alignment_heads = HEADS.copy()
    tm = wat.Whisper(wat.ModelDimensions(**DIMS))
    tm.load_state_dict(from_jax_params(jm.params))
    tm.alignment_heads = jm.alignment_heads.copy()
    return jm, tm


@pytest.fixture(scope="module")
def tokenizer():
    return get_tokenizer(True, language="en", task="transcribe")


@pytest.fixture(scope="module")
def jax_tokenizer():
    return jax_get_tokenizer(True, language="en", task="transcribe")


def _cost(rng, shape, integer=False):
    """fp32-representable costs (so the float64 DP sees the same values);
    small integers force ties."""
    if integer:
        return rng.integers(-2, 3, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _path(x: np.ndarray) -> np.ndarray:
    """The port's float64 DTW path through one matrix (plain DP + backtrace)."""
    return port_dtw.dtw_paths(torch.from_numpy(x)[None], [x.shape[0]])[0]


# --------------------------------------------------------------------------- #
# DTW
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("shape", [(1, 1), (5, 9), (33, 14), (101, 1500)])
def test_dtw_float64_path_equals_jax(shape, integer):
    x = _cost(np.random.default_rng(shape[0] * 7 + shape[1]), shape, integer)
    np.testing.assert_array_equal(_path(x), jax_dtw(x))


def _unskew(trace: np.ndarray, n: int, m: int) -> np.ndarray:
    i = np.arange(n + 1)[:, None]
    j = np.arange(m + 1)[None, :]
    return trace[i + j, i]


@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("shape", [(5, 9), (33, 14), (12, 40)])
def test_dtw_float32_trace_equals_pallas_kernel(shape, integer):
    """The plain trace, unskewed, equals the Pallas kernel's trace bit for
    bit over the whole (N+1) x (M+1) grid, borders included."""
    n, m = shape
    x = _cost(np.random.default_rng(n * 13 + m), shape, integer)
    _, ref = _dtw_device(jnp.asarray(x), n, m, interpret=True)
    trace = port_dtw.dtw_trace_plain(torch.from_numpy(x)[None],
                                     torch.tensor([n], dtype=torch.int32), torch.float32)
    np.testing.assert_array_equal(_unskew(trace[0].numpy(), n, m), np.asarray(ref))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dtw_ragged_batch_equals_single_rows(dtype):
    """Rows of a batch with their own valid lengths: each row's trace (over
    its own cells) and path equal a solo call on its own matrix; cells past
    a row's length stay -1 and NaN there does not reach the row."""
    rng = np.random.default_rng(3)
    m, lengths = 23, [7, 1, 12, 4]
    x = _cost(rng, (len(lengths), max(lengths), m))
    for g, n in enumerate(lengths):
        x[g, n:] = np.nan
    batch = port_dtw.dtw_trace_plain(torch.from_numpy(x),
                                     torch.tensor(lengths, dtype=torch.int32), dtype).numpy()
    paths = port_dtw.dtw_paths(torch.from_numpy(x), lengths, dtype)
    for g, n in enumerate(lengths):
        solo = port_dtw.dtw_trace_plain(torch.from_numpy(x[g:g + 1, :n]),
                                        torch.tensor([n], dtype=torch.int32), dtype).numpy()
        np.testing.assert_array_equal(_unskew(batch[g], n, m), _unskew(solo[0], n, m))
        assert (batch[g][:, n + 1:] == -1).all()
        np.testing.assert_array_equal(paths[g], jax_dtw(x[g, :n]))


def test_dtw_infinities_and_nan_follow_numpy():
    """+inf - inf and comparisons with NaN resolve as numpy resolves them."""
    x = np.array([[0.0, np.inf, -np.inf, 1.0],
                  [np.nan, 2.0, -np.inf, 0.0],
                  [1.0, np.inf, 3.0, np.nan]], np.float32)
    np.testing.assert_array_equal(_path(x), jax_dtw(x))


def test_dtw_rejects_bad_shapes():
    with pytest.raises(ValueError):
        port_dtw.dtw_trace(torch.zeros(2, 3, 4), torch.tensor([3], dtype=torch.int32))
    with pytest.raises(ValueError):
        port_dtw.dtw_trace(torch.zeros(1, 3, 4), torch.tensor([3], dtype=torch.int32),
                           torch.float16)


# --------------------------------------------------------------------------- #
# median filter, alignment heads, word splitting
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("length", [1, 2, 3, 40])
@pytest.mark.parametrize("width", [1, 3, 7])
def test_median_filter_equals_jax(width, length):
    x = np.random.default_rng(width * 10 + length).standard_normal(
        (2, 3, length)).astype(np.float32)
    np.testing.assert_array_equal(median_filter(torch.from_numpy(x), width).numpy(),
                                  np.asarray(jax_median(jnp.asarray(x), width)))


def test_alignment_heads_decode_as_jax():
    assert set(_ALIGNMENT_HEADS) == set(JAX_HEADS)
    for name, dump in _ALIGNMENT_HEADS.items():
        assert dump == JAX_HEADS[name]
        dims = dims_for(name)
        np.testing.assert_array_equal(decode_alignment_heads(dump, dims),
                                      jax_decode_heads(dump, JaxDims(**vars(dims))))
    model = wat.build_model("tiny", device="cpu")
    np.testing.assert_array_equal(model.alignment_heads,
                                  JaxWhisper(JaxDims(**vars(model.dims))).alignment_heads)
    np.testing.assert_array_equal(default_alignment_heads(model.dims)[2:], True)
    model.set_alignment_heads(_ALIGNMENT_HEADS["tiny"])
    assert model.alignment_heads.sum() == 6
    with pytest.raises(ValueError):
        model.set_alignment_heads(_ALIGNMENT_HEADS["large-v1"])


@pytest.mark.parametrize("language, text", [
    ("en", " Hello, world! It's a test-case (really): \"quoted\" words... ¿Qué tal?"),
    ("en", " naïve café déjà vu — 3.14 %"),
    ("zh", "我们今天去公园。你好吗？"),
    ("ja", "東京は晴れです、今日は。"),
])
def test_split_to_word_tokens_equals_jax(language, text):
    ours = get_tokenizer(True, language=language, task="transcribe")
    ref = jax_get_tokenizer(True, language=language, task="transcribe")
    tokens = ours.encode(text) + [ours.eot]
    assert ours.split_to_word_tokens(tokens) == ref.split_to_word_tokens(tokens)


# --------------------------------------------------------------------------- #
# the alignment forward, the weight chain and token probabilities
# --------------------------------------------------------------------------- #


def _slots(mask: np.ndarray):
    n_sel = int(mask.sum())
    slot = np.full(mask.shape, n_sel, np.int32)
    slot[mask] = np.arange(n_sel)
    return jnp.asarray(slot), n_sel


def test_decoder_forward_with_qk_equals_jax(pair, tokenizer):
    jm, tm = pair
    rng = np.random.default_rng(2)
    xa = (rng.standard_normal((2, 1500, 128)) * 0.5).astype(np.float32)
    toks = rng.integers(0, tokenizer.eot, (2, 13))
    slot, n_sel = _slots(HEADS)
    ref_logits, ref_qk = jax_forward_with_qk(jm.params["decoder"], jnp.asarray(toks),
                                             jnp.asarray(xa), slot, 2, n_sel, jnp.float32)
    logits, qk = decoder_forward_with_qk(tm.decoder, torch.from_numpy(toks),
                                         torch.from_numpy(xa), HEADS, 2, torch.float32)
    assert qk.shape == (2, 3, 13, 1500) and qk.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=1e-4, rtol=0)
    np.testing.assert_allclose(qk.numpy(), np.asarray(ref_qk), atol=1e-5, rtol=0)

    # a right-padded row equals the same row alone on its valid positions
    short = decoder_forward_with_qk(tm.decoder, torch.from_numpy(toks[1:, :7]),
                                    torch.from_numpy(xa[1:]), HEADS, 2, torch.float32)
    np.testing.assert_allclose(logits[1:, :7].numpy(), short[0].numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(qk[1:, :, :7].numpy(), short[1].numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("lens", [None, [13, 6, 9]])
def test_process_qk_weights_equals_jax(lens):
    rng = np.random.default_rng(4)
    qk = (rng.standard_normal((3, 3, 13, 1500)) * 2).astype(np.float32)
    ref = np.asarray(jax_timing._process_qk_weights(
        jnp.asarray(qk), 2000, 1.0, 7,
        lens=None if lens is None else jnp.asarray(lens, jnp.int32)))
    out = timing._process_qk_weights(torch.from_numpy(qk), 2000, 1.0, 7,
                                     lens=None if lens is None else torch.tensor(lens))
    assert out.shape == (3, 13, 1000)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=0)


def test_token_probs_equal_jax(tokenizer):
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((2, 10, 51865)) * 3).astype(np.float32)
    toks = rng.integers(0, 51865, (2, 10))
    ref = np.asarray(jax_timing._token_probs_from_logits(
        jnp.asarray(logits), jnp.asarray(toks), 3, tokenizer.eot))
    out = timing._token_probs_from_logits(torch.from_numpy(logits), torch.from_numpy(toks), 3,
                                          tokenizer.eot)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=0)


# --------------------------------------------------------------------------- #
# find_alignment, solo and batched
# --------------------------------------------------------------------------- #


def _assert_same_words(ours, ref):
    assert [w.word for w in ours] == [w.word for w in ref]
    assert [w.tokens for w in ours] == [w.tokens for w in ref]
    assert [w.start for w in ours] == [w.start for w in ref]
    assert [w.end for w in ours] == [w.end for w in ref]
    np.testing.assert_allclose([w.probability for w in ours],
                               [w.probability for w in ref], atol=1e-6, rtol=0)


TEXTS = [" Hello world, how are you today?", "", " A much longer sentence, with several "
         "more words in it."]


@pytest.fixture(scope="module")
def mels():
    return (np.random.default_rng(11).standard_normal((3, 80, 3000)) * 0.4).astype(np.float32)


def test_find_alignment_equals_jax(pair, tokenizer, mels):
    jm, tm = pair
    text = tokenizer.encode(TEXTS[0])
    ref = jax_timing.find_alignment(jm, jax_get_tokenizer(True, language="en",
                                                          task="transcribe"),
                                    text, jnp.asarray(mels[0]), 2400)
    ours = timing.find_alignment(tm, tokenizer, text, torch.from_numpy(mels[0]), 2400)
    assert len(ours) == 8
    _assert_same_words(ours, ref)


def test_find_alignment_batched_equals_jax(pair, tokenizer, jax_tokenizer, mels):
    """Three rows, one empty, two num_frames groups; once from the mels and
    once from encoder features handed in."""
    jm, tm = pair
    texts = [tokenizer.encode(t) for t in TEXTS]
    frames = [3000, 3000, 1700]
    ref = jax_timing.find_alignment_batched(jm, jax_tokenizer, texts, jnp.asarray(mels),
                                            frames)
    ours = timing.find_alignment_batched(tm, tokenizer, texts, torch.from_numpy(mels), frames)
    assert ours[1] == [] and len(ours[2]) > 8
    for o, r in zip(ours, ref):
        _assert_same_words(o, r)
    feats, _ = tm.embed_audio(torch.from_numpy(mels), fp16=False)
    again = timing.find_alignment_batched(tm, tokenizer, texts, None, frames,
                                          audio_features=list(feats))
    for o, a in zip(ours, again):
        assert [(w.word, w.start, w.end) for w in o] == [(w.word, w.start, w.end) for w in a]


def test_find_alignment_batched_forwards_exactly_s_max_rows(pair, tokenizer, mels,
                                                          monkeypatch):
    """The alignment forward gets the token rows at their longest length,
    s_max, not padded to a bucket: the port's eager forward has no compile
    to bound."""
    _, tm = pair
    texts = [tokenizer.encode(t) for t in TEXTS]
    shapes = []

    def recording(decoder, toks, *args, **kwargs):
        shapes.append(tuple(toks.shape))
        return decoder_forward_with_qk(decoder, toks, *args, **kwargs)

    monkeypatch.setattr(timing, "decoder_forward_with_qk", recording)
    timing.find_alignment_batched(tm, tokenizer, texts, torch.from_numpy(mels),
                                  [3000, 3000, 1700])
    s_max = max(len(t) for t in texts) + len(tokenizer.sot_sequence) + 2
    assert shapes == [(2, s_max)]  # the empty row stays out of the batch
    assert s_max % 64 != 0


# --------------------------------------------------------------------------- #
# punctuation merge and word carving
# --------------------------------------------------------------------------- #


def _to_jax(alignment):
    return [jax_timing.WordTiming(w.word, list(w.tokens), w.start, w.end, w.probability)
            for w in alignment]


def test_merge_punctuations_and_words_per_segment_equal_jax():
    rng = np.random.default_rng(9)
    vocab = ([" hello", " world", "foo", " bar ", "baz "] + [" " + c for c in "¿([{-\"'"]
             + list(".,!?)]}\"'") + ["(", "-", " .", ". "])
    for trial in range(200):
        n = int(rng.integers(1, 12))
        words = [vocab[int(k)] for k in rng.integers(0, len(vocab), n)]
        starts = np.sort(rng.uniform(0, 20, n))
        ours = [timing.WordTiming(w, [100 + k] * int(rng.integers(1, 3)), float(s),
                                  float(s + rng.uniform(0, 2)), float(rng.uniform()))
                for k, (w, s) in enumerate(zip(words, starts))]
        ref = _to_jax(copy.deepcopy(ours))
        timing.merge_punctuations(ours, timing.PREPEND_PUNCTUATIONS,
                                  timing.APPEND_PUNCTUATIONS)
        jax_timing.merge_punctuations(ref, timing.PREPEND_PUNCTUATIONS,
                                      timing.APPEND_PUNCTUATIONS)
        assert [(w.word, w.tokens) for w in ours] == [(w.word, w.tokens) for w in ref]
        n_tokens = sum(len(w.tokens) for w in ours)
        cuts = np.sort(rng.integers(0, n_tokens + 1, 2))
        per_seg = [list(range(cuts[0])), list(range(cuts[0], cuts[1])),
                   list(range(cuts[1], n_tokens))]
        offset = float(trial)
        assert (list(timing._words_per_segment(ours, per_seg, offset))
                == list(jax_timing._words_per_segment(ref, per_seg, offset)))


def test_apply_alignment_snaps_segments_as_jax():
    alignment = [timing.WordTiming(" one", [1], 0.5, 1.0, 0.9),
                 timing.WordTiming(" two", [2], 1.0, 1.7, 0.8),
                 timing.WordTiming(".", [3], 1.7, 1.8, 0.7),
                 timing.WordTiming(" three", [4, 5], 2.5, 6.0, 0.6)]
    segments = [dict(seek=300, start=3.0, end=4.9, tokens=[1, 2, 3]),
                dict(seek=300, start=4.9, end=6.0, tokens=[4, 5, 50257])]
    ref_segments = copy.deepcopy(segments)
    per_seg = [[1, 2, 3], [4, 5]]
    timing._apply_alignment(segments, alignment, per_seg, timing.PREPEND_PUNCTUATIONS,
                            timing.APPEND_PUNCTUATIONS)
    jax_timing._apply_alignment(ref_segments, _to_jax(copy.deepcopy(alignment)), per_seg,
                                timing.PREPEND_PUNCTUATIONS, timing.APPEND_PUNCTUATIONS)
    assert segments == ref_segments
    assert [w["word"] for w in segments[0]["words"]] == [" one", " two."]
