"""Word timestamps end to end, and the sequential `transcribe`, against the
JAX package on the same weights.

Both packages run fp32 with int8 cross K/V, int8 decoder weights and the
int8 self cache (the JAX side with kv_layout="fused", its K4 Pallas kernel
in interpret mode), greedy at temperature 0 with the quality gate off.
Tokens, segments, seeks and word times must be identical; word
probabilities agree to 1e-5.
"""

import numpy as np
import pytest
import torch

import whisper_at_tpu as jax_wat
from whisper_at_tpu.models.dims import ModelDimensions as JaxDims
from whisper_at_tpu.models.whisper import Whisper as JaxWhisper
import whisper_at_tpu_torch as wat
from whisper_at_tpu_torch.convert import from_jax_params


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
INT8 = dict(kv_quant=True, weight_quant=True, self_kv_quant=True)
NO_GATE = dict(logprob_threshold=None, compression_ratio_threshold=None,
               no_speech_threshold=None)
OPTS = dict(language="en", temperature=0.0, sample_len=24, fp16=False, **NO_GATE, **INT8)


@pytest.fixture(scope="module")
def pair():
    jm = JaxWhisper(JaxDims(**DIMS), seed=3)
    tm = wat.Whisper(wat.ModelDimensions(**DIMS))
    tm.load_state_dict(from_jax_params(jm.params))
    np.testing.assert_array_equal(tm.alignment_heads, jm.alignment_heads)
    return jm, tm


@pytest.fixture(scope="module")
def audio_65s():
    """int16 PCM, 65 s: three 30 s windows, the last one mostly padding."""
    rng = np.random.default_rng(1)
    t = np.arange(16000 * 65) / 16000.0
    x = 0.3 * np.sin(2 * np.pi * 330 * t) + 0.05 * rng.standard_normal(len(t))
    return (np.clip(x, -1, 1) * 32767).astype(np.int16)


def _assert_same_result(out, ref, words: bool):
    assert out["text"] == ref["text"]
    assert out["language"] == ref["language"]
    assert len(out["segments"]) == len(ref["segments"]) > 0
    for s, r in zip(out["segments"], ref["segments"]):
        for key in ("id", "seek", "start", "end", "text", "tokens", "temperature"):
            assert s[key] == r[key], key
        assert s["avg_logprob"] == pytest.approx(r["avg_logprob"], abs=1e-4)
        assert ("words" in s) == ("words" in r)
        if words:
            assert [(w["word"], w["start"], w["end"]) for w in s["words"]] == \
                [(w["word"], w["start"], w["end"]) for w in r["words"]]
            np.testing.assert_allclose([w["probability"] for w in s["words"]],
                                       [w["probability"] for w in r["words"]],
                                       atol=1e-5, rtol=0)
    np.testing.assert_allclose(out["audio_tag"], ref["audio_tag"], atol=1e-4, rtol=0)


def test_transcribe_batched_word_timestamps_equal_jax(pair, audio_65s):
    jm, tm = pair
    kw = dict(OPTS, max_batch=2, word_timestamps=True)
    ref = jax_wat.transcribe_batched(jm, audio_65s, kv_layout="fused", **kw)
    out = wat.transcribe_batched(tm, audio_65s, **kw)
    _assert_same_result(out, ref, words=True)
    assert sum(len(s["words"]) for s in out["segments"]) > 0
    for seg in out["segments"]:
        starts = [w["start"] for w in seg["words"]]
        assert starts == sorted(starts)
        assert all(0 <= w["probability"] <= 1 for w in seg["words"])


@pytest.mark.parametrize("word_timestamps", [False, True])
def test_sequential_transcribe_equals_jax(pair, audio_65s, word_timestamps):
    """The seek loop with the previous text threaded into each prompt; with
    word timestamps the seek also moves to the last aligned word."""
    jm, tm = pair
    kw = dict(OPTS, condition_on_previous_text=True, word_timestamps=word_timestamps,
              initial_prompt="A tone.")
    ref = jax_wat.transcribe(jm, audio_65s, kv_layout="fused", **kw)
    out = wat.transcribe(tm, audio_65s, **kw)
    _assert_same_result(out, ref, words=word_timestamps)
    assert [s["seek"] for s in out["segments"]] == [s["seek"] for s in ref["segments"]]


@pytest.mark.parametrize("budget_rows", [1, 2, 3, 5])
def test_add_word_timestamps_many_chunks_rows_by_their_own_lengths(pair, monkeypatch,
                                                                   budget_rows):
    """Windows go to the alignment forward in order of their rows' own
    lengths (text + the sot sequence, <|notimestamps|> and eot), each chunk
    as many as fit QK_CHUNK_BYTES at its longest row, without rounding the
    rows up to a bucket. A budget of a few rows of the longest length forces
    splits."""
    from whisper_at_tpu_torch import timing
    from whisper_at_tpu_torch.tokenizer import get_tokenizer

    _, tm = pair
    tokenizer = get_tokenizer(True, language="en", task="transcribe")
    n_text = [5, 61, 62, 30, 61, 3, 100]
    jobs = [([dict(seek=0, start=0.0, end=1.0, tokens=list(range(100, 100 + k)))],
             torch.zeros(80, 3000), 3000) for k in n_text]
    sl = len(tokenizer.sot_sequence)
    n_sel = int(np.asarray(tm.alignment_heads, bool).sum())
    per_row = n_sel * tm.dims.n_audio_ctx * 4
    row_lens = [k + sl + 2 for k in n_text]
    monkeypatch.setattr(timing, "QK_CHUNK_BYTES", per_row * max(row_lens) * budget_rows)
    chunks = []

    def recording(model, tokenizer, text_tokens_list, *args, **kwargs):
        chunks.append([len(t) for t in text_tokens_list])
        return [[] for _ in text_tokens_list]

    monkeypatch.setattr(timing, "find_alignment_batched", recording)
    timing.add_word_timestamps_many(window_jobs=jobs, model=tm, tokenizer=tokenizer)
    # every window once, in order of its own length
    assert [k for chunk in chunks for k in chunk] == sorted(n_text)
    for chunk in chunks:
        assert per_row * (max(chunk) + sl + 2) * len(chunk) <= timing.QK_CHUNK_BYTES
    # greedy: no chunk could have taken the next window too
    for chunk, following in zip(chunks, chunks[1:]):
        grown = chunk + following[:1]
        assert per_row * (max(grown) + sl + 2) * len(grown) > timing.QK_CHUNK_BYTES
