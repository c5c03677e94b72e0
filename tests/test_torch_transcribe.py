"""The port's slice end to end against the JAX package: `transcribe_batched`
with int8 cross K/V, int8 decoder weights and the int8 self cache, and the
greedy decoder underneath it.

The JAX side runs with kv_layout="fused", so its decode steps go through its
K4 Pallas kernel (interpret mode on the CPU) as the port's go through K4's
plain version here. fp32 on both sides; tokens and text must be identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisper_at_tpu as jax_wat
from whisper_at_tpu.models.dims import ModelDimensions as JaxDims
from whisper_at_tpu.models.whisper import Whisper as JaxWhisper
import whisper_at_tpu_torch as wat
from whisper_at_tpu_torch.convert import from_jax_params
from whisper_at_tpu_torch.languages import LANGUAGES


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


@pytest.fixture(scope="module")
def pair():
    jm = JaxWhisper(JaxDims(**DIMS), seed=3)
    tm = wat.Whisper(wat.ModelDimensions(**DIMS))
    tm.load_state_dict(from_jax_params(jm.params))
    return jm, tm


@pytest.fixture(scope="module")
def audio_65s():
    """int16 PCM, 65 s: three 30 s windows, the last one mostly padding."""
    rng = np.random.default_rng(1)
    t = np.arange(16000 * 65) / 16000.0
    x = 0.3 * np.sin(2 * np.pi * 330 * t) + 0.05 * rng.standard_normal(len(t))
    return (np.clip(x, -1, 1) * 32767).astype(np.int16)


@pytest.fixture(scope="module")
def both(pair, audio_65s):
    jm, tm = pair
    kw = dict(language="en", temperature=0.0, sample_len=24, fp16=False, max_batch=2,
              **NO_GATE, **INT8)
    return (jax_wat.transcribe_batched(jm, audio_65s, kv_layout="fused", **kw),
            wat.transcribe_batched(tm, audio_65s, **kw))


def test_transcribe_batched_text_and_tokens_exact(both):
    ref, out = both
    assert out["text"] == ref["text"]
    assert out["language"] == ref["language"] == "en"
    assert len(out["segments"]) == len(ref["segments"]) > 0
    for s, r in zip(out["segments"], ref["segments"]):
        assert s["tokens"] == r["tokens"]
        assert s["text"] == r["text"]
        assert (s["id"], s["seek"], s["start"], s["end"]) == (r["id"], r["seek"], r["start"],
                                                              r["end"])
        assert s["avg_logprob"] == pytest.approx(r["avg_logprob"], abs=1e-4)
        assert s["no_speech_prob"] == pytest.approx(r["no_speech_prob"], abs=1e-6)


def test_transcribe_batched_tags(both):
    ref, out = both
    assert out["audio_tag"].shape == ref["audio_tag"].shape == (7, 527)
    np.testing.assert_allclose(out["audio_tag"], ref["audio_tag"], atol=1e-4, rtol=0)
    assert out["at_time_res"] == 10


@pytest.mark.parametrize("options", [
    dict(without_timestamps=True),
    dict(prompt="hello there", **INT8),
    dict(task="translate", max_initial_timestamp=None),
])
def test_decode_greedy_tokens_exact(pair, options):
    """decode() on two mel windows: no-timestamp rules, a prompt with every
    int8 option (a 8-token prefill bucket), and the translate task."""
    jm, tm = pair
    mel = (np.random.default_rng(7).standard_normal((2, 80, 3000)) * 0.4).astype(np.float32)
    ref = jax_wat.decode(jm, jnp.asarray(mel), jax_wat.DecodingOptions(
        language="en", fp16=False, sample_len=16, **options,
        **({"kv_layout": "fused"} if options.get("kv_quant") else {})))
    out = wat.decode(tm, torch.from_numpy(mel), wat.DecodingOptions(
        language="en", fp16=False, sample_len=16, **options))
    for r, o in zip(ref, out):
        assert o.tokens == r.tokens
        assert o.text == r.text
        assert o.avg_logprob == pytest.approx(r.avg_logprob, abs=1e-4)


def test_detect_language_matches(pair):
    """Both packages detect in bf16 by default (fp16=True), so the
    probabilities agree to bf16 rounding, not fp32."""
    jm, tm = pair
    mel = (np.random.default_rng(8).standard_normal((2, 80, 3000)) * 0.4).astype(np.float32)
    jt, jp = jax_wat.detect_language(jm, jnp.asarray(mel))
    tt, tp = wat.detect_language(tm, torch.from_numpy(mel))
    assert tt.tolist() == np.asarray(jt).tolist()
    for a, b in zip(tp, jp):
        assert max(a, key=a.get) == max(b, key=b.get)
        assert a["en"] == pytest.approx(b["en"], abs=2e-4)


def test_transcribe_batched_detects_language_and_handles_empty_audio(pair):
    """Language left unset is detected from the first window; audio shorter
    than a frame yields no segments and one zero tag cell."""
    _, tm = pair
    empty = wat.transcribe_batched(tm, np.zeros(100, np.int16), fp16=False, **NO_GATE)
    assert empty["segments"] == [] and empty["text"] == ""
    assert empty["audio_tag"].shape == (1, 527) and not empty["audio_tag"].any()
    assert empty["language"] in LANGUAGES


def test_parse_at_label(both):
    _, out = both
    labels = wat.parse_at_label(out, top_k=3)
    assert len(labels) == 7
    assert labels[0]["time"] == {"start": 0, "end": 10}
    assert len(labels[0]["audio tags"]) == 3


def test_transcribe_batched_decodes_exactly_its_windows(pair, monkeypatch):
    """17 windows decode 17 rows in one `DecodingTask.run`, not the 24 of the
    JAX package's batch ladder (its copies of the last window bound XLA
    compiles, which the eager port has none of); the text is the JAX
    package's."""
    jm, tm = pair
    rng = np.random.default_rng(17)
    t = np.arange(16000 * 30 * 17 - 16000 * 7) / 16000.0
    x = 0.3 * np.sin(2 * np.pi * 250 * t) + 0.05 * rng.standard_normal(len(t))
    audio = (np.clip(x, -1, 1) * 32767).astype(np.int16)
    kw = dict(language="en", temperature=0.0, sample_len=6, fp16=False, max_batch=24,
              **NO_GATE)
    rows, run = [], wat.decoding.DecodingTask.run

    def counting(self, mel, *args, **kwargs):
        rows.append(int(mel.shape[0]))
        return run(self, mel, *args, **kwargs)

    monkeypatch.setattr(wat.decoding.DecodingTask, "run", counting)
    out = wat.transcribe_batched(tm, audio, **kw)
    assert rows == [17]
    ref = jax_wat.transcribe_batched(jm, audio, **kw)
    assert out["text"] == ref["text"]
    assert [s["tokens"] for s in out["segments"]] == [s["tokens"] for s in ref["segments"]]
