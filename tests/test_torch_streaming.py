"""The port's streaming path against the JAX package: `StreamingTranscriber`
inline (with word timestamps and prompt threading), its window mel, empty
and tiny streams, and `StreamingService` batching the windows of sessions
fed from their own threads.

fp32 with the int8 options; the JAX side runs with kv_layout="fused" (its K4
Pallas kernel in interpret mode). Segments, text and word times exact, tags
within 1e-4. The service's batches are made deterministic by filling them
(max_batch = the number of sessions), never by timing.
"""

import threading

import numpy as np
import pytest
import torch

from whisper_at_tpu.models.dims import ModelDimensions as JaxDims
from whisper_at_tpu.models.whisper import Whisper as JaxWhisper
from whisper_at_tpu.streaming import StreamingTranscriber as JaxStreamingTranscriber
import whisper_at_tpu_torch as wat
from whisper_at_tpu_torch import streaming
from whisper_at_tpu_torch.convert import from_jax_params
from whisper_at_tpu_torch.ops.mel import N_FRAMES, N_SAMPLES
from whisper_at_tpu_torch.streaming import StreamingService, StreamingTranscriber

DIMS = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=128, n_audio_head=2,
            n_audio_layer=2, n_vocab=51865, n_text_ctx=448, n_text_head=2,
            n_text_state=128, n_text_layer=2)
INT8 = dict(kv_quant=True, weight_quant=True, self_kv_quant=True)
OPTS = dict(temperature=0.0, sample_len=24, fp16=False, logprob_threshold=None,
            compression_ratio_threshold=None, no_speech_threshold=None, **INT8)
FLOAT_KEYS = ("avg_logprob", "no_speech_prob", "compression_ratio")
JOIN_S = 300  # each session thread's own limit


def clicky_audio(seconds: float, seed: int = 1) -> np.ndarray:
    """Tone and noise with one full-scale click a 30 s window, so each
    window's loudest frame is the recording's and the causal 8-dB floor is
    the offline one (the JAX package's streaming tests' signal)."""
    rng = np.random.default_rng(seed)
    n = int(16000 * seconds)
    t = np.arange(n) / 16000.0
    x = (0.3 * np.sin(2 * np.pi * 330 * t) + 0.08 * np.sin(2 * np.pi * 45 * t)
         + 0.02 * rng.standard_normal(n))
    for s in range(0, n, 30 * 16000):
        click = s + 16000
        x[click - 600:click + 632] = 0.0
        x[click:click + 32] = 1.0
    return x.astype(np.float32)


def blocks(n: int, seed: int):
    """Uneven block bounds over n samples."""
    rng = np.random.default_rng(seed)
    lo = 0
    while lo < n:
        hi = lo + int(rng.integers(5000, 120000))
        yield lo, hi
        lo = hi


def feed_all(sess, audio, seed=0):
    emitted = []
    for lo, hi in blocks(len(audio), seed):
        emitted.extend(sess.feed(audio[lo:hi]))
    return emitted, sess.finish()


def run_threads(targets):
    threads = [threading.Thread(target=t) for t in targets]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads)



@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small shapes gain nothing from torch's intra-op threads, and beside
    other test workers their barriers wait on descheduled threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

@pytest.fixture(scope="module")
def pair():
    jm = JaxWhisper(JaxDims(**DIMS), seed=3)
    tm = wat.Whisper(wat.ModelDimensions(**DIMS))
    tm.load_state_dict(from_jax_params(jm.params))
    return jm, tm


@pytest.fixture(scope="module")
def audio():
    return clicky_audio(65, seed=8)


@pytest.fixture(scope="module")
def inline_words(pair, audio):
    """One 65 s stream with word timestamps and prompt threading, fed in
    the same uneven blocks to both packages' sessions."""
    jm, tm = pair
    ref = JaxStreamingTranscriber(jm, word_timestamps=True, language="en", kv_layout="fused",
                                  **OPTS)
    sess = StreamingTranscriber(tm, word_timestamps=True, language="en", **OPTS)
    return feed_all(ref, audio), feed_all(sess, audio)


def test_streaming_session_matches_jax(inline_words):
    (ref_emitted, ref), (emitted, out) = inline_words
    assert out["text"] == ref["text"] and out["language"] == ref["language"] == "en"
    assert len(out["segments"]) == len(ref["segments"]) > 1
    for s, r in zip(out["segments"], ref["segments"]):
        assert (s["id"], s["seek"], s["start"], s["end"], s["tokens"], s["text"]) == \
            (r["id"], r["seek"], r["start"], r["end"], r["tokens"], r["text"])
        assert s["avg_logprob"] == pytest.approx(r["avg_logprob"], abs=1e-4)
    assert out["audio_tag"].shape == np.asarray(ref["audio_tag"]).shape
    np.testing.assert_allclose(out["audio_tag"], np.asarray(ref["audio_tag"]), atol=1e-4, rtol=0)
    # segments come out of feed() as their windows finalize, a prefix of the result
    assert len(emitted) == len(ref_emitted) > 0
    assert emitted == out["segments"][:len(emitted)]


def test_streaming_session_word_times_match_jax(inline_words):
    (_, ref), (_, out) = inline_words
    words = [w for s in out["segments"] for w in s["words"]]
    ref_words = [w for s in ref["segments"] for w in s["words"]]
    assert len(words) == len(ref_words) > 0
    for w, r in zip(words, ref_words):
        assert (w["word"], w["start"], w["end"]) == (r["word"], r["start"], r["end"])
        assert w["probability"] == pytest.approx(r["probability"], abs=1e-4)


@pytest.mark.parametrize("seek", [0, 1, 2, 500, 3000])
def test_window_mel_matches_the_offline_mel(pair, seek):
    """A window's mel from the samples around it equals the offline
    full-file mel's frames (the clicks make the 8-dB floors agree)."""
    _, tm = pair
    audio = clicky_audio(70)
    sess = StreamingTranscriber(tm, language="en", **OPTS)
    sess._buf = audio
    sess._total_samples = len(audio)
    sess._seek = seek
    offline = wat.log_mel_spectrogram(audio, padding=N_SAMPLES, device="cpu")
    np.testing.assert_allclose(sess._window_mel().numpy(),
                               offline[:, seek:seek + N_FRAMES].numpy(), atol=2e-5, rtol=0)


@pytest.mark.parametrize("samples", [0, 100])
def test_empty_and_tiny_streams_match_jax(pair, samples):
    """A stream too short for a window: no segments, one zero tag cell, and
    the language detected from the received samples, as in JAX."""
    jm, tm = pair
    x = clicky_audio(1)[:samples]
    opts = dict(OPTS, fp16=True)  # both detect in bf16
    ref = JaxStreamingTranscriber(jm, kv_layout="fused", **opts)
    sess = StreamingTranscriber(tm, **opts)
    if samples:
        assert sess.feed(x) == [] and ref.feed(x) == []
    out, want = sess.finish(), ref.finish()
    assert out["text"] == want["text"] == "" and out["segments"] == want["segments"] == []
    assert out["audio_tag"].shape == np.asarray(want["audio_tag"]).shape == (1, 527)
    assert not out["audio_tag"].any()
    assert out["language"] == want["language"]


def test_session_guards(pair):
    _, tm = pair
    sess = StreamingTranscriber(tm, language="en", **OPTS)
    with pytest.raises(ValueError):
        sess.feed(np.zeros(100, np.int32))  # a PCM width without a known full scale
    with pytest.raises(ValueError):
        sess.feed(np.zeros((2, 100), np.float32))
    sess.finish()
    with pytest.raises(RuntimeError):
        sess.feed(np.zeros(100, np.float32))
    with pytest.raises(RuntimeError):
        sess.finish()


N_SESSIONS = 3  # not a rung of the decode's batch ladder (1, 2, 4, ...)


@pytest.fixture(scope="module")
def service_run(pair, audio, request):
    """Three sessions without a language (multilingual model: detection
    rides the service) fed the same stream in different uneven blocks from
    their own threads, through a service whose batches close when all three
    windows are in; the rows handed to the batched mel, tag and detection
    calls are recorded."""
    _, tm = pair
    rows = {"mel": [], "tags": [], "detect": []}
    mel, detect, at_forward = (streaming.mel_stream_pieces, streaming.detect_language,
                               tm.at_forward)

    def spy(name, fn, arg=0):
        def call(*args, **kwargs):
            rows[name].append(args[arg].shape[0])
            return fn(*args, **kwargs)
        return call

    mp = pytest.MonkeyPatch()
    request.addfinalizer(mp.undo)
    mp.setattr(streaming, "mel_stream_pieces", spy("mel", mel))
    mp.setattr(streaming, "detect_language", spy("detect", detect, arg=1))
    with StreamingService(tm, max_batch=N_SESSIONS, max_wait_s=JOIN_S, **OPTS) as service:
        sessions = [service.open() for _ in range(N_SESSIONS)]
        results = [None] * N_SESSIONS
        mp.setattr(tm, "at_forward", spy("tags", at_forward))

        def drive(i):
            results[i] = feed_all(sessions[i], audio, seed=i)[1]

        run_threads([lambda i=i: drive(i) for i in range(N_SESSIONS)])
        stats = service.stats()
    mp.undo()
    return results, stats, rows


def test_service_sessions_equal_inline_sessions(pair, audio, service_run):
    """Batching windows across sessions changes no window's decode (the
    float fields and tags to fp32 rounding: a batch holds other rows)."""
    _, tm = pair
    results, stats, _ = service_run
    solo = StreamingTranscriber(tm, condition_on_previous_text=False, **OPTS)
    _, want = feed_all(solo, audio)
    for got in results:
        assert got["text"] == want["text"] and got["language"] == want["language"]
        assert len(got["segments"]) == len(want["segments"]) > 1
        for g, w in zip(got["segments"], want["segments"]):
            assert {k: v for k, v in g.items() if k not in FLOAT_KEYS} == \
                {k: v for k, v in w.items() if k not in FLOAT_KEYS}
            for k in FLOAT_KEYS:
                assert g[k] == pytest.approx(w[k], rel=1e-5, abs=1e-6), k
        np.testing.assert_allclose(got["audio_tag"], want["audio_tag"], atol=1e-5, rtol=0)
    assert stats["sessions"] == N_SESSIONS
    assert stats["windows"] == N_SESSIONS * stats["batches"] >= N_SESSIONS * 2
    assert stats["max_batch_windows"] == N_SESSIONS


def test_service_batches_language_detection(service_run):
    _, stats, rows = service_run
    assert stats["detect_windows"] == N_SESSIONS and stats["detect_batches"] == 1
    assert rows["detect"] == [N_SESSIONS]


def test_service_groups_run_at_their_exact_sizes(service_run):
    """The mel, tag and detection groups are not padded up the ladder: every
    call got the batch's own rows (3, where the ladder would give 4)."""
    _, stats, rows = service_run
    assert rows["tags"] and set(rows["tags"]) == {N_SESSIONS}
    # the first windows' mels were made in the sessions, one row each, for
    # the detection; every later window's in the scheduler's batched call
    batched = [n for n in rows["mel"] if n != 1]
    assert len(rows["mel"]) - len(batched) == N_SESSIONS
    assert batched and set(batched) == {N_SESSIONS}
    assert sum(batched) == stats["mel_batched_windows"] == stats["windows"] - N_SESSIONS
    assert stats["tag_groups"] == len(rows["tags"])


def test_service_close_fails_queued_windows(pair):
    _, tm = pair
    service = StreamingService(tm, language="en", **OPTS)
    sess = service.open()
    service.close()
    with pytest.raises(RuntimeError, match="closed"):
        sess.feed(clicky_audio(31, seed=6))
    service.close()  # idempotent
    with pytest.raises(RuntimeError):
        service.open()
    with StreamingService(tm, **OPTS) as service:
        with pytest.raises(ValueError):
            service.open(condition_on_previous_text=True)


def test_service_warmup_and_profile(pair, monkeypatch):
    """warmup(n) drives n concurrent sessions to their end; the stage
    profiler records the sessions' and the scheduler's stages."""
    _, tm = pair
    monkeypatch.setattr(streaming._stream_prof, "enabled", True)
    streaming.prof_snapshot()
    with StreamingService(tm, max_batch=2, max_wait_s=0.05, language="en",
                          **OPTS) as service:
        took = service.warmup(2, seconds=31.0)
        stats = service.stats()
    assert took["sessions"] == 2 and took["seconds"] > 0
    assert stats["sessions"] == 2 and stats["windows"] >= 4 and stats["batches"] >= 2
    stages = streaming.prof_snapshot()
    for key in ("feed-normalize", "window-join", "prep-h2d", "decode-wait", "parse-segments",
                "tags-drain", "sched-materialize", "sched-decode", "sched-tags"):
        assert stages[key]["count"] >= 1, key


def test_top_level_exports():
    assert wat.StreamingService is StreamingService
    assert wat.StreamingTranscriber is StreamingTranscriber
    assert wat.Whisper.decode is wat.decode and wat.Whisper.transcribe is wat.transcribe
    assert torch.is_tensor(wat.prefetch_audio(np.zeros(10, np.float32), device="cpu").sig)
