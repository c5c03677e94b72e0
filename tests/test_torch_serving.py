"""The port's serving path against the JAX package: `transcribe_many`, the
host prep of the frontend, `load_audio_pcm16`, `TranscriptionService` and
its HTTP front end, and `StageProf`.

The JAX side runs with kv_layout="fused", so its decode steps go through its
K4 Pallas kernel (interpret mode on the CPU) as the port's go through K4's
plain version here. fp32 with the int8 options on both sides: tokens, text
and segment times exact, tags within 1e-4. Every wait has its own timeout;
no assertion depends on how the scheduler happened to split its batches.
"""

import concurrent.futures
import io
import json
import sys
import threading
import urllib.error
import urllib.request
import wave

import numpy as np
import pytest
import torch

import whisper_at_tpu as jax_wat
import whisper_at_tpu.audio as jax_audio
from whisper_at_tpu.models.dims import ModelDimensions as JaxDims
from whisper_at_tpu.models.whisper import Whisper as JaxWhisper
from whisper_at_tpu.ops.mel import _stft_host_prep as jax_stft_host_prep
from whisper_at_tpu.serving import _coerce_params as jax_coerce_params
import whisper_at_tpu_torch as wat
from whisper_at_tpu_torch import serving
from whisper_at_tpu_torch.convert import from_jax_params
from whisper_at_tpu_torch.ops.mel import N_FRAMES, N_SAMPLES, mel_windows_many, stft_host_prep
from whisper_at_tpu_torch.serving import TranscriptionService, _coerce_params, make_http_server
from whisper_at_tpu_torch.transcribe import transcribe_many
from whisper_at_tpu_torch.utils.profiling import StageProf

DIMS = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=128, n_audio_head=2,
            n_audio_layer=2, n_vocab=51865, n_text_ctx=448, n_text_head=2,
            n_text_state=128, n_text_layer=2)
INT8 = dict(kv_quant=True, weight_quant=True, self_kv_quant=True)
NO_GATE = dict(logprob_threshold=None, compression_ratio_threshold=None,
               no_speech_threshold=None)
OPTS = dict(language="en", temperature=0.0, sample_len=24, fp16=False, **NO_GATE, **INT8)
FLOAT_KEYS = ("avg_logprob", "no_speech_prob", "compression_ratio")
WAIT_S = 300  # each future's own limit
MAX_BODY = 70_000  # the HTTP tests' body limit: a 2 s WAV fits


def clip(seconds, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000.0
    x = 0.3 * np.sin(2 * np.pi * (220 + 40 * seed) * t) + 0.05 * rng.standard_normal(len(t))
    return np.clip(x, -1, 1).astype(np.float32)


def pcm16(x):
    return (np.clip(x, -1, 1) * 32767).astype(np.int16)


def wav_bytes(x: np.ndarray, rate=16000, channels=1, width=2) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as wf:
        wf.setnchannels(channels)
        wf.setsampwidth(width)
        wf.setframerate(rate)
        if width == 2:
            wf.writeframes(pcm16(x).tobytes())
        elif width == 1:
            wf.writeframes((np.clip(x, -1, 1) * 127 + 128).astype(np.uint8).tobytes())
        else:
            v = (np.clip(x, -1, 1) * 8388607).astype(np.int32)
            wf.writeframes(np.stack([v & 255, (v >> 8) & 255, (v >> 16) & 255], 1)
                           .astype(np.uint8).tobytes())
    return buf.getvalue()


def assert_same_result(got, want, exact_floats=True, tag_tol=0.0):
    """Text, language and segments equal (the float fields to fp32 rounding
    unless exact_floats), tags within tag_tol."""
    assert got["text"] == want["text"]
    assert got["language"] == want["language"]
    assert len(got["segments"]) == len(want["segments"])
    for g, w in zip(got["segments"], want["segments"]):
        assert {k: v for k, v in g.items() if k not in FLOAT_KEYS} == \
            {k: v for k, v in w.items() if k not in FLOAT_KEYS}
        for k in FLOAT_KEYS:
            if exact_floats:
                assert g[k] == w[k], k
            else:
                assert g[k] == pytest.approx(w[k], rel=1e-5, abs=1e-6), k
    np.testing.assert_allclose(np.asarray(got["audio_tag"]), np.asarray(want["audio_tag"]),
                               atol=tag_tol, rtol=0)



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
def inputs():
    """0, 7, 31 and 65 s: float and int16, the 7 s one as a PrefetchedAudio
    on the port's side."""
    return [np.zeros(0, np.float32), clip(7, 1), pcm16(clip(31, 2)), clip(65, 3)]


@pytest.fixture(scope="module")
def many(pair, inputs):
    jm, tm = pair
    port_inputs = list(inputs)
    port_inputs[1] = wat.prefetch_audio(inputs[1], device="cpu")
    ref = jax_wat.transcribe_many(jm, [jax_wat.prefetch_audio(inputs[1]) if i == 1 else a
                                       for i, a in enumerate(inputs)],
                                  kv_layout="fused", max_batch=4, **OPTS)
    return ref, transcribe_many(tm, port_inputs, max_batch=4, **OPTS)


def test_transcribe_many_matches_jax(many):
    ref, out = many
    assert len(out) == len(ref) == 4
    assert out[0]["segments"] == [] and out[0]["text"] == ""
    assert sum(len(r["segments"]) for r in out) > 0
    for o, r in zip(out, ref):
        assert o["text"] == r["text"]
        assert o["language"] == r["language"] == "en"
        assert len(o["segments"]) == len(r["segments"])
        for s, w in zip(o["segments"], r["segments"]):
            assert (s["id"], s["seek"], s["start"], s["end"], s["tokens"], s["text"]) == \
                (w["id"], w["seek"], w["start"], w["end"], w["tokens"], w["text"])
            assert s["avg_logprob"] == pytest.approx(w["avg_logprob"], abs=1e-4)
        assert o["audio_tag"].shape == np.asarray(r["audio_tag"]).shape
        np.testing.assert_allclose(o["audio_tag"], np.asarray(r["audio_tag"]), atol=1e-4, rtol=0)


@pytest.mark.parametrize("index", [0, 1, 2, 3])
def test_transcribe_many_equals_transcribe_batched_per_file(pair, inputs, many, index):
    """Packing windows across files changes no window's decode: each file's
    result is `transcribe_batched`'s on it (the float fields and tags to
    fp32 rounding: the decode batch holds other rows)."""
    _, tm = pair
    _, out = many
    one = wat.transcribe_batched(tm, inputs[index], max_batch=4, **OPTS)
    assert_same_result(out[index], one, exact_floats=False, tag_tol=1e-5)


def test_transcribe_many_detects_language_per_file(pair, inputs):
    """language=None on a multilingual model: one batched detection over
    the first windows, as each file's own detection decides."""
    _, tm = pair
    opts = dict(OPTS, language=None)
    out = transcribe_many(tm, inputs[:3], max_batch=2, **opts)
    for audio, got in zip(inputs[:3], out):
        one = wat.transcribe_batched(tm, audio, max_batch=2, **opts)
        assert_same_result(got, one, exact_floats=False, tag_tol=1e-5)


def test_transcribe_many_refuses_a_mesh_and_conditioning(pair, inputs):
    """A mesh that is not a `parallel.mesh.Mesh` is refused (meshes run in
    tests/test_torch_parallel.py), and so is conditioning on earlier text."""
    _, tm = pair
    with pytest.raises(TypeError, match="mesh"):
        transcribe_many(tm, inputs[1:2], mesh=object(), **OPTS)
    with pytest.raises(ValueError, match="condition_on_previous_text"):
        transcribe_many(tm, inputs[1:2], condition_on_previous_text=True, **OPTS)


def _prep_inputs():
    rng = np.random.default_rng(5)
    on_grid = (rng.integers(-32768, 32768, 20000) / 32768.0).astype(np.float32)
    return {
        "float on the int16 grid": on_grid,
        "float off the grid": clip(1.3, 4),
        "float off the grid after the probe": np.concatenate([on_grid, clip(0.2, 5)]),
        "int16": pcm16(clip(2.1, 6)),
        "float64 on the grid": on_grid.astype(np.float64),
        "200 samples": on_grid[:200],
        "empty": np.zeros(0, np.float32),
    }


@pytest.mark.parametrize("padding", [0, N_SAMPLES])
@pytest.mark.parametrize("name", list(_prep_inputs()))
def test_host_prep_is_jax_bitwise(name, padding):
    """The int16-grid check, the zero tail and the reflect padding, bit for
    bit the JAX package's exact prep, which its 30 s bucket only extends
    with samples no computed frame reads."""
    audio = _prep_inputs()[name]
    sig, n_frames = stft_host_prep(audio, padding)
    ref, ref_frames = jax_stft_host_prep(audio, padding, exact=True)
    assert n_frames == ref_frames == (audio.size + padding) // 160
    assert sig.dtype == ref.dtype and sig.shape == ref.shape
    assert sig.tobytes() == ref.tobytes()
    bucketed, _ = jax_stft_host_prep(audio, padding)
    assert bucketed[:sig.size].tobytes() == sig.tobytes()


@pytest.mark.parametrize("rate, channels, width", [(16000, 1, 2), (16000, 2, 2),
                                                   (16000, 1, 1), (16000, 1, 3),
                                                   (22050, 1, 2)])
def test_load_audio_pcm16_is_jax_bitwise(tmp_path, monkeypatch, rate, channels, width):
    """WAV only (the JAX package's native path, without ffmpeg): int16 for
    16-bit mono 16 kHz, else load_audio's float32; a non-WAV file raises."""
    monkeypatch.setattr(jax_audio.shutil, "which", lambda name: None)
    x = clip(0.7, 7)
    path = tmp_path / "a.wav"
    path.write_bytes(wav_bytes(np.repeat(x, channels), rate, channels, width))
    got = wat.load_audio_pcm16(str(path))
    ref = jax_audio.load_audio_pcm16(str(path))
    assert got.dtype == ref.dtype == (np.int16 if (rate, channels, width) == (16000, 1, 2)
                                      else np.float32)
    assert got.tobytes() == ref.tobytes()
    assert serving._decode_wav_bytes(path.read_bytes()).tobytes() == ref.tobytes()
    with pytest.raises(RuntimeError, match="WAV"):
        wat.load_audio_pcm16(str(tmp_path / "a.mp3"))


def test_prefetched_log_mel_matches_the_waveform(inputs):
    """`log_mel_spectrogram` of a PrefetchedAudio equals that of the
    waveform, and a PrefetchedAudio with the wrong padding raises."""
    audio = inputs[2]
    for padding in (0, N_SAMPLES):
        p = wat.prefetch_audio(audio, padding=padding, device="cpu")
        assert p.sig.dtype == torch.int16 and p.event is None
        want = wat.log_mel_spectrogram(audio, padding=padding, device="cpu")
        np.testing.assert_allclose(wat.log_mel_spectrogram(p, padding=padding).numpy(),
                                   want.numpy(), atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="padding"):
        wat.log_mel_spectrogram(p, padding=0)
    empty = wat.prefetch_audio(np.zeros(0, np.float32), padding=0, device="cpu")
    assert wat.log_mel_spectrogram(empty).shape == (80, 0)


def test_prefetched_audio_with_the_wrong_padding_raises(pair, inputs):
    _, tm = pair
    with pytest.raises(ValueError, match="padding"):
        transcribe_many(tm, [wat.prefetch_audio(inputs[1], padding=0, device="cpu")], **OPTS)


def test_window_mel_floor_reaches_past_the_last_window():
    """A click in the last samples of a 30 s + 100-sample clip lies in
    frames past the windows' 3000: the floor still sees it, so the batched
    windows equal the per-file mel's frames."""
    x = clip(30, 8) * 0.01
    x = np.concatenate([x, np.zeros(100, np.float32)])
    x[-40:] = 1.0
    p = wat.prefetch_audio(x, device="cpu")
    wins = mel_windows_many(p.sig[None], torch.tensor([p.n_frames]), 1)
    full = wat.log_mel_spectrogram(x, padding=N_SAMPLES, device="cpu")
    assert float(full[:, N_FRAMES:N_FRAMES + 3].max()) > float(full[:, :N_FRAMES].max())
    np.testing.assert_allclose(wins[0, 0].numpy(), full[:, :N_FRAMES].numpy(), atol=1e-6,
                               rtol=0)


def _results(futures):
    return [f.result(timeout=WAIT_S) for f in futures]


def test_service_equals_direct_transcribe_many(pair):
    _, tm = pair
    clips = [clip(2, 1), clip(5, 2), clip(35, 3), np.zeros(0, np.float32), clip(1, 4)]
    direct = transcribe_many(tm, list(clips), **OPTS)
    with TranscriptionService(tm, max_wait_s=0.5, **OPTS) as svc:
        results = _results([svc.submit(c) for c in clips])
        stats = svc.stats()
    for got, want in zip(results, direct):
        assert_same_result(got, want, exact_floats=False, tag_tol=1e-5)
    assert stats["requests"] == stats["completed"] == len(clips)
    assert stats["failed"] == 0 and stats["windows"] == 5
    assert stats["audio_seconds"] == pytest.approx(43.0)
    assert 0 < stats["latency_p50_s"] <= stats["latency_p95_s"] <= stats["latency_max_s"]


def test_service_groups_mixed_options_separately(pair):
    _, tm = pair
    c1, c2 = clip(2, 7), clip(2, 8)
    with TranscriptionService(tm, max_wait_s=0.3, **OPTS) as svc:
        r1, r2 = _results([svc.submit(c1), svc.submit(c2, language="de")])
        stats = svc.stats()
    assert_same_result(r1, transcribe_many(tm, [c1], **OPTS)[0])
    assert_same_result(r2, transcribe_many(tm, [c2], **dict(OPTS, language="de"))[0])
    assert r2["language"] == "de"
    assert stats["batches"] == 2  # requests with other options never share a batch


def test_service_prep_error_fails_only_its_own_future(pair):
    _, tm = pair
    good = clip(2, 9)
    with TranscriptionService(tm, max_wait_s=0.2, **OPTS) as svc:
        bad = svc.submit("/nonexistent/file.wav")
        bad_pad = svc.submit(wat.prefetch_audio(clip(1, 9), padding=0, device="cpu"))
        bad_shape = svc.submit(np.zeros((2, 100), np.float32))
        ok = svc.submit(good)
        assert isinstance(bad.exception(timeout=WAIT_S), FileNotFoundError)
        assert isinstance(bad_pad.exception(timeout=WAIT_S), ValueError)
        assert isinstance(bad_shape.exception(timeout=WAIT_S), ValueError)
        got = ok.result(timeout=WAIT_S)
        stats = svc.stats()
    assert_same_result(got, transcribe_many(tm, [good], **OPTS)[0])
    assert stats["failed"] == 3 and stats["completed"] == 1


def test_service_delivers_a_failed_batch_then_recovers(pair, monkeypatch):
    _, tm = pair
    real = serving.transcribe_many
    state = {"fail": True}

    def flaky(*a, **kw):
        if state["fail"]:
            state["fail"] = False
            raise RuntimeError("simulated device fault")
        return real(*a, **kw)

    monkeypatch.setattr(serving, "transcribe_many", flaky)
    good = clip(2, 16)
    with TranscriptionService(tm, max_wait_s=0.3, **OPTS) as svc:
        doomed = [svc.submit(clip(1, 17)), svc.submit(clip(1, 18))]
        failed = [f.exception(timeout=WAIT_S) for f in doomed]
        got = svc.submit(good).result(timeout=WAIT_S)
        stats = svc.stats()
    # the first batch holds the first request, and maybe the second
    assert "simulated device fault" in str(failed[0])
    assert stats["failed"] + stats["completed"] == 3 and stats["failed"] >= 1
    assert_same_result(got, real(tm, [good], **OPTS)[0])


def test_service_close_and_conditioning(pair):
    _, tm = pair
    svc = TranscriptionService(tm, max_wait_s=0.05, **OPTS)
    fut = svc.submit(clip(1, 11))
    svc.close(wait=True)  # serves the backlog
    assert fut.result(timeout=WAIT_S)["language"] == "en"
    with pytest.raises(RuntimeError):
        svc.submit(clip(1, 12))
    svc.close()  # idempotent
    with pytest.raises(ValueError):
        TranscriptionService(tm, condition_on_previous_text=True, **OPTS)
    with TranscriptionService(tm, **OPTS) as svc:
        with pytest.raises(ValueError):
            svc.submit(clip(1, 13), condition_on_previous_text=True)
    with pytest.raises(TypeError, match="mesh"):
        TranscriptionService(tm, mesh=object(), **OPTS)


def test_service_abort_cancels_the_queue(pair, tmp_path):
    """close(wait=False) cancels every queued request: at most the one
    batch the scheduler was filling is served, every future ends (waited
    for, with a limit), and the prep pool is shut down."""
    _, tm = pair
    path = tmp_path / "c.wav"
    path.write_bytes(wav_bytes(clip(1, 51)))
    svc = TranscriptionService(tm, max_wait_s=5.0, prep_workers=1, **OPTS)
    futs = [svc.submit(str(path)) for _ in range(64)]
    svc.close(wait=False)
    served = 0
    for f in futs:
        try:
            served += f.result(timeout=WAIT_S)["language"] == "en"
        except concurrent.futures.CancelledError:
            pass
    assert all(f.done() for f in futs)
    assert served <= svc.max_batch
    with pytest.raises(RuntimeError):
        svc._prep_pool.submit(len, "")


def test_service_warmup_runs_the_ladder(pair):
    """warmup() runs one call at each rung of the decode's batch ladder and
    leaves the stats untouched."""
    _, tm = pair
    with TranscriptionService(tm, max_batch=4, **OPTS) as svc:
        took = svc.warmup(clip_seconds=0.5)
        assert sorted(took) == [1, 2, 4] and all(v >= 0 for v in took.values())
        assert svc.stats()["requests"] == 0
        res = svc.transcribe(clip(2, 7))
    assert "segments" in res and res["audio_tag"].shape == (1, 527)


def test_service_prefetches_onto_its_models_device(pair):
    _, tm = pair
    with TranscriptionService(tm, **OPTS) as svc:
        prepped = svc._prep(clip(1, 3))
    assert isinstance(prepped, wat.PrefetchedAudio) and prepped.device == tm.device


@pytest.mark.parametrize("query", [
    "language=en&beam_size=2&temperature=0,0.2&word_timestamps=true&tags=3",
    "task=translate&patience=1.5&length_penalty=0.2&sample_len=8&at_time_res=5",
    "without_timestamps=off&initial_prompt=hello%20there&tag_language=zh&best_of=3",
    "temperature=0.4", "word_timestamps=maybe", "bogus=1", "beam_size=abc", "temperature=",
])
def test_coerce_params_matches_jax(query):
    try:
        want = jax_coerce_params(query)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            _coerce_params(query)
        assert str(got.value) == str(exc)
    else:
        assert _coerce_params(query) == want


@pytest.fixture
def http_service(pair, tmp_path):
    _, tm = pair
    with TranscriptionService(tm, max_wait_s=0.05, **OPTS) as svc:
        server = make_http_server(svc, "127.0.0.1", 0, max_body_bytes=MAX_BODY,
                                  path_root=str(tmp_path))
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            yield f"http://127.0.0.1:{server.server_address[1]}", tm
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=60)
            assert not thread.is_alive()


def _post(url, body, ctype="audio/wav"):
    req = urllib.request.Request(url, data=body, headers={"Content-Type": ctype})
    return json.loads(urllib.request.urlopen(req, timeout=WAIT_S).read())


def _status(url, body=None, ctype="audio/wav"):
    req = urllib.request.Request(url, data=body, headers={"Content-Type": ctype})
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(req, timeout=60)
    return err.value.code


def test_http_server_end_to_end(http_service, tmp_path):
    base, tm = http_service
    c = clip(2, 21)
    body = wav_bytes(c)
    want = serving._jsonable(transcribe_many(tm, [pcm16(c)], **OPTS)[0])

    health = json.loads(urllib.request.urlopen(base + "/healthz", timeout=60).read())
    assert health["status"] == "ok" and health["requests"] == 0

    got = _post(base + "/v1/transcribe?tags=3", body)
    tags = got.pop("audio_tags")
    assert json.dumps(got) == json.dumps(want)
    assert len(tags[0]["audio tags"]) == 3
    assert _status(base + "/v1/transcribe?bogus=1", body) == 400
    assert _status(base + "/nope") == 404
    assert _status(base + "/v1/stream", b"") == 404  # no streaming service
    assert _status(base + "/v1/transcribe", b"x" * (MAX_BODY + 1)) == 413
    assert _status(base + "/v1/transcribe", b"not a wav") == 400


def test_http_path_mode_is_confined_to_its_root(http_service, tmp_path):
    base, tm = http_service
    c = clip(1, 50)
    (tmp_path / "inside.wav").write_bytes(wav_bytes(c))
    got = _post(base + "/v1/transcribe", json.dumps({"path": "inside.wav"}).encode(),
                "application/json")
    assert got["text"] == transcribe_many(tm, [pcm16(c)], **OPTS)[0]["text"]
    for escape in ("../outside.wav", "/etc/hostname"):
        assert _status(base + "/v1/transcribe", json.dumps({"path": escape}).encode(),
                       "application/json") == 403


def test_stage_prof_counts_exactly_under_threads():
    prof = StageProf("WHISPER_AT_TPU_NO_SUCH_VARIABLE")
    assert not prof.enabled
    with prof("off"):
        pass
    prof.add("off", 1.0)
    assert prof.snapshot() == {}
    prof.enabled = True
    n_threads, n = 8, 2000
    start = threading.Barrier(n_threads)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            start.wait()
            for _ in range(n):
                prof.add("add", 0.001, 0.0005)
                with prof("cm"):
                    pass

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    snap = prof.snapshot()
    assert snap["add"]["count"] == snap["cm"]["count"] == n_threads * n
    assert snap["add"]["wall_ms"] == pytest.approx(n_threads * n * 1.0)
    assert prof.snapshot() == {}


def test_serve_prof_records_every_stage(pair, monkeypatch):
    from whisper_at_tpu_torch.transcribe import _serve_prof

    _, tm = pair
    monkeypatch.setattr(_serve_prof, "enabled", True)
    _serve_prof.snapshot()
    with TranscriptionService(tm, max_wait_s=0.05, **OPTS) as svc:
        svc.submit(clip(2, 7)).result(timeout=WAIT_S)
    stages = _serve_prof.snapshot()
    for key in ("frontend-mel", "detect", "decode", "tag-dispatch", "assembly", "tag-commit",
                "emit", "sched-fill", "sched-settle"):
        assert stages[key]["count"] >= 1, key
    assert stages["decode"]["wall_ms"] > 0
