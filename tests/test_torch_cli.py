"""The port's command line and output writers against the JAX package's:
the same `.npz` model and WAV files through both `cli()` functions in this
process give byte-identical txt/srt/vtt/tsv files and matching json, in the
sequential, single-file batched, multi-file batched and word-timestamp
runs; the writers agree on hand-made results; the flag checks, `--help`
and the device rule."""

import functools
import json
import os
import subprocess
import sys
import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisper_at_tpu as jax_wat
from whisper_at_tpu.checkpoint import save_params
from whisper_at_tpu.cli import cli as jax_cli
from whisper_at_tpu.models.dims import ModelDimensions
from whisper_at_tpu.models.whisper import Whisper as JaxWhisper
from whisper_at_tpu.utils import writers as jax_writers
from whisper_at_tpu_torch import cli as port_cli
import whisper_at_tpu_torch as wat
from whisper_at_tpu_torch.utils import writers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMON = ["--language", "en", "--fp16", "False", "--verbose", "False",
          "--beam_size", "None", "--best_of", "None",
          "--temperature_increment_on_fallback", "None", "--logprob_threshold", "None",
          "--compression_ratio_threshold", "None", "--no_speech_threshold", "None"]
TEXT_FORMATS = ("txt", "srt", "vtt", "tsv")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These models are tiny: the port's passes run on one thread, which
    keeps the file's time steady when other test processes share the
    cores (a thread pool per process oversubscribes them)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _wav(path, seconds: float, hz: float, amp: float, seed: int) -> str:
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000.0
    x = amp * np.sin(2 * np.pi * hz * t) + 0.02 * rng.standard_normal(len(t))
    with wave.open(str(path), "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(16000)
        wf.writeframes((np.clip(x, -1, 1) * 32767).astype(np.int16).tobytes())
    return str(path)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    dims = ModelDimensions(n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4,
                           n_audio_layer=2, n_vocab=51865, n_text_ctx=448, n_text_head=4,
                           n_text_state=64, n_text_layer=2)
    ckpt = str(root / "tiny_test.npz")
    save_params(ckpt, JaxWhisper(dims, seed=2).params, dims)
    return dict(root=root, ckpt=ckpt, wavs=[_wav(root / "clip.wav", 3, 440, 0.3, 0),
                                            _wav(root / "clip2.wav", 34, 330, 0.2, 1)])


def _run_both(assets, name, audio, extra):
    outs = []
    for label, run, tail in (("jax", jax_cli, []),
                             ("port", port_cli.cli, ["--device", "cpu"])):
        out = assets["root"] / f"{name}_{label}"
        run([*audio, "--model", assets["ckpt"], "--output_dir", str(out), *COMMON,
             *extra, *tail])
        outs.append(out)
    return outs


def _assert_same_outputs(jax_out, port_out, audio):
    for path in audio:
        stem = os.path.splitext(os.path.basename(path))[0]
        for ext in TEXT_FORMATS:
            ref = (jax_out / f"{stem}.{ext}").read_bytes()
            assert (port_out / f"{stem}.{ext}").read_bytes() == ref, (stem, ext)
        ref = json.loads((jax_out / f"{stem}.json").read_text())
        got = json.loads((port_out / f"{stem}.json").read_text())
        assert got.keys() == ref.keys()
        assert got["text"] == ref["text"] and got["language"] == ref["language"]
        assert len(got["segments"]) == len(ref["segments"])
        for g, r in zip(got["segments"], ref["segments"]):
            assert g["tokens"] == r["tokens"] and g["text"] == r["text"]
            for key in ("start", "end"):
                assert g[key] == pytest.approx(r[key], abs=1e-4)
            for key in ("avg_logprob", "compression_ratio", "no_speech_prob"):
                assert g[key] == pytest.approx(r[key], abs=1e-4)
            if "words" in r:
                assert [w["word"] for w in g["words"]] == [w["word"] for w in r["words"]]
                for gw, rw in zip(g["words"], r["words"]):
                    for key in ("start", "end", "probability"):
                        assert gw[key] == pytest.approx(rw[key], abs=1e-4)
        np.testing.assert_allclose(got["audio_tag"], ref["audio_tag"], atol=1e-4)


@pytest.mark.parametrize("name, files, extra", [
    ("sequential", [0], []),
    ("batched_one", [0], ["--batched", "True"]),
    ("batched_many", [0, 1], ["--batched", "True"]),
    ("words", [1], ["--word_timestamps", "True", "--highlight_words", "True",
                    "--max_line_width", "20", "--max_line_count", "2"]),
])
def test_cli_outputs_match_jax(assets, name, files, extra, monkeypatch):
    audio = [assets["wavs"][i] for i in files]
    if name == "words":
        # the command line loads bf16 weights, and both packages align a
        # bf16 model in bf16, where XLA's and PyTorch's roundings move this
        # random model's word boundaries by a 20 ms frame now and then (its
        # attention is nearly flat); both load fp32 weights here, where the
        # two agree (tests/test_torch_words.py)
        monkeypatch.setattr(jax_wat, "load_model",
                            functools.partial(jax_wat.load_model, dtype=jnp.float32))
        monkeypatch.setattr(wat, "load_model",
                            functools.partial(wat.load_model, dtype=torch.float32))
    jax_out, port_out = _run_both(assets, name, audio, extra)
    _assert_same_outputs(jax_out, port_out, audio)
    if name == "words":
        srt = (port_out / "clip2.srt").read_text()
        assert "<u>" in srt


@pytest.mark.parametrize("argv, message", [
    (["x.wav", "--model", "nosuch"], "official name"),
    (["x.wav", "--highlight_words", "True"], "--word_timestamps"),
    (["x.wav", "--max_line_width", "20"], "--word_timestamps"),
    (["x.wav", "--max_line_count", "2"], "--word_timestamps"),
    (["x.wav", "--output_format", "docx"], "invalid choice"),
    (["x.wav", "--language", "xx"], "invalid choice"),
])
def test_cli_flag_errors_match_jax(argv, message, capsys, tmp_path):
    argv = [*argv, "--output_dir", str(tmp_path / "o")]
    for run, tail in ((jax_cli, []), (port_cli.cli, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as exit_info:
            run(argv + tail)
        assert exit_info.value.code == 2
        assert message in capsys.readouterr().err


def test_cli_help_lists_every_jax_flag_and_device():
    proc = subprocess.run([sys.executable, "-m", "whisper_at_tpu_torch", "--help"],
                          capture_output=True, text=True, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    ref = subprocess.run([sys.executable, "-m", "whisper_at_tpu", "--help"],
                         capture_output=True, text=True, cwd=REPO, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    flags = {tok.strip("[],") for tok in ref.stdout.split() if tok.startswith(("--", "[--"))}
    flags = {f for f in flags if f.startswith("--")}
    assert "--word_timestamps" in flags
    for flag in flags | {"--device"}:
        assert flag in proc.stdout, flag


def test_cli_needs_the_card_unless_told(monkeypatch, assets, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_cli.cli([assets["wavs"][0], "--model", assets["ckpt"], "--output_dir",
                      str(tmp_path), *COMMON])
    assert not list(tmp_path.iterdir())


def _hand_result(with_words: bool) -> dict:
    rng = np.random.default_rng(4)
    words = [" Hello,", " world", " and", " a", " very-long-word", " after", " a",
             " pause", " -->", " tab\there", " end."]
    segments, t = [], 0.0
    for i in range(0, len(words), 3):
        chunk = []
        for w in words[i:i + 3]:
            start = t + float(rng.uniform(0.0, 0.3)) + (4.0 if w == " after" else 0.0)
            end = start + float(rng.uniform(0.1, 0.6))
            chunk.append({"word": w, "start": round(start, 2), "end": round(end, 2),
                          "probability": float(rng.uniform())})
            t = end
        seg = {"id": len(segments), "seek": 0, "start": chunk[0]["start"],
               "end": chunk[-1]["end"], "text": "".join(w["word"] for w in chunk),
               "tokens": [1, 2], "temperature": 0.0, "avg_logprob": -0.5,
               "compression_ratio": 1.0, "no_speech_prob": 0.1}
        if with_words:
            seg["words"] = chunk
        segments.append(seg)
    return {"text": "".join(s["text"] for s in segments), "segments": segments,
            "language": "en", "at_time_res": 10,
            "audio_tag": np.linspace(-1, 1, 2 * 527, dtype=np.float32).reshape(2, 527)}


@pytest.mark.parametrize("with_words", [False, True])
@pytest.mark.parametrize("options", [
    dict(max_line_width=None, max_line_count=None, highlight_words=False),
    dict(max_line_width=None, max_line_count=None, highlight_words=True),
    dict(max_line_width=12, max_line_count=None, highlight_words=False),
    dict(max_line_width=12, max_line_count=2, highlight_words=False),
    dict(max_line_width=8, max_line_count=1, highlight_words=True),
    dict(max_line_width=30, max_line_count=3, highlight_words=True),
])
def test_writers_match_jax_on_hand_made_results(tmp_path, with_words, options):
    result = _hand_result(with_words)
    for fmt in ("txt", "vtt", "srt", "tsv", "json"):
        (tmp_path / "j").mkdir(exist_ok=True)
        (tmp_path / "p").mkdir(exist_ok=True)
        jax_writers.get_writer(fmt, str(tmp_path / "j"))(result, "a/b/clip.mp3", options)
        writers.get_writer(fmt, str(tmp_path / "p"))(result, "a/b/clip.mp3", options)
        assert ((tmp_path / "p" / f"clip.{fmt}").read_bytes()
                == (tmp_path / "j" / f"clip.{fmt}").read_bytes()), fmt
    (tmp_path / "all").mkdir()
    writers.get_writer("all", str(tmp_path / "all"))(result, "clip.wav", options)
    assert sorted(os.listdir(tmp_path / "all")) == [f"clip.{e}" for e in
                                                    ("json", "srt", "tsv", "txt", "vtt")]


# --------------------------------------------------------------------------- #
# load_model, non-WAV input, the label printers
# --------------------------------------------------------------------------- #


def test_load_model_reads_a_jax_npz(tmp_path):
    from whisper_at_tpu.models.dims import ModelDimensions as JaxDims
    from whisper_at_tpu_torch.convert import from_jax_params

    dims = JaxDims(n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4,
                   n_audio_layer=2, n_vocab=51865, n_text_ctx=448, n_text_head=4,
                   n_text_state=64, n_text_layer=2)
    jm = JaxWhisper(dims, seed=5)
    save_params(str(tmp_path / "m.npz"), jm.params, dims)
    model = wat.load_model(str(tmp_path / "m.npz"), device="cpu", dtype=torch.float32)
    ref = from_jax_params(jm.params)
    state = model.state_dict()
    assert state.keys() == ref.keys()
    for key, value in ref.items():
        assert torch.equal(state[key], value.float()), key
    assert model.dims.n_text_state == 64 and model.device.type == "cpu"
    save_params(str(tmp_path / "nodims.npz"), jm.params)
    with pytest.raises(RuntimeError, match="dimensions"):
        wat.load_model(str(tmp_path / "nodims.npz"), device="cpu")


@pytest.fixture(scope="module")
def official_tiny(tmp_path_factory):
    """A random tiny model saved under the reference's file names: the
    Whisper checkpoint and its TL-TR head file."""
    root = tmp_path_factory.mktemp("whisper_cache")
    src = wat.build_model("tiny", device="cpu", seed=7, dtype=torch.bfloat16)
    sd = src.state_dict()
    torch.save({"dims": vars(src.dims),
                "model_state_dict": {k: v for k, v in sd.items() if not k.startswith("at_")}},
               root / "tiny.pt")
    torch.save({"module." + k[len("at_model."):]: v for k, v in sd.items()
                if k.startswith("at_model.")}, root / "tiny_ori.pth")
    import hashlib

    sha = hashlib.sha256((root / "tiny.pt").read_bytes()).hexdigest()
    return root, sha, sd


def _registry(monkeypatch, sha):
    monkeypatch.setattr(wat, "_MODELS", {"tiny": f"https://example.invalid/models/{sha}/tiny.pt"})
    monkeypatch.setattr(wat, "_MODELS_AT",
                        {"tiny": "https://example.invalid/s/abc/tiny_ori.pth?dl=1"})


def test_load_model_reads_an_official_name_from_download_root(monkeypatch, official_tiny):
    from whisper_at_tpu_torch.models.whisper import decode_alignment_heads
    from whisper_at_tpu_torch.registry import _ALIGNMENT_HEADS

    root, sha, sd = official_tiny
    _registry(monkeypatch, sha)
    assert wat.available_models() == ["tiny"]
    model = wat.load_model("tiny", device="cpu", download_root=str(root))
    for key, value in model.state_dict().items():
        assert torch.equal(value, sd[key]), key
    np.testing.assert_array_equal(model.alignment_heads,
                                  decode_alignment_heads(_ALIGNMENT_HEADS["tiny"], model.dims))
    in_memory = wat.load_model("tiny", device="cpu", download_root=str(root), in_memory=True)
    assert all(torch.equal(v, sd[k]) for k, v in in_memory.state_dict().items())
    # the default root: $XDG_CACHE_HOME/whisper
    monkeypatch.setenv("XDG_CACHE_HOME", str(root.parent / "nowhere"))
    with pytest.raises(FileNotFoundError, match="nowhere"):
        wat.load_model("tiny", device="cpu")


def test_load_model_refuses_a_wrong_checksum_and_leaves_the_file(monkeypatch, official_tiny):
    root, sha, _ = official_tiny
    before = (root / "tiny.pt").read_bytes()
    _registry(monkeypatch, "0" * 64)
    with pytest.raises(RuntimeError, match="sha256"):
        wat.load_model("tiny", device="cpu", download_root=str(root))
    assert (root / "tiny.pt").read_bytes() == before


def test_load_model_never_downloads_a_missing_file(monkeypatch, tmp_path, official_tiny):
    _, sha, _ = official_tiny
    _registry(monkeypatch, sha)
    with pytest.raises(FileNotFoundError, match="tiny.pt.*does not download"):
        wat.load_model("tiny", device="cpu", download_root=str(tmp_path))
    assert not list(tmp_path.iterdir())


FAKE_FFMPEG = """#!{python}
import sys
open({log!r}, "a").write(" ".join(sys.argv[1:]) + "\\n")
sys.stdout.buffer.write(open({pcm!r}, "rb").read())
"""


def test_non_wav_input_needs_ffmpeg(monkeypatch, tmp_path):
    from whisper_at_tpu_torch import audio

    monkeypatch.setenv("PATH", str(tmp_path))
    for load in (audio.load_audio, audio.load_audio_pcm16):
        with pytest.raises(RuntimeError, match=r"ffmpeg.*clip\.mp3"):
            load(str(tmp_path / "clip.mp3"))


def test_non_wav_input_goes_through_ffmpeg(monkeypatch, tmp_path):
    from whisper_at_tpu.audio import _ffmpeg_pcm16 as jax_ffmpeg
    from whisper_at_tpu_torch import audio

    rng = np.random.default_rng(6)
    pcm = (rng.standard_normal(16000 * 3) * 3000).astype(np.int16)
    (tmp_path / "pcm.raw").write_bytes(pcm.tobytes())
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    fake = bin_dir / "ffmpeg"
    fake.write_text(FAKE_FFMPEG.format(python=sys.executable, log=str(tmp_path / "argv.log"),
                                       pcm=str(tmp_path / "pcm.raw")))
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    mp3 = str(tmp_path / "clip.mp3")
    np.testing.assert_array_equal(audio.load_audio_pcm16(mp3), pcm)
    np.testing.assert_array_equal(audio.load_audio(mp3), pcm.astype(np.float32) / 32768.0)
    np.testing.assert_array_equal(jax_ffmpeg(mp3, 16000), pcm)
    calls = (tmp_path / "argv.log").read_text().splitlines()
    assert len(calls) == 3 and calls[0] == calls[1] == calls[2]  # the JAX command line
    assert calls[0] == f"-nostdin -threads 0 -i {mp3} -f s16le -ac 1 -acodec pcm_s16le -ar 16000 -"

    model = wat.build_model("", device="cpu", seed=3, dims=wat.ModelDimensions(
        n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4, n_audio_layer=2,
        n_vocab=51865, n_text_ctx=448, n_text_head=4, n_text_state=64, n_text_layer=2))
    kw = dict(language="en", temperature=0.0, fp16=False, sample_len=8,
              logprob_threshold=None, compression_ratio_threshold=None,
              no_speech_threshold=None)
    from_file = wat.transcribe_batched(model, mp3, **kw)
    from_pcm = wat.transcribe_batched(model, pcm, **kw)
    assert [s["tokens"] for s in from_file["segments"]] == \
        [s["tokens"] for s in from_pcm["segments"]]
    np.testing.assert_array_equal(from_file["audio_tag"], from_pcm["audio_tag"])


def test_label_printers_and_version_match_jax(capsys):
    import whisper_at_tpu as jax_pkg

    for lang in ("en", "zh"):
        jax_pkg.print_label_name(lang)
        ref = capsys.readouterr().out
        wat.print_label_name(lang)
        assert capsys.readouterr().out == ref
    jax_pkg.print_support_language()
    ref = capsys.readouterr().out
    wat.print_support_language()
    assert capsys.readouterr().out == ref and ref.count("\n") > 10
    assert wat.__version__ == jax_pkg.__version__
