"""The port's own rules: it loads no JAX, its entry points default to the
card, unported options refuse loudly, invalid options fail as in the JAX
package, and its standard-library tokenizer matches the JAX package's
`regex`-based one."""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import regex
import torch

import whisper_at_tpu_torch as wat
from whisper_at_tpu.tokenizer import get_tokenizer as jax_get_tokenizer
from whisper_at_tpu.utils import compression_ratio as jax_compression_ratio
from whisper_at_tpu.utils import format_timestamp as jax_format_timestamp
from whisper_at_tpu_torch import utils
from whisper_at_tpu_torch.bpe import pretokenize
from whisper_at_tpu_torch.tokenizer import get_tokenizer

pytestmark = pytest.mark.quick

GPT2_PATTERN = regex.compile(
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""")

SAMPLES = [
    "Hello, world! It's a test; we'll see.",                 # ASCII + contractions
    "Café déjà vu, naïve façade — Ærø, São Paulo",            # accented Latin
    "我们今天去公园。東京は晴れです。서울 날씨",                # CJK, Hangul
    "In 1999 there were 3,141 cases (42%) and ½ of ٣٤",       # digits, other numerals
    "?!... -- ((x)) [[y]] {z} ♪♪ \"quoted\" 'single'",        # punctuation runs
    "  leading\n\n\ttabs   and    spaces  \n trailing  ",     # whitespace runs
    "mixed\xa0nbsp\u3000ideographic\u2009thin\u2028line",        # Unicode spaces
    "'S 'LL don't I'm they've 're",                           # case-sensitive contractions
]


def test_import_loads_no_jax():
    code = ("import sys, whisper_at_tpu_torch, whisper_at_tpu_torch.transcribe, "
            "whisper_at_tpu_torch.convert, whisper_at_tpu_torch.ops, "
            "whisper_at_tpu_torch.timing, whisper_at_tpu_torch.registry, "
            "whisper_at_tpu_torch.ops.dtw, whisper_at_tpu_torch.ops.median, "
            "whisper_at_tpu_torch.ops.w4_matmul, whisper_at_tpu_torch.ops.enc_flash, "
            "whisper_at_tpu_torch.ops.fused_mlp, whisper_at_tpu_torch.ops.flash_decode, "
            "whisper_at_tpu_torch.ops.cross_decode_stream, whisper_at_tpu_torch.ops.probe_dma, "
            "whisper_at_tpu_torch.serving, whisper_at_tpu_torch.streaming, "
            "whisper_at_tpu_torch.utils.profiling, whisper_at_tpu_torch.audio, "
            "whisper_at_tpu_torch.cli, whisper_at_tpu_torch.normalizers, "
            "whisper_at_tpu_torch.utils.writers, whisper_at_tpu_torch.version, "
            "whisper_at_tpu_torch.parallel.mesh, whisper_at_tpu_torch.parallel.tensor, "
            "whisper_at_tpu_torch.parallel.inference, whisper_at_tpu_torch.parallel.pipeline, "
            "whisper_at_tpu_torch.parallel.sequence; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            "'whisper_at_tpu')]; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_training_modules_load_no_jax_optax_or_sklearn():
    """The training stack, the extraction, the checkpoint files and the
    operation counts load neither JAX, optax nor scikit-learn (the card's
    machine has none of them), nor the JAX package."""
    code = ("import sys, whisper_at_tpu_torch.train, whisper_at_tpu_torch.train.run, "
            "whisper_at_tpu_torch.research, whisper_at_tpu_torch.research.feature_extract, "
            "whisper_at_tpu_torch.checkpoint, whisper_at_tpu_torch.ops.flops; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'optax', "
            "'sklearn', 'whisper_at_tpu')]; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_probe_tool_loads_no_jax():
    """`tools/probe_dma_torch.py` (and `chip_smoke.py`, which it imports)
    load neither JAX nor the JAX package."""
    code = ("import importlib.util, sys; "
            "spec = importlib.util.spec_from_file_location('probe_dma_torch', "
            "'tools/probe_dma_torch.py'); "
            "spec.loader.exec_module(importlib.util.module_from_spec(spec)); "
            "assert 'chip_smoke' in sys.modules; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            "'whisper_at_tpu')]; print(bad); sys.exit(1 if bad else 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=root)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("tool", ["time_k3.py", "time_k8.py", "time_k6_k9.py",
                                  "profile_spec_torch.py", "mesh_torch.py"])
def test_timing_tools_load_no_jax(tool):
    """The kernel timing tools, with `chip_smoke.py` that their `main`
    imports, load neither JAX nor the JAX package."""
    code = ("import importlib.util, sys; sys.path.insert(0, '.'); "
            f"spec = importlib.util.spec_from_file_location('tool', 'tools/{tool}'); "
            "spec.loader.exec_module(importlib.util.module_from_spec(spec)); "
            "import chip_smoke; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            "'whisper_at_tpu')]; print(bad); sys.exit(1 if bad else 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=root)
    assert proc.returncode == 0, proc.stdout + proc.stderr


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on the card: it shows what a kernel
    wrapper does with a CUDA tensor on a machine without one."""

    @property
    def is_cuda(self):
        return True


def _wrapper_cases():
    """(ops module, kernel, plain function name, wrapper, argument maker) of
    each entry of K4 and K7-K10, P1 and P2; the arguments are small and well
    formed."""
    from whisper_at_tpu_torch.models.layers import QuantLinear
    from whisper_at_tpu_torch.ops import (
        cross_decode, cross_decode_stream, enc_flash, flash_decode, fused_mlp, probe_dma)

    bf, i8, f32 = torch.bfloat16, torch.int8, torch.float32
    gen = torch.Generator().manual_seed(0)

    def rand(shape, dtype):
        if dtype == i8:
            return torch.randint(-7, 8, shape, generator=gen, dtype=i8)
        return torch.randn(shape, generator=gen).to(dtype)

    def linear(n_out, n_in, quantized):
        if quantized:
            return lambda on: QuantLinear(on(rand((n_out, n_in), i8)),
                                          on(rand((n_out,), f32).abs()),
                                          on(rand((n_out,), bf)))
        return lambda on: type("Lin", (), dict(weight=on(rand((n_out, n_in), bf)),
                                                bias=on(rand((n_out,), bf))))()

    def cross(width):
        return lambda on: (on(rand((1, 2, 64), bf)), on(rand((1, 128, width), i8)),
                           on(rand((1, 2, 128), f32)), on(rand((1, 128, width), i8)),
                           on(rand((1, 2, 128), f32)), on(torch.zeros(128)), 2)

    return {
        "cross_decode": (cross_decode, cross_decode.KERNEL, "cross_attention_int8_plain",
                         cross_decode.cross_attention_int8, cross(128)),
        "cross_decode4": (cross_decode, cross_decode.KERNEL4, "cross_attention_int4_plain",
                          cross_decode.cross_attention_int4, cross(64)),
        "enc_flash": (enc_flash, enc_flash.KERNEL, "enc_flash_plain", enc_flash.enc_flash,
                      lambda on: (*(on(rand((1, 64, 128), bf)) for _ in range(3)), 2)),
        "fused_mlp": (fused_mlp, fused_mlp.KERNEL, "fused_mlp_plain", fused_mlp.fused_mlp,
                      lambda on: (on(rand((3, 64), bf)), linear(256, 64, False)(on),
                                  linear(64, 256, False)(on))),
        "fused_mlp_int8": (fused_mlp, fused_mlp.KERNEL_INT8, "fused_mlp_plain",
                           fused_mlp.fused_mlp,
                           lambda on: (on(rand((3, 64), bf)), linear(256, 64, True)(on),
                                       linear(64, 256, True)(on))),
        "flash_decode": (flash_decode, flash_decode.KERNEL, "flash_decode_cross_plain",
                         flash_decode.flash_decode_cross,
                         lambda on: (on(rand((2, 64), bf)), on(rand((1, 128, 128), i8)),
                                     on(rand((1, 2, 128), f32)), on(rand((1, 128, 128), i8)),
                                     on(rand((1, 2, 128), f32)), 2)),
        "cross_decode_stream": (cross_decode_stream, cross_decode_stream.KERNEL,
                                "cross_attention_stream_plain",
                                cross_decode_stream.cross_attention_stream, cross(128)),
        "cross_decode_stream4": (cross_decode_stream, cross_decode_stream.KERNEL4,
                                 "cross_attention_stream4_plain",
                                 cross_decode_stream.cross_attention_stream4, cross(64)),
        "probe_auto": (probe_dma, probe_dma.KERNEL_AUTO, "stream_plain", probe_dma.stream_auto,
                       lambda on: (on(rand((128, 128), i8)), 64)),
        "probe_ring_cp": (probe_dma, probe_dma.KERNEL_CP, "stream_plain", probe_dma.stream_ring,
                          lambda on: (on(rand((128, 128), i8)), 64, 4, "cp_async")),
        "probe_ring_tma": (probe_dma, probe_dma.KERNEL_TMA, "stream_plain",
                           probe_dma.stream_ring,
                           lambda on: (on(rand((128, 128), i8)), 64, 8, "tma")),
    }


@pytest.mark.parametrize("name", ["cross_decode", "cross_decode4", "enc_flash", "fused_mlp",
                                  "fused_mlp_int8", "flash_decode",
                                  "cross_decode_stream", "cross_decode_stream4", "probe_auto",
                                  "probe_ring_cp", "probe_ring_tma"])
def test_wrappers_take_the_plain_version_only_on_cpu_tensors(monkeypatch, name):
    """Each new wrapper runs its plain version for CPU tensors and never
    launches; for tensors on the card it launches its kernel once and never
    runs the plain version (no fallback)."""
    module, kernel, plain_name, wrapper, make_args = _wrapper_cases()[name]
    launched = []
    monkeypatch.setattr(kernel, "launch", lambda *a: launched.append(a))
    monkeypatch.setattr(kernel, "c_function", lambda *a: lambda *b: 1)
    monkeypatch.setattr(module, "stream_handle", lambda device: None)
    if hasattr(module, "wave_slots"):  # K4 reads the card's SM count
        monkeypatch.setattr(module, "wave_slots", lambda index: 528)
    wrapper(*make_args(lambda t: t))
    assert not launched

    def refuse(*args, **kwargs):
        raise AssertionError("the plain version ran on a card tensor")

    monkeypatch.setattr(module, plain_name, refuse)
    wrapper(*make_args(lambda t: torch.Tensor._make_subclass(_OnCard, t)))
    assert len(launched) == 1


@pytest.mark.parametrize("m, k, n", [(0, 1280, 1280), (257, 1280, 1280), (24, 1280, 96),
                                     (24, 48, 128), (24, 5152, 128), (24, 1280, 0)])
def test_w4_matmul_wrapper_refuses_shapes_outside_its_contract(monkeypatch, m, k, n):
    """K5's wrapper, given tensors on the card, raises for M outside 1..256,
    N not a multiple of 64, K not a multiple of 32 or above 5120, before
    any launch."""
    from whisper_at_tpu_torch.ops import w4_matmul

    launched = []
    monkeypatch.setattr(w4_matmul.KERNEL, "launch", lambda *a: launched.append(a))
    monkeypatch.setattr(w4_matmul, "stream_handle", lambda device: None)

    def on_card(t):
        return torch.Tensor._make_subclass(_OnCard, t)

    x = on_card(torch.zeros((m, k), dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        w4_matmul.w4_matmul(x, on_card(torch.zeros((n, k // 2), dtype=torch.int8)))
    with pytest.raises(ValueError, match="pack"):
        w4_matmul.w4_matmul(on_card(torch.zeros((24, 1280), dtype=torch.bfloat16)),
                            on_card(torch.zeros((128, 320), dtype=torch.int8)))
    assert not launched
    w4_matmul.w4_matmul(on_card(torch.zeros((24, 1280), dtype=torch.bfloat16)),
                        on_card(torch.zeros((128, 640), dtype=torch.int8)))
    assert len(launched) == 1


@pytest.mark.parametrize("bits", [8, 4])
def test_cross_decode_wrapper_refuses_inputs_outside_its_contract(monkeypatch, bits):
    """K4's wrapper, given tensors on the card, raises for Ta_pad not a
    multiple of 4 (the copy engine moves the scales in 16-byte units) and
    for a bias of another length, before any launch."""
    from whisper_at_tpu_torch.ops import cross_decode as cd

    kernel, wrapper = ((cd.KERNEL4, cd.cross_attention_int4) if bits == 4
                       else (cd.KERNEL, cd.cross_attention_int8))
    launched = []
    monkeypatch.setattr(kernel, "launch", lambda *a: launched.append(a))
    monkeypatch.setattr(kernel, "c_function", lambda *a: lambda *b: 1)
    monkeypatch.setattr(cd, "stream_handle", lambda device: None)
    monkeypatch.setattr(cd, "wave_slots", lambda index: 528)

    def args(ta_pad, bias_len):
        width = 2 * 64 * bits // 8
        on = lambda t: torch.Tensor._make_subclass(_OnCard, t)  # noqa: E731
        return (on(torch.zeros((1, 2, 64), dtype=torch.bfloat16)),
                on(torch.zeros((1, ta_pad, width), dtype=torch.int8)),
                on(torch.ones((1, 2, ta_pad))),
                on(torch.zeros((1, ta_pad, width), dtype=torch.int8)),
                on(torch.ones((1, 2, ta_pad))), on(torch.zeros(bias_len)), 2)

    for ta_pad, bias_len in ((126, 126), (1, 1), (128, 64)):
        with pytest.raises(ValueError):
            wrapper(*args(ta_pad, bias_len))
    assert not launched
    wrapper(*args(132, 132))
    assert len(launched) == 1


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        wat.build_model("tiny")
    with pytest.raises(RuntimeError, match="CUDA"):
        wat.log_mel_spectrogram(np.zeros(1600, np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        wat.prefetch_audio(np.zeros(1600, np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        wat.prefetch_audio_many([np.zeros(1600, np.float32)])
    from whisper_at_tpu_torch import serving

    with pytest.raises(RuntimeError, match="CUDA"):
        serving.main(["--random", "--model", "tiny"])
    model = wat.build_model("tiny", device="cpu")
    with wat.TranscriptionService(model, language="en") as svc:  # on its model's device
        assert svc._prep(np.zeros(1600, np.float32)).device.type == "cpu"
    path = tmp_path / "tiny.pt"
    torch.save({"dims": vars(model.dims), "model_state_dict": model.state_dict()}, path)
    with pytest.raises(RuntimeError, match="CUDA"):
        wat.load_model(str(path))
    with pytest.raises(RuntimeError, match="CUDA"):
        wat.load_model("tiny", download_root=str(tmp_path))  # before any file lookup
    assert model.device.type == "cpu"
    from whisper_at_tpu_torch.cli import cli

    with pytest.raises(RuntimeError, match="CUDA"):
        cli([str(tmp_path / "a.wav"), "--model", str(path), "--output_dir", str(tmp_path)])

    from whisper_at_tpu_torch.research import feature_extract
    from whisper_at_tpu_torch.train import loop, run
    from whisper_at_tpu_torch.train.tltr import TLTR

    head = TLTR(4, 2, 16, "lw_tr_1_4")
    with pytest.raises(RuntimeError, match="CUDA"):
        loop.train(head, "lw_tr_1_4", [], [], exp_dir=str(tmp_path / "exp"))
    card_model = type("CardModel", (), {"device": torch.device("cuda")})()
    (tmp_path / "data.json").write_text('{"data": []}')
    with pytest.raises(RuntimeError, match="CUDA"):
        feature_extract.extract_feature_set(card_model, str(tmp_path / "data.json"),
                                            str(tmp_path / "feats"))
    with pytest.raises(RuntimeError, match="CUDA"):
        feature_extract.extract_features_many(card_model, [np.zeros(16000, np.int16)])
    with pytest.raises(RuntimeError, match="CUDA"):
        run.main(["--data-train", "t.json", "--exp-dir", str(tmp_path / "exp")])
    with pytest.raises(RuntimeError, match="CUDA"):
        loop.load_tltr({"mlp": {"w": np.zeros((16, 4))}}, "mean_mlp")
    assert not (tmp_path / "exp").exists()


def test_training_refuses_a_mesh(tmp_path):
    """A mesh that is not a `parallel.mesh.Mesh` is refused with TypeError
    before anything runs (meshes train: test_torch_parallel_train.py)."""
    from whisper_at_tpu_torch.train import loop, steps
    from whisper_at_tpu_torch.train.tltr import TLTR

    head = TLTR(4, 2, 16, "lw_tr_1_4")
    with pytest.raises(TypeError, match="mesh"):
        loop.train(head, "lw_tr_1_4", [], [], exp_dir=str(tmp_path / "exp"), mesh=object(),
                   device="cpu")
    with pytest.raises(TypeError, match="mesh"):
        steps.make_sharded_train_step(object(), "lw_tr_1_4", head, 1e-3)
    assert not (tmp_path / "exp").exists()


def test_load_model_reads_a_local_reference_checkpoint(tmp_path):
    """The reference file layout ({"dims", "model_state_dict"}) plus a
    separate head file with `module.*` keys loads on the CPU."""
    src = wat.build_model("tiny", device="cpu", seed=1)
    sd = src.state_dict()
    whisper_part = {k: v for k, v in sd.items() if not k.startswith("at_model.")}
    head_part = {"module." + k[len("at_model."):]: v for k, v in sd.items()
                 if k.startswith("at_model.")}
    torch.save({"dims": vars(src.dims), "model_state_dict": whisper_part}, tmp_path / "w.pt")
    torch.save(head_part, tmp_path / "head.pth")
    model = wat.load_model(str(tmp_path / "w.pt"), device="cpu", dtype=torch.float32,
                           at_checkpoint=str(tmp_path / "head.pth"))
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    with pytest.raises(FileNotFoundError):
        wat.load_model(str(tmp_path / "missing.pt"), device="cpu")


@pytest.fixture
def one_torch_thread():
    """A decode on one thread: other test processes share the cores, and a
    thread pool per process oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("kwargs, what", [
    (dict(mesh=object()), "mesh"),
    (dict(kv_layout="heads", kv_quant=True), "fused"),
])
def test_unported_options_raise(kwargs, what, one_torch_thread):
    """Both options are ported now: a mesh that is not a `parallel.mesh.Mesh`
    raises TypeError, and kv_layout="heads" (the JAX package's layout under
    a mesh) decodes through the fused layout with its result."""
    model = wat.build_model("tiny", device="cpu")
    audio = np.zeros(16000 * 2, np.int16)
    kwargs = {"temperature": 0.0, "sample_len": 8, **kwargs}
    if what == "mesh":
        with pytest.raises(TypeError, match=what):
            wat.transcribe_batched(model, audio, language="en", fp16=False, **kwargs)
        return
    got = wat.transcribe_batched(model, audio, language="en", fp16=False, **kwargs)
    kwargs.pop("kv_layout")
    ref = wat.transcribe_batched(model, audio, language="en", fp16=False, **kwargs)
    assert got["text"] == ref["text"]
    assert [s["tokens"] for s in got["segments"]] == [s["tokens"] for s in ref["segments"]]
    np.testing.assert_array_equal(got["audio_tag"], ref["audio_tag"])


@pytest.mark.parametrize("options", [
    dict(beam_size=2, best_of=2),
    dict(temperature=0.0, best_of=3),
    dict(patience=2.0),
    dict(length_penalty=3.0),
    dict(length_penalty=-0.1),
    dict(kv_bits=6),
    dict(weight_bits=2),
    dict(self_kv_bits=16),
    dict(draft="same", temperature=0.4),
    dict(draft="same", beam_size=2),
    dict(draft="same", temperature=0.4, best_of=2),
    dict(draft="same", self_kv_quant=True),
    dict(draft="same", draft_lookahead=0),
    dict(draft="english"),
])
def test_option_rules_match_jax(options):
    """The options the JAX package refuses with ValueError, the port refuses
    the same way. The draft model's rules read the models (its vocabulary
    against the verifier's), so those cases build a task on a model in
    each package."""
    from whisper_at_tpu.decoding import DecodingOptions as JaxOptions
    from whisper_at_tpu.decoding import DecodingTask as JaxTask
    from whisper_at_tpu.models.dims import ModelDimensions as JaxDims
    from whisper_at_tpu.models.whisper import Whisper as JaxWhisper

    options = dict(options)
    draft = options.pop("draft", None)
    if draft is None:
        with pytest.raises(ValueError):
            JaxTask._verify_options(None, JaxOptions(**options))
        with pytest.raises(ValueError):
            wat.decoding.DecodingTask._verify_options(None, wat.DecodingOptions(**options))
        return
    dims = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=2,
                n_audio_layer=1, n_vocab=51865, n_text_ctx=448, n_text_head=2,
                n_text_state=64, n_text_layer=1)
    draft_dims = dict(dims, n_vocab=51864) if draft == "english" else dims
    jax_pair = [JaxWhisper(JaxDims(**d), seed=1) for d in (dims, draft_dims)]
    port_pair = [wat.build_model("", device="cpu", dims=wat.ModelDimensions(**d))
                 for d in (dims, draft_dims)]
    with pytest.raises(ValueError):
        JaxTask(jax_pair[0], JaxOptions(draft_model=jax_pair[1], **options))
    with pytest.raises(ValueError):
        wat.decoding.DecodingTask(port_pair[0], wat.DecodingOptions(draft_model=port_pair[1],
                                                                     **options))


def test_unported_entry_points_raise():
    """transcribe_many and both services take a mesh now; anything that is
    not a `parallel.mesh.Mesh` is refused with TypeError."""
    from whisper_at_tpu_torch.transcribe import transcribe_many

    model = wat.build_model("tiny", device="cpu")
    with pytest.raises(TypeError, match="mesh"):
        transcribe_many(model, [np.zeros(1600, np.int16)], mesh=object(), language="en")
    for service in (wat.TranscriptionService, wat.StreamingService):
        with pytest.raises(TypeError, match="mesh"):
            service(model, mesh=object())


@pytest.mark.parametrize("without_timestamps", [False, True])
def test_prefill_pad_slots_leave_the_token_budget_whole(without_timestamps, one_torch_thread):
    """A 300-token prompt (its last 223 kept) prefills in the 256-slot
    bucket; the pad slots take no position, so the decode may sample
    min(sample_len, n_ctx + 1 - len(initial tokens)) tokens, the reference
    loop's budget (222 for the 227 initial tokens), not n_ctx + 1 - 256."""
    dims = wat.ModelDimensions(n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=2,
                               n_audio_layer=1, n_vocab=51865, n_text_ctx=448,
                               n_text_head=2, n_text_state=64, n_text_layer=1)
    model = wat.build_model("", device="cpu", dims=dims, seed=2)
    mel = torch.from_numpy((np.random.default_rng(1).standard_normal((80, 3000)) * 0.4
                            ).astype(np.float32))
    options = wat.DecodingOptions(language="en", fp16=False, prompt=list(range(300)),
                                  without_timestamps=without_timestamps,
                                  suppress_tokens=[-1, 50257])  # never EOT: the whole budget
    task = wat.decoding.DecodingTask(model, options)
    initial = len(task.initial_tokens)
    assert initial == 227 + without_timestamps
    assert wat.decoding._prefill_bucket(initial) == 256
    budget = min(task.sample_len, dims.n_text_ctx + 1 - initial)
    result = wat.decode(model, mel, options)
    assert len(result.tokens) == budget == 222 - without_timestamps


def test_kernel_loader_builds_once_and_counts_exactly_under_threads(monkeypatch):
    """Eight threads that first reach one kernel together: its library is
    built and loaded once, and every launch is counted."""
    from whisper_at_tpu_torch.ops import cuda, enc_attention

    kernel = enc_attention.KERNEL
    builds, loads = [], []

    def start_build():
        builds.append(1)
        time.sleep(0.05)  # a build that takes a while, so the threads meet in it

    class Library:
        def __init__(self, path):
            loads.append(path)
            setattr(self, kernel.entry, lambda *args: 0)

    monkeypatch.setattr(kernel, "_lib", None)
    monkeypatch.setattr(kernel, "_fn", None)
    monkeypatch.setattr(kernel, "launches", 0)
    monkeypatch.setattr(kernel, "start_build", start_build)
    monkeypatch.setattr(kernel, "finish_build", lambda proc: None)
    monkeypatch.setattr(cuda.ctypes, "CDLL", Library)
    n_threads, n = 8, 2000
    start = threading.Barrier(n_threads)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            start.wait()
            for _ in range(n):
                kernel.launch()

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert len(builds) == len(loads) == 1
    assert kernel.launches == n_threads * n
    cuda.reset_launch_counts()
    assert kernel.launches == 0


@pytest.mark.parametrize("text", SAMPLES)
def test_pretokenizer_matches_regex(text):
    assert list(pretokenize(text)) == GPT2_PATTERN.findall(text)


def test_pretokenizer_fuzz_matches_regex():
    rng = np.random.default_rng(0)
    alphabet = list("ab Z9 '\n\t.,!?-") + ["'s", "'ll", "é", "中文", "٣", "½", "　", "\xa0",
                                           "  ", "'S", "€", "🙂", "x́"]
    for _ in range(2000):
        text = "".join(rng.choice(alphabet) for _ in range(rng.integers(0, 14)))
        assert list(pretokenize(text)) == GPT2_PATTERN.findall(text), repr(text)


@pytest.mark.parametrize("multilingual", [True, False])
def test_tokenizer_matches_jax(multilingual):
    ours = get_tokenizer(multilingual, language="en", task="transcribe")
    ref = jax_get_tokenizer(multilingual, language="en", task="transcribe")
    for text in SAMPLES:
        ids = ours.encode(text)
        assert ids == ref.encode(text), text
        assert ours.decode(ids) == ref.decode(ids) == text
    assert ours.sot_sequence == ref.sot_sequence
    assert ours.non_speech_tokens == ref.non_speech_tokens
    assert ours.special_tokens == ref.special_tokens
    for name in ("eot", "sot", "sot_prev", "sot_lm", "no_speech", "no_timestamps",
                 "timestamp_begin", "transcribe", "translate"):
        assert getattr(ours, name) == getattr(ref, name), name
    if multilingual:
        assert ours.language_token == ref.language_token
        assert set(ours.all_language_tokens) == set(ref.all_language_tokens)
        tok = get_tokenizer(True, language="German", task="translate")
        assert tok.sot_sequence == jax_get_tokenizer(True, language="german",
                                                     task="translate").sot_sequence
    special = "<|startoftranscript|>hi<|0.00|> there<|endoftext|>"
    assert ours.encode(special, allowed_special="all") == ref.encode(
        special, allowed_special="all")


def test_utils_match_jax():
    for s in (0.0, 1.234, 59.9996, 3723.5):
        assert utils.format_timestamp(s) == jax_format_timestamp(s)
        assert utils.format_timestamp(s, True, ",") == jax_format_timestamp(s, True, ",")
    text = "the cat sat on the mat " * 20
    assert utils.compression_ratio(text) == jax_compression_ratio(text)
    assert utils.exact_div(3000, 1500) == 2
    with pytest.raises(ValueError):
        utils.exact_div(3001, 1500)


# the public names of the JAX package that the port has on purpose not: a
# closed list, (module, name) -> why; a name dropped from the port later, or
# one the JAX package gains, fails `test_public_names_match_jax`
NOT_PORTED = {
    ("audio", "log_mel_spectrogram_jax"):
        "the JAX device mel; the port's log_mel_spectrogram runs on the tensor's device",
    ("streaming", "log_mel_spectrogram_jax"): "the same JAX device mel, imported there",
    ("ops", "log_mel_spectrogram_jax"): "the same JAX device mel, exported there",
    ("checkpoint", "convert_torch_state_dict"):
        "reference state dict -> JAX tree; the port's parameters are that state dict",
    ("checkpoint", "export_torch_state_dict"):
        "JAX tree -> reference state dict; the port's model.state_dict() is it",
    ("checkpoint", "convert_head_state_dict"):
        "head state dict -> JAX tree; load_model merges a head file as it is "
        "(rename_head_state_dict)",
    ("checkpoint", "load_torch_checkpoint"):
        "a reference .pt into JAX trees; the port's load_model reads it into the model",
    ("checkpoint", "save_params_orbax"): "orbax, JAX's checkpoint library; the port has none",
    ("checkpoint", "load_params_orbax"): "orbax, JAX's checkpoint library; the port has none",
    ("decoding", "cross_kv_payload"):
        "unwraps the JAX cross K/V pytree; the port's CrossKV is one object",
    ("utils", "honor_jax_platforms_env"):
        "sets JAX's platform from JAX_PLATFORMS; the port takes device= instead",
}
PAIRED_MODULES = ["", "audio", "checkpoint", "decoding", "transcribe", "timing", "streaming",
                  "serving", "utils", "ops", "models", "train", "parallel", "research"]
# the research modules, each compared on the names it defines itself
RESEARCH_MODULES = ["research.wer", "research.noisy_speech", "research.as_eval",
                    "research.layer_probe", "research.plots", "research.baselines",
                    "research.feature_extract"]


def _public_names(module, package: str, own: bool = False) -> set:
    """Names a module offers: no leading underscore, no submodule, and
    defined in `package` (with `own`, in the module itself), or a value
    with no defining module (a constant)."""
    import types

    names = set()
    for name in dir(module):
        value = getattr(module, name)
        if name.startswith("_") or isinstance(value, types.ModuleType):
            continue
        origin = getattr(value, "__module__", None)
        if origin is None or (origin == module.__name__ if own
                              else origin.split(".")[0] == package):
            names.add(name)
    return names


def test_public_names_match_jax():
    """Every public name of each JAX module is in its port, or in
    NOT_PORTED with its reason; every NOT_PORTED entry is still missing."""
    import importlib

    missing = set()
    for sub in PAIRED_MODULES + RESEARCH_MODULES:
        own = sub in RESEARCH_MODULES
        suffix = "." + sub if sub else ""
        jax_mod = importlib.import_module("whisper_at_tpu" + suffix)
        port_mod = importlib.import_module("whisper_at_tpu_torch" + suffix)
        missing |= {(sub, n) for n in _public_names(jax_mod, "whisper_at_tpu", own)
                    - _public_names(port_mod, "whisper_at_tpu_torch", own)}
    assert missing == set(NOT_PORTED), (sorted(missing - set(NOT_PORTED)),
                                        sorted(set(NOT_PORTED) - missing))
    assert all(reason for reason in NOT_PORTED.values())


def test_repaired_names_work():
    """`utils` re-exports the writers, `checkpoint.rename_head_state_dict`
    and `audio.exact_div` are the JAX package's, `timing.dtw` finds its
    path, `ops.mel_filters` and `transcribe.cli` are there."""
    from whisper_at_tpu.checkpoint import rename_head_state_dict as jax_rename
    from whisper_at_tpu.ops.dtw import dtw as jax_dtw
    from whisper_at_tpu_torch import audio, checkpoint, ops, timing
    from whisper_at_tpu_torch.utils import get_writer, writers

    assert get_writer is writers.get_writer
    sd = {"module.mlp.w": 1, "at_model.x": 2, "other": 3}
    assert checkpoint.rename_head_state_dict(sd) == jax_rename(sd)
    assert audio.exact_div(3000, 1500) == 2
    x = np.random.default_rng(0).standard_normal((9, 31)).astype(np.float32)
    np.testing.assert_array_equal(timing.dtw(x), jax_dtw(x.astype(np.float64)))
    assert ops.mel_filters(80).shape == (80, 201)
    assert sys.modules["whisper_at_tpu_torch.transcribe"].cli is wat.cli.cli


def _loads_nothing_of(code: str, banned) -> None:
    full = (f"{code}; bad = [m for m in sys.modules if m.split('.')[0] in {tuple(banned)!r}]; "
            "print(bad); sys.exit(1 if bad else 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", full], capture_output=True, text=True,
                          timeout=120, cwd=root)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_research_loads_no_jax_sklearn_matplotlib_or_transformers():
    _loads_nothing_of(
        "import sys, whisper_at_tpu_torch.research, whisper_at_tpu_torch.research.wer, "
        "whisper_at_tpu_torch.research.noisy_speech, whisper_at_tpu_torch.research.as_eval, "
        "whisper_at_tpu_torch.research.layer_probe, whisper_at_tpu_torch.research.plots, "
        "whisper_at_tpu_torch.research.baselines",
        ("jax", "jaxlib", "whisper_at_tpu", "sklearn", "matplotlib", "transformers"))


_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_SCRIPTS = ["app_torch.py"] + sorted(
    os.path.join("examples", f) for f in os.listdir(os.path.join(_ROOT, "examples"))
    if f.endswith("_torch.py"))


@pytest.fixture(scope="module")
def script_imports():
    """{script: the banned modules that importing it loaded}, every port
    example and the app imported in turn in one fresh interpreter."""
    import json

    code = ("import importlib.util, json, sys\n"
            "banned = ('jax', 'jaxlib', 'whisper_at_tpu', 'gradio')\n"
            "out = {}\n"
            f"for path in {PORT_SCRIPTS!r}:\n"
            "    spec = importlib.util.spec_from_file_location('example', path)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "    out[path] = sorted(m for m in sys.modules if m.split('.')[0] in banned)\n"
            "print(json.dumps(out))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=_ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout.splitlines()[-1])


@pytest.mark.parametrize("path", PORT_SCRIPTS)
def test_examples_and_app_load_no_jax(script_imports, path):
    """Importing each port example (and the app) loads no JAX and nothing
    of the JAX package (gradio only in the app's main)."""
    assert script_imports[path] == []


def test_layer_wise_probe_defaults_to_the_card(monkeypatch):
    from whisper_at_tpu_torch.research import layer_probe

    feats = np.random.default_rng(0).standard_normal((10, 2, 4))
    labels = np.arange(10) % 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        layer_probe.layer_wise_probe(feats, labels)
    with pytest.raises(RuntimeError, match="CUDA"):
        layer_probe.fit_linear_probe(feats, labels)
    got = layer_probe.layer_wise_probe(feats, labels, max_iter=5, device="cpu")
    assert [r["layer"] for r in got] == [0, 1]
