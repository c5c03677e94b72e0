"""The port's real-checkpoint validation tool
(`tools/validate_real_checkpoint_torch.py`) against the JAX one
(`tools/validate_real_checkpoint.py`) on one synthetic checkpoint pair in the
released format (`test_real_checkpoint._write_official_pair`, tiny dims),
fp32: the same stages pass, the same goldens come out (text, language and
segments exact, tags within the JAX package's pinned TL-TR tolerance), a
wrong --expect fails with the same names; the port's state dict carried back
to the JAX tree is the tree bit for bit; the port's stage 5 gives the texts
of the JAX package's int8 and int4 calls on the same weights.

The pair's decoder is made confident (`confident_pair`'s edit at these
dims): the quality gates then keep every temperature-0 decode, so neither
package samples (the two draw from different generators)."""

import contextlib
import hashlib
import importlib.util
import io
import os
import re
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_real_checkpoint as trc
import whisper_at_tpu as jwat
import whisper_at_tpu_torch as wat
from whisper_at_tpu.models.dims import ModelDimensions as JaxDims
from whisper_at_tpu.models.whisper import Whisper as JaxWhisper
from whisper_at_tpu_torch.audio import load_audio
from whisper_at_tpu_torch.convert import from_jax_params
from whisper_at_tpu_torch.tokenizer import get_tokenizer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These models are tiny: the port's passes run on one thread, which
    keeps the file's time steady when other test processes share the
    cores (a thread pool per process oversubscribes them)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TAG_TOL = 1e-4  # the JAX package's pinned TL-TR tolerance
EXPECT = "greetings"  # what the confident decoder says


def _tool(name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tools", name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def confident_whisper(dims: JaxDims, seed: int) -> JaxWhisper:
    """A JAX Whisper of `dims` from `seed` whose decoder is sure of itself
    (confident_pair.confident_models' edit): the token embedding x20, the
    no-speech row along the SOT position's input."""
    jm = JaxWhisper(dims, seed=seed)
    tok = get_tokenizer(True)
    dec = dict(jm.params["decoder"])
    emb = np.asarray(dec["token_embedding"], np.float32)
    d = emb[tok.sot] + np.asarray(dec["positional_embedding"], np.float32)[0]
    emb = emb * 20.0
    emb[tok.no_speech] = 10.0 * d / np.linalg.norm(d)
    dec["token_embedding"] = emb
    return JaxWhisper(dims, params=dict(jm.params, decoder=dec))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(root, JAX model, .pt, .pth, .wav) of the synthetic official pair."""
    root = str(tmp_path_factory.mktemp("official"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trc, "Whisper", confident_whisper)
        jm, pt, pth = trc._write_official_pair(root, trc.TINY_DIMS, seed=7)
    wav = os.path.join(root, "clip.wav")
    trc._write_wav(wav)
    return root, jm, pt, pth, wav


@pytest.fixture(scope="module")
def tools():
    return {"jax": _tool("validate_real_checkpoint"),
            "port": _tool("validate_real_checkpoint_torch")}


def run_tool(tools, which: str, pair, *extra) -> tuple:
    """(return code, printed text) of one tool's main on the pair."""
    _, _, pt, pth, wav = pair
    argv = ["--checkpoint", pt, "--at-checkpoint", pth, "--audio", wav, "--language", "en",
            "--fp32", "--skip-quant", *extra]
    if which == "port":
        argv += ["--device", "cpu"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tools[which].main(argv)
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def runs(pair, tools):
    """{tool: (rc, output, goldens)}: each tool once over the pair."""
    root = pair[0]
    out = {}
    for which in ("jax", "port"):
        goldens = os.path.join(root, f"goldens_{which}.npz")
        rc, text = run_tool(tools, which, pair, "--expect", EXPECT, "--out", goldens)
        out[which] = (rc, text, dict(np.load(goldens, allow_pickle=True)))
    return out


def test_goldens_agree(runs):
    jax_g, port_g = runs["jax"][2], runs["port"][2]
    assert sorted(port_g) == sorted(jax_g)
    for key in jax_g:
        assert port_g[key].dtype == jax_g[key].dtype, key
    for key in ("model", "text", "language"):
        assert str(port_g[key]) == str(jax_g[key]), key
    assert EXPECT in str(port_g["text"])
    np.testing.assert_array_equal(port_g["segment_starts"], jax_g["segment_starts"])
    assert list(port_g["segment_texts"]) == list(jax_g["segment_texts"])
    assert port_g["audio_tag"].shape == jax_g["audio_tag"].shape
    np.testing.assert_allclose(port_g["audio_tag"], jax_g["audio_tag"], rtol=0, atol=TAG_TOL)


@pytest.mark.parametrize("which", ["jax", "port"])
def test_every_stage_passes(runs, which):
    rc, text, _ = runs[which]
    assert rc == 0, text
    assert "FAIL" not in text
    blocks = re.split(r"\n=== stage: (.+?) ===\n", text)[1:]
    stages = dict(zip(blocks[::2], blocks[1::2]))
    assert [s.split(" (")[0] for s in stages] == [
        "load", "activations", "sequential transcribe", "batched transcribe",
        "record goldens"]
    for name, body in stages.items():
        if name != "record goldens":
            assert "PASS" in body, name
    assert text.rstrip().endswith("ALL STAGES PASSED")


def test_wrong_expect_fails_with_the_same_names(pair, tools):
    got = {}
    for which in ("jax", "port"):
        rc, text = run_tool(tools, which, pair, "--expect", "not said", "--skip-activations")
        assert rc == 1, text
        got[which] = text.rstrip().splitlines()[-1]
    assert "transcribe:expect" in got["port"]
    assert got["port"] == got["jax"] == "FAILURES: ['transcribe:expect', 'batched:expect']"


def test_official_name_is_read_from_the_download_root(pair, tools, monkeypatch):
    """`--model tiny --download-root DIR` loads the released file names from
    DIR (the registry's address carrying this file's digest) and fetches
    nothing."""
    root, _, pt, pth, _ = pair
    with open(pt, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    monkeypatch.setitem(wat._MODELS, "tiny", f"https://example.invalid/{digest}/tiny.pt")

    def no_fetch(*args, **kwargs):
        raise AssertionError("the tool fetched over the network")
    monkeypatch.setattr(urllib.request, "urlopen", no_fetch)
    with contextlib.redirect_stdout(io.StringIO()):
        failures, (model, name) = tools["port"].load_stage("tiny", None, None, root, True, "cpu")
    assert failures == [] and name == "tiny"
    local = wat.load_model(pt, device="cpu", at_checkpoint=pth, dtype=torch.float32)
    got, want = model.state_dict(), local.state_dict()
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    with pytest.raises(FileNotFoundError):
        tools["port"].load_stage("tiny", None, None, os.path.join(root, "nowhere"), True, "cpu")


def test_state_dict_to_jax_tree_round_trips(pair, tools):
    jm = pair[1]
    tree = tools["port"].to_jax_params(from_jax_params(jm.params))

    def leaves(t, prefix=""):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from leaves(v, prefix + k + ".")
            else:
                yield prefix + k, v
    want = dict(leaves(jm.params))
    got = dict(leaves(tree))
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        ref = np.asarray(value, np.float32)
        assert got[key].dtype == np.float32 and got[key].shape == ref.shape, key
        np.testing.assert_array_equal(got[key], ref, err_msg=key)


def test_quant_stage_texts_are_the_jax_calls(pair, tools):
    """Stage 5's int8 and int4 texts are the JAX package's
    transcribe_batched(kv_quant=True, weight_quant=True, kv_bits=8 / 4) on
    the same weights, fp32."""
    _, _, pt, pth, wav = pair
    model = wat.load_model(pt, device="cpu", at_checkpoint=pth, dtype=torch.float32)
    audio = load_audio(wav)
    with contextlib.redirect_stdout(io.StringIO()):
        _, info = tools["port"].quant_stage(model, audio, False, "en", "")
    jm = jwat.load_model(pt, at_checkpoint=pth, dtype=jnp.float32)
    for bits, key in ((8, "int8"), (4, "int4")):
        ref = jwat.transcribe_batched(jm, audio, fp16=False, language="en", kv_quant=True,
                                      weight_quant=True, kv_bits=bits)
        assert info[key] == ref["text"], key
    assert sorted(info["tokens"]) == ["int4", "int8"]  # on the CPU K3 is one path
