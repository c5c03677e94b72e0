"""The port's feature extraction against the JAX package's on the same
weights: `encoder_apply_taps` in every tap mode at 10 s and 5 s of mel, and
`extract_features`, `extract_features_padded`, `extract_features_many` and
`extract_feature_set` (the files, and resume by skip).

A small JAX model (2 layers, width 128, 2 heads) is converted with
`convert.from_jax_params`; audio comes from numpy with a seed. fp32; the
port runs K1 and K2 through their plain versions here (CPU tensors), the
JAX package its einsum attention and XLA MLP. Tolerance: the taps' 2e-5.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_at_tpu.models.dims import ModelDimensions as JaxDims
from whisper_at_tpu.models.encoder import encoder_apply_taps as jax_taps
from whisper_at_tpu.models.whisper import Whisper as JaxWhisper
from whisper_at_tpu.research import feature_extract as jfx
from whisper_at_tpu_torch.convert import from_jax_params
from whisper_at_tpu_torch.models.dims import ModelDimensions
from whisper_at_tpu_torch.models.encoder import encoder_apply_taps
from whisper_at_tpu_torch.models.whisper import Whisper
from whisper_at_tpu_torch.research import feature_extract as fx

DIMS = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=128, n_audio_head=2,
            n_audio_layer=2, n_vocab=51865, n_text_ctx=448, n_text_head=2,
            n_text_state=128, n_text_layer=2)
TOL = 2e-5


@pytest.fixture(scope="module")
def pair():
    jm = JaxWhisper(JaxDims(**DIMS), seed=3)
    tm = Whisper(ModelDimensions(**DIMS))
    tm.load_state_dict(from_jax_params(jm.params))
    return jm, tm


def _clip(seconds: float, seed: int) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(int(16000 * seconds)) * 0.1
            ).astype(np.float32)


@pytest.mark.parametrize("n_frames", [1000, 500])
@pytest.mark.parametrize("tap_mode", ["last", "all_nopool", "all_pool"])
def test_encoder_apply_taps_matches_jax(pair, tap_mode, n_frames):
    jm, tm = pair
    mel = (np.random.default_rng(n_frames).standard_normal((2, 80, n_frames)) * 0.4
           ).astype(np.float32)
    ref = np.asarray(jax_taps(jm.params["encoder"], jnp.asarray(mel), 2, tap_mode,
                              jnp.float32, attn_impl="single"))
    with torch.no_grad():
        out = encoder_apply_taps(tm.encoder, torch.from_numpy(mel), 2, tap_mode,
                                 torch.float32).numpy()
    shapes = {"last": (2, n_frames // 2, 128), "all_nopool": (2, 3, n_frames // 2, 128),
              "all_pool": (2, 3, 128)}
    assert out.shape == ref.shape == shapes[tap_mode]
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)


def test_encoder_apply_taps_refuses_an_unknown_mode(pair):
    _, tm = pair
    with pytest.raises(ValueError, match="tap_mode"):
        encoder_apply_taps(tm.encoder, torch.zeros(1, 80, 100), 2, "every")


@pytest.mark.parametrize("seconds, n_frames", [(10, 1000), (5, 500), (3, 1000)])
def test_extract_features_matches_jax(pair, seconds, n_frames):
    """10 s at 1000 frames (AudioSet), 5 s at 500 (ESC-50: 250 positions,
    12 pooled frames, the last 10 positions dropped), and a 3 s clip whose
    mel is zero-padded to 1000 frames."""
    jm, tm = pair
    audio = _clip(seconds, seed=seconds)
    ref = jfx.extract_features(jm, audio, n_frames=n_frames, fp16=False)
    out = fx.extract_features(tm, audio, n_frames=n_frames, fp16=False)
    assert out.shape == ref.shape == (2, n_frames // 40, 128)
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)
    keep = fx.extract_features(tm, audio, n_frames=n_frames, fp16=False,
                               drop_embedding_layer=False)
    assert keep.shape[0] == 3
    np.testing.assert_array_equal(keep[1:], out)


def test_extract_features_padded_matches_jax(pair):
    jm, tm = pair
    audio = _clip(10, seed=1)
    ref = jfx.extract_features_padded(jm, audio, n_tokens=500, fp16=False)
    out = fx.extract_features_padded(tm, audio, n_tokens=500, fp16=False)
    assert out.shape == ref.shape == (2, 25, 128)
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("lengths, int16", [((10, 10, 10), False), ((10, 10), True),
                                            ((10, 6), False)])
def test_extract_features_many_matches_jax(pair, lengths, int16):
    """Equal-length clips (float and int16 PCM) through one batched mel,
    ragged clips one mel a clip; each row as the JAX package's batch and as
    the port's own one-clip path; fetch_dtype bf16 is the fp32 result
    rounded."""
    jm, tm = pair
    clips = [_clip(s, seed=10 + i) for i, s in enumerate(lengths)]
    if int16:
        clips = [(np.clip(c, -1, 1) * 32767).astype(np.int16) for c in clips]
    ref = np.asarray(jfx.extract_features_many(jm, clips, n_frames=1000, fp16=False))
    out = fx.extract_features_many(tm, clips, n_frames=1000, fp16=False)
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape == (
        len(clips), 2, 25, 128)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=0)
    for i, clip in enumerate(clips):
        solo = fx.extract_features(tm, clip, n_frames=1000, fp16=False)
        np.testing.assert_allclose(out[i].numpy(), solo, atol=1e-5, rtol=0)
    out16 = fx.extract_features_many(tm, clips, n_frames=1000, fp16=False,
                                     fetch_dtype=torch.bfloat16)
    assert out16.dtype == torch.bfloat16
    np.testing.assert_array_equal(out16.float().numpy(),
                                  out.to(torch.bfloat16).float().numpy())


def _write_wav(path, x: np.ndarray) -> None:
    import wave

    with wave.open(str(path), "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(16000)
        wf.writeframes((np.clip(x, -1, 1) * 32767).astype(np.int16).tobytes())


def test_extract_feature_set_matches_jax(pair, tmp_path):
    """Five clips (one ragged) in chunks of 2: the files hold the JAX
    package's features to 2e-5; a second call writes nothing; a deleted
    file is the only one written again."""
    jm, tm = pair
    wavs = []
    for i, seconds in enumerate((10, 10, 10, 7, 10)):
        path = tmp_path / f"clip{i}.wav"
        _write_wav(path, _clip(seconds, seed=20 + i))
        wavs.append({"wav": str(path), "labels": "/m/0"})
    data_json = tmp_path / "data.json"
    data_json.write_text(json.dumps({"data": wavs}))
    ref_dir, out_dir = tmp_path / "feat_jax", tmp_path / "feat_as_port"
    ref = jfx.extract_feature_set(jm, str(data_json), str(ref_dir), n_frames=1000,
                                  batch_size=2, fp16=False)
    out = fx.extract_feature_set(tm, str(data_json), str(out_dir), n_frames=1000,
                                 batch_size=2, fp16=False)
    assert [os.path.basename(p) for p in out] == [os.path.basename(p) for p in ref] == [
        f"clip{i}.npz" for i in range(5)]
    for a, b in zip(out, ref):
        with np.load(a) as fa, np.load(b) as fb:
            assert fa.files == fb.files == ["arr_0"]
            assert fa["arr_0"].dtype == fb["arr_0"].dtype == np.float32
            np.testing.assert_allclose(fa["arr_0"], fb["arr_0"], atol=TOL, rtol=0)
    assert fx.extract_feature_set(tm, str(data_json), str(out_dir), batch_size=2,
                                  fp16=False) == []
    os.remove(out[3])
    again = fx.extract_feature_set(tm, str(data_json), str(out_dir), batch_size=2, fp16=False)
    assert again == [out[3]]
    limited = fx.extract_feature_set(tm, str(data_json), str(tmp_path / "lim"), batch_size=4,
                                     fp16=True, limit=3)
    assert len(limited) == 3
    with np.load(limited[0]) as f:  # bf16 fetch, fp32 file
        assert f["arr_0"].dtype == np.float32 and f["arr_0"].shape == (2, 25, 128)
