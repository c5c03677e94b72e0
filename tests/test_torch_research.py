"""The port's research paths against the JAX package's: word error rates,
noisy test sets and their transcription, the AudioSet evaluation, the
layer-wise probe (against scikit-learn's fit, which the JAX package runs),
the figures and the wav2vec2 / HuBERT baselines.

Models are small (2 layers, width 64, a 64-token text context;
`confident_pair.py`) and carried across with `convert.from_jax_params`;
audio and features come from numpy with a seed. Tolerances: the probe's float64 coefficients, intercepts and
epoch losses 1e-9 from scikit-learn's, the tag predictions 1e-4 and mAP
1e-6 from the JAX package's (fp32); everything else is compared exactly.
"""

import os
import sys
import warnings

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import whisper_at_tpu as jwat
import whisper_at_tpu_torch as wat
from whisper_at_tpu.research import as_eval as j_as_eval
from whisper_at_tpu.research import baselines as j_baselines
from whisper_at_tpu.research import layer_probe as j_probe
from whisper_at_tpu.research import noisy_speech as j_noisy
from whisper_at_tpu.research import plots as j_plots
from whisper_at_tpu.research import wer as j_wer
from whisper_at_tpu_torch.research import as_eval, baselines, layer_probe, noisy_speech, plots, wer

from confident_pair import confident_models
PROBE_TOL = 1e-9
TAG_TOL = 1e-4
MAP_TOL = 1e-6
WORDS = ["the", "cat", "sat", "on", "a", "mat", "dog", "ran"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The models and probes here are tiny: torch and numpy's BLAS run on
    one thread, which keeps the file's time steady when other test
    processes share the cores (a thread pool per process oversubscribes
    them)."""
    from threadpoolctl import threadpool_limits

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------------------- #
# word error rate
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("seed", range(6))
def test_wer_matches_jax_on_seeded_cases(seed):
    rng = np.random.default_rng(seed)
    hyps, refs = [], []
    for _ in range(5):
        hyps.append(" ".join(rng.choice(WORDS, int(rng.integers(0, 9)))))
        refs.append(" ".join(rng.choice(WORDS, int(rng.integers(1, 9)))))
    for h, r in zip(hyps, refs):
        assert wer.word_edit_distance(h.split(), r.split()) == \
            j_wer.word_edit_distance(h.split(), r.split())
    assert wer.calculate_wer(hyps, refs) == j_wer.calculate_wer(hyps, refs)


@pytest.mark.parametrize("hyp, ref", [
    ("", "a b c"), ("a b c", ""), ("", ""), ("Hello, World!", "hello world"),
    ("it's... OK; (fine)", "ITS OK FINE"), ("MiXeD CaSe", "mixed case"),
    ("  spaced   out  ", "spaced out"), ("naïve café", "NAÏVE CAFÉ")])
def test_wer_edge_cases_match_jax(hyp, ref):
    """Empty hypothesis or reference, punctuation and case; an empty
    reference corpus divides by zero in both."""
    assert wer.preprocess_text(hyp) == j_wer.preprocess_text(hyp)
    assert wer.remove_punctuation(hyp) == j_wer.remove_punctuation(hyp)
    h, r = wer.preprocess_text(hyp), wer.preprocess_text(ref)
    assert wer.word_edit_distance(h.split(), r.split()) == \
        j_wer.word_edit_distance(h.split(), r.split())
    if r.split():
        assert wer.calculate_wer([h], [r]) == j_wer.calculate_wer([h], [r])
    else:
        for fn in (wer.calculate_wer, j_wer.calculate_wer):
            with pytest.raises(ZeroDivisionError):
                fn([h], [r])


@settings(max_examples=150, deadline=None)
@given(st.lists(st.sampled_from(WORDS), max_size=12),
       st.lists(st.sampled_from(WORDS), max_size=12))
def test_word_edit_distance_fuzz_matches_jax(hyp, ref):
    assert wer.word_edit_distance(hyp, ref) == j_wer.word_edit_distance(hyp, ref)


def _transcript_tree(root):
    """Transcripts '<db>_<class>_<utt>_mix_<noise>.txt' at three SNRs, three
    classes and three utterances, with their truths."""
    rng = np.random.default_rng(5)
    trans, truth = root / "trans", root / "truth"
    os.makedirs(trans / "sub")
    os.makedirs(truth)
    for utt in range(3):
        (truth / f"utt{utt}.txt").write_text(" ".join(rng.choice(WORDS, 6)).title() + ".")
    for db in (-10, 0, 10):
        for cla in range(3):
            for utt in range(3):
                where = trans / "sub" if utt == 2 else trans
                text = " ".join(rng.choice(WORDS, int(rng.integers(0, 8))))
                (where / f"{db}_{cla}_utt{utt}_mix_n{cla}_{utt}.txt").write_text(text + "!")
    return str(trans), str(truth)


def test_noise_wer_scorers_match_jax(tmp_path):
    trans, truth = _transcript_tree(tmp_path)
    snrs = (-10, 0, 10)
    out, ref = str(tmp_path / "wer.csv"), str(tmp_path / "wer_jax.csv")
    assert wer.eval_noise_wer(trans, truth, out, snrs) == \
        j_wer.eval_noise_wer(trans, truth, ref, snrs)
    assert open(out, "rb").read() == open(ref, "rb").read()
    out, ref = str(tmp_path / "cla.csv"), str(tmp_path / "cla_jax.csv")
    got = wer.eval_noise_wer_classwise(trans, truth, out, n_classes=5, snr_levels=snrs)
    want = j_wer.eval_noise_wer_classwise(trans, truth, ref, n_classes=5, snr_levels=snrs)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (3, 5) and np.isnan(got[:, 3:]).all() and np.isfinite(got[:, :3]).all()
    assert open(out, "rb").read() == open(ref, "rb").read()


# --------------------------------------------------------------------------- #
# noisy speech
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("n_speech, n_noise", [(16000, 8000), (16000, 16000),
                                               (8000, 20000), (12345, 1000)])
@pytest.mark.parametrize("db", [-20, 0, 7.5])
def test_add_noise_bitwise(n_speech, n_noise, db):
    """Looped (shorter noise), equal and truncated (longer noise)."""
    rng = np.random.default_rng(n_speech + n_noise)
    speech = rng.standard_normal(n_speech).astype(np.float32) * 0.3
    noise = rng.standard_normal(n_noise).astype(np.float32) * 0.1
    got, want = noisy_speech.add_noise(speech, noise, db), j_noisy.add_noise(speech, noise, db)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_write_wav_bytes(tmp_path):
    x = np.random.default_rng(0).standard_normal(4000).astype(np.float32) * 0.7  # clips
    noisy_speech.write_wav(str(tmp_path / "a.wav"), x)
    j_noisy.write_wav(str(tmp_path / "b.wav"), x)
    assert (tmp_path / "a.wav").read_bytes() == (tmp_path / "b.wav").read_bytes()


def _corpus(root, n_utts=2, n_classes=2, seconds=1.5):
    """Tone-burst utterances with truths and noise clips a class."""
    rng = np.random.default_rng(0)
    for d in ("speech", "noise", "truth"):
        os.makedirs(root / d, exist_ok=True)
    speech = []
    for i in range(n_utts):
        t = np.arange(int(16000 * seconds)) / 16000.0
        x = 0.4 * np.sin(2 * np.pi * (300 + 50 * i) * t) * (np.sin(2 * np.pi * 2.0 * t) > 0)
        path = str(root / "speech" / f"utt{i}.wav")
        j_noisy.write_wav(path, x.astype(np.float32))
        speech.append(path)
        (root / "truth" / f"utt{i}.txt").write_text(f"synthetic utterance {i}")
    noise = {}
    for cla in range(n_classes):
        noise[cla] = []
        for j in range(n_utts):
            path = str(root / "noise" / f"n{cla}_{j}.wav")
            j_noisy.write_wav(path, (0.5 * rng.standard_normal(8000 + 3000 * j)).astype(
                np.float32))
            noise[cla].append(path)
    return speech, noise, str(root / "truth")


def test_generate_noisy_set_names_and_bytes(tmp_path):
    speech, noise, _ = _corpus(tmp_path, n_utts=3, n_classes=2)
    snrs = (-10, 0, 10)
    got = noisy_speech.generate_noisy_set(speech, noise, str(tmp_path / "a"), snrs, 2)
    want = j_noisy.generate_noisy_set(speech, noise, str(tmp_path / "b"), snrs, 2)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert len(got) == 3 * 2 * 2 and os.path.basename(got[0]) == "-10_0_utt0_mix_n0_0.wav"
    for a, b in zip(got, want):
        assert open(a, "rb").read() == open(b, "rb").read()


@pytest.fixture(scope="module")
def confident_pair():
    """`confident_pair.confident_models`: the gate keeps every temperature-0
    decode in both packages."""
    return confident_models()


@pytest.fixture()
def fp32_transcribe(confident_pair):
    """Both models' `transcribe` methods in fp32, each recording, a call,
    the file and the highest temperature any of its decodes ran at
    (`hottest[package]`)."""
    jm, tm = confident_pair
    temps, hottest = {"jax": [], "torch": []}, {"jax": {}, "torch": {}}
    port_transcribe = sys.modules["whisper_at_tpu_torch.transcribe"]
    port_decode = port_transcribe.decode

    def jax_decode(mel, opts):
        temps["jax"].append(opts.temperature)
        return jwat.decode(jm, mel, opts)

    def torch_decode(model, mel, opts):
        temps["torch"].append(opts.temperature)
        return port_decode(model, mel, opts)

    def recording(name, transcribe, model):
        def run(audio, **kwargs):
            temps[name].clear()
            result = transcribe(model, audio, fp16=False, **kwargs)
            hottest[name][os.path.basename(str(audio))] = max(temps[name])
            return result
        return run

    jm.decode = jax_decode
    jm.transcribe = recording("jax", jwat.transcribe, jm)
    tm.transcribe = recording("torch", wat.transcribe, tm)
    port_transcribe.decode = torch_decode
    try:
        yield jm, tm, hottest
    finally:
        port_transcribe.decode = port_decode
        for attr in ("decode", "transcribe"):
            delattr(jm, attr)
        del tm.transcribe


def test_transcribe_noisy_set_matches_jax(tmp_path, fp32_transcribe):
    """Each mixture through each package's sequential transcribe (fp32, the
    gates at their defaults): a file whose decodes all ran at temperature 0
    in both has the JAX package's text byte for byte; where either sampled
    (the packages draw from different generators) only the file's presence
    is compared. At least half the files must be of the first kind. A
    second call writes nothing."""
    jm, tm, hottest = fp32_transcribe
    speech, noise, _ = _corpus(tmp_path, n_classes=1)
    mix = str(tmp_path / "mix")
    mixed = noisy_speech.generate_noisy_set(speech, noise, mix, (-5, 5), 2)
    names = sorted(os.path.splitext(os.path.basename(p))[0] for p in mixed)
    texts = {}
    for name, model, mod in (("jax", jm, j_noisy), ("torch", tm, noisy_speech)):
        out_dir = str(tmp_path / f"hyp_{name}")
        written = mod.transcribe_noisy_set(model, mix, out_dir)
        assert sorted(os.path.basename(p) for p in written) == [n + ".txt" for n in names]
        texts[name] = {os.path.basename(p): open(p, "rb").read() for p in written}
        assert mod.transcribe_noisy_set(model, mix, out_dir) == []
    greedy = [n for n in names
              if hottest["jax"][n + ".wav"] == 0.0 and hottest["torch"][n + ".wav"] == 0.0]
    for n in greedy:
        assert texts["torch"][n + ".txt"] == texts["jax"][n + ".txt"], n
    assert texts["jax"].keys() == texts["torch"].keys()
    assert 2 * len(greedy) >= len(names), (greedy, hottest)
    assert any(texts["jax"][n + ".txt"] for n in greedy)  # text, not only silence


# --------------------------------------------------------------------------- #
# the AudioSet evaluation
# --------------------------------------------------------------------------- #


def test_evaluate_audioset_matches_jax(tmp_path, fp32_transcribe):
    """`test_research.py::test_as_eval_end_to_end`'s clips and labels."""
    import json

    jm, tm, _ = fp32_transcribe
    rng = np.random.default_rng(0)
    label_csv = tmp_path / "labels.csv"
    with open(label_csv, "w") as f:
        f.write("index,mid,display_name\n")
        for i in range(4):
            f.write(f'{i},/m/{i:03d},"c{i}"\n')
    entries = []
    for i in range(3):
        path = str(tmp_path / f"c{i}.wav")
        j_noisy.write_wav(path, (0.2 * rng.standard_normal(16000 * 2)).astype(np.float32))
        entries.append({"wav": path, "labels": f"/m/{i % 4:03d}"})
    eval_json = tmp_path / "eval.json"
    with open(eval_json, "w") as f:
        json.dump({"data": entries}, f)

    out_j, out_t = str(tmp_path / "out_jax"), str(tmp_path / "out")
    want = j_as_eval.evaluate_audioset(jm, str(eval_json), str(label_csv), out_j, tag="t")
    got = as_eval.evaluate_audioset(tm, str(eval_json), str(label_csv), out_t, tag="t")
    preds, ref = np.load(os.path.join(out_t, "t_pred.npy")), np.load(
        os.path.join(out_j, "t_pred.npy"))
    assert preds.shape == ref.shape == (3, 527)
    np.testing.assert_allclose(preds, ref, atol=TAG_TOL, rtol=0)
    np.testing.assert_array_equal(np.load(os.path.join(out_t, "t_truth.npy")),
                                  np.load(os.path.join(out_j, "t_truth.npy")))
    assert abs(got["mAP"] - want["mAP"]) <= MAP_TOL
    assert as_eval.compute_map_from_saved(out_t, ["t"]) == {"t": got["mAP"]}


# --------------------------------------------------------------------------- #
# the layer-wise probe
# --------------------------------------------------------------------------- #


def _probe_data(case: str, dtype=np.float64):
    """(features [n, L, D], labels, folds, max_iter) of a probe case; layer 1
    carries the labels, the others are noise. "plateau" runs until the
    tolerance stops every layer, over two mini-batches an epoch (320
    training rows: 200 and 120); "capped" is cut by max_iter."""
    rng = np.random.default_rng({"four": 0, "two": 1, "absent": 2, "nofolds": 3,
                                 "capped": 4, "plateau": 5}[case])
    n, n_layer, dim = (400, 3, 3) if case == "plateau" else (48, 3, 12)
    n_class = 2 if case == "two" else 4
    labels = rng.integers(0, n_class, n)
    folds = np.repeat(np.arange(3), n // 3)
    if case == "absent":  # class 3 only in fold 0: fold 0 trains without it
        labels[folds == 0] = np.where(labels[folds == 0] == 0, 3, labels[folds == 0])
        labels[folds != 0] = np.minimum(labels[folds != 0], 2)
    feats = rng.standard_normal((n, n_layer, dim))
    feats[np.arange(n), 1, labels % dim] += 2.0
    feats[:, 2, dim - 1] = 1.5  # a constant feature: scaled by 1
    max_iter = {"capped": 25, "plateau": 2000}.get(case, 150)
    return (feats.astype(dtype), labels,
            None if case in ("nofolds", "plateau") else folds, max_iter)


def _folds(n, folds):
    if folds is None:
        split = int(0.8 * n)
        return [(np.arange(split), np.arange(split, n))]
    return [(np.where(folds != f)[0], np.where(folds == f)[0]) for f in np.unique(folds)]


def _sklearn_fit(x, y, max_iter):
    """The JAX package's classifier a layer and fold, fitted directly."""
    from sklearn.neural_network import MLPClassifier
    from sklearn.pipeline import Pipeline
    from sklearn.preprocessing import StandardScaler

    clf = Pipeline([("scaler", StandardScaler()),
                    ("clf", MLPClassifier(hidden_layer_sizes=(), max_iter=max_iter,
                                          random_state=0))])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return clf.fit(x, y)


@pytest.mark.parametrize("case", ["four", "two", "absent", "nofolds", "capped", "plateau"])
def test_fit_linear_probe_matches_sklearn_float64(case):
    """Each layer and fold: the scaler, coefficients, intercepts and epoch
    losses within 1e-9 of scikit-learn's fit, the same epoch count and the
    same test predictions; `layer_wise_probe`'s fold accuracies are those
    fits' scores (what the JAX package's function returns)."""
    feats, labels, folds, max_iter = _probe_data(case)
    stopped_early = False
    scores = [[] for _ in range(feats.shape[1])]
    for train, test in _folds(len(labels), folds):
        fit = layer_probe.fit_linear_probe(feats[train], labels[train], max_iter, "cpu")
        preds = fit.predict(feats[test])
        for layer in range(feats.shape[1]):
            ref = _sklearn_fit(feats[train, layer], labels[train], max_iter)
            scaler, clf = ref[0], ref[-1]
            np.testing.assert_allclose(fit.mean[layer].numpy(), scaler.mean_, rtol=0,
                                       atol=PROBE_TOL)
            np.testing.assert_allclose(fit.scale[layer].numpy(), scaler.scale_, rtol=0,
                                       atol=PROBE_TOL)
            np.testing.assert_array_equal(fit.classes, clf.classes_)
            assert fit.n_iter[layer] == clf.n_iter_
            np.testing.assert_allclose(fit.coefs[layer].numpy(), clf.coefs_[0], rtol=0,
                                       atol=PROBE_TOL)
            np.testing.assert_allclose(fit.intercepts[layer].numpy(), clf.intercepts_[0],
                                       rtol=0, atol=PROBE_TOL)
            np.testing.assert_allclose(fit.loss_curves[layer], clf.loss_curve_, rtol=0,
                                       atol=PROBE_TOL)
            np.testing.assert_array_equal(preds[layer], ref.predict(feats[test, layer]))
            scores[layer].append(float(ref.score(feats[test, layer], labels[test])))
            stopped_early |= clf.n_iter_ < max_iter
    if case in ("capped", "plateau"):
        assert stopped_early == (case == "plateau")
    got = layer_probe.layer_wise_probe(feats, labels, folds, max_iter, device="cpu")
    assert [r["fold_accuracies"] for r in got] == scores
    assert [r["accuracy"] for r in got] == [float(np.mean(s)) for s in scores]


@pytest.mark.parametrize("case", ["four", "two", "absent"])
def test_layer_wise_probe_float32_accuracies(case):
    feats, labels, folds, max_iter = _probe_data(case, np.float32)
    got = layer_probe.layer_wise_probe(feats, labels, folds, max_iter, device="cpu")
    assert got == j_probe.layer_wise_probe(feats, labels, folds, max_iter)


def test_layer_wise_probe_on_the_jax_tests_data():
    """`test_research.py::test_layer_probe`'s features, folds and max_iter."""
    rng = np.random.default_rng(0)
    n, n_layers, dim = 80, 3, 16
    labels = rng.integers(0, 4, n)
    feats = rng.standard_normal((n, n_layers, dim)).astype(np.float32)
    feats[np.arange(n), 1, labels] += 10.0
    folds = np.repeat(np.arange(4), n // 4)
    got = layer_probe.layer_wise_probe(feats, labels, folds, max_iter=1500, device="cpu")
    want = j_probe.layer_wise_probe(feats, labels, folds, max_iter=1500)
    assert got == want
    assert got[1]["accuracy"] > max(got[0]["accuracy"], got[2]["accuracy"])


# --------------------------------------------------------------------------- #
# figures
# --------------------------------------------------------------------------- #


def _figure_calls(tmp_path, prefix):
    wer_by = {"whisper": [0.9, 0.7, 0.5, 0.3, 0.2, 0.15, 0.1, 0.08, 0.05]}
    return [
        ("plot_wer_vs_snr", (wer_by, str(tmp_path / f"{prefix}1.png")), {}),
        ("plot_layerwise_accuracy", ({"m": [0.2, 0.5, 0.4]}, str(tmp_path / f"{prefix}2.png")),
         {}),
        ("plot_classwise_noise", (np.array([0.1, 0.9, 0.5, 0.9]), list("abcd"),
                                  str(tmp_path / f"{prefix}3.png")), {"top_k": 3}),
        ("plot_best_layer_histogram", ([0, 1, 1, 2], 4, str(tmp_path / f"{prefix}4.png")), {}),
    ]


def _same(a, b):
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


def test_plots_match_jax_and_write_files(tmp_path):
    assert plots.HAVE_MPL and j_plots.HAVE_MPL
    for (name, args, kw), (_, jargs, _) in zip(_figure_calls(tmp_path, "t"),
                                               _figure_calls(tmp_path, "j")):
        assert _same(getattr(plots, name)(*args, **kw), getattr(j_plots, name)(*jargs, **kw))
        assert os.path.getsize(args[-1]) > 0


def test_plots_without_matplotlib_return_the_data(tmp_path, monkeypatch):
    """With matplotlib absent the functions return the JAX module's values
    and never try to import it."""
    def refuse():
        raise AssertionError("matplotlib was imported")

    monkeypatch.setattr(plots, "HAVE_MPL", False)
    monkeypatch.setattr(plots, "_pyplot", refuse)
    monkeypatch.setattr(j_plots, "HAVE_MPL", False)
    for name, args, kw in _figure_calls(tmp_path, "n"):
        assert _same(getattr(plots, name)(*args, **kw), getattr(j_plots, name)(*args, **kw))
        assert not os.path.exists(args[-1])


# --------------------------------------------------------------------------- #
# baselines
# --------------------------------------------------------------------------- #


@pytest.fixture()
def torch_only_transformers(monkeypatch):
    """`transformers` imported without its TensorFlow and Flax back ends
    (both installed here; the baselines use neither, and TensorFlow's
    import alone takes seconds). No effect once it is imported."""
    monkeypatch.setenv("USE_TF", "0")
    monkeypatch.setenv("USE_FLAX", "0")


@pytest.mark.parametrize("build", ["build_local_ctc", "build_local_ssl"])
def test_local_baselines_are_the_jax_modules(build, torch_only_transformers):
    _, model = getattr(baselines, build)(seed=3)
    _, ref = getattr(j_baselines, build)(seed=3)
    assert type(model) is type(ref)
    sd, ref_sd = model.state_dict(), ref.state_dict()
    assert sd.keys() == ref_sd.keys()
    for key in sd:
        assert torch.equal(sd[key], ref_sd[key]), key


def test_baseline_runners_match_jax(tmp_path, torch_only_transformers):
    rng = np.random.default_rng(0)
    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f"u{i}.wav"))
        j_noisy.write_wav(paths[-1], (rng.standard_normal(8000) * 0.1).astype(np.float32))
    got = baselines.transcribe_ctc("wav2vec2-base", paths, str(tmp_path / "t"),
                                   processor_model=baselines.build_local_ctc(), device="cpu")
    want = j_baselines.transcribe_ctc("wav2vec2-base", paths, str(tmp_path / "j"),
                                      processor_model=j_baselines.build_local_ctc())
    assert [open(p).read() for p in got] == [open(p).read() for p in want]
    assert baselines.transcribe_ctc("wav2vec2-base", paths, str(tmp_path / "t"),
                                    processor_model=baselines.build_local_ctc(),
                                    device="cpu") == []
    audio = (rng.standard_normal(16000) * 0.1).astype(np.float32)
    for pool in (None, 4):
        np.testing.assert_array_equal(
            baselines.extract_ssl_features("x", audio, pool, baselines.build_local_ssl(),
                                           device="cpu"),
            j_baselines.extract_ssl_features("x", audio, pool, j_baselines.build_local_ssl()))


def test_baselines_read_released_weights_only_locally(monkeypatch, torch_only_transformers):
    """`from_pretrained` is never reached without local_files_only=True."""
    import transformers

    calls = []

    class Refused(Exception):
        pass

    def fake(*args, **kwargs):
        calls.append(kwargs)
        raise Refused

    for cls in ("AutoProcessor", "AutoModelForCTC", "AutoModel"):
        monkeypatch.setattr(getattr(transformers, cls), "from_pretrained", fake)
    with pytest.raises(Refused):
        baselines._load_ctc("wav2vec2-base")
    with pytest.raises(Refused):
        baselines.extract_ssl_features("hubert-large", np.zeros(16000, np.float32),
                                       device="cpu")
    with pytest.raises(Refused):
        baselines.transcribe_ctc("wav2vec2-robust", ["x.wav"], "unused", device="cpu")
    assert len(calls) == 3 and all(c.get("local_files_only") is True for c in calls)
