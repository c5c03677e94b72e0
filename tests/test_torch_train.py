"""The port's training stack against the JAX package's, on the CPU at a small
size: the TL-TR head in all nine modes, the losses, the optimizer step, the
metrics, the feature loader, the checkpoint files, `train()` with weight
averaging and resume across packages, the CLI and the operation counts.

Weights are drawn by the JAX package and carried over with
`convert.tltr_from_jax_params`; inputs come from numpy with a seed. fp32
throughout; tolerances as stated per test.
"""

import json
import os
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn import metrics

from whisper_at_tpu import checkpoint as jax_ckpt
from whisper_at_tpu import train as jt
from whisper_at_tpu.models.dims import dims_for as jax_dims_for
from whisper_at_tpu.ops import flops as jax_flops
from whisper_at_tpu.train import run as jax_run
from whisper_at_tpu.train import stats as jax_stats
from whisper_at_tpu.train.loop import latest_resumable_epoch as jax_latest
from whisper_at_tpu_torch import checkpoint as ckpt
from whisper_at_tpu_torch import train as pt
from whisper_at_tpu_torch.convert import tltr_from_jax_params, tltr_to_jax_params
from whisper_at_tpu_torch.models.dims import dims_for
from whisper_at_tpu_torch.ops import flops
from whisper_at_tpu_torch.train import run as port_run
from whisper_at_tpu_torch.train.loop import latest_resumable_epoch, load_tltr
from whisper_at_tpu_torch.train.tltr import TLTR

ALL_MODES = [
    "mean_mlp", "last_mlp", "wa_mlp", "mean_tr_4", "last_tr_4", "wa_tr_4",
    "wa_down_tr_32_4", "lw_tr_1_4", "lw_down_tr_32_1_4",
]
MODE = "lw_tr_1_4"
N, N_LAYER, REP_DIM, N_CLASS = 24, 3, 24, 8


def _port_head(params: dict, mode: str, label_dim: int, n_layer: int, rep_dim: int) -> TLTR:
    model = TLTR(label_dim, n_layer, rep_dim, mode)
    model.load_state_dict(tltr_from_jax_params(params, list(model.state_dict())))
    return model


def _leaves(tree: dict, prefix: str = ""):
    """(path, array) of a nested dict, sorted by path."""
    out = []
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(tree[k], dict):
            out += _leaves(tree[k], path)
        else:
            out.append((path, np.asarray(tree[k])))
    return out


# --------------------------------------------------------------------------- #
# head, losses, optimizer step
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("mode", ALL_MODES)
def test_tltr_apply_matches_jax(mode):
    params = jt.init_tltr(jax.random.PRNGKey(1), label_dim=11, n_layer=3, rep_dim=64, mode=mode)
    x = np.random.default_rng(0).standard_normal((2, 3, 25, 64)).astype(np.float32)
    ref = np.asarray(jt.tltr_apply(params, jnp.asarray(x), mode))
    model = _port_head(params, mode, 11, 3, 64)
    out = pt.tltr_apply(model, torch.from_numpy(x), mode).detach().numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)
    assert pt.count_parameters(model) == jt.count_parameters(params)


@pytest.mark.parametrize("mode", ["wa_mlp", "wa_tr_4"])
def test_layer_weight_modes_refuse_features_without_the_embedding_tap(mode):
    """`tltr_shape_for('whisper-large-v1')` gives 33 layers, the extraction
    writes 32 (the embedding tap is dropped): the layer-weighted modes fail
    on such features in the JAX package, and in the port alike."""
    n_layer, _ = pt.tltr_shape_for("whisper-large-v1")
    assert n_layer == jt.tltr_shape_for("whisper-large-v1")[0] == 33
    params = jt.init_tltr(jax.random.PRNGKey(0), label_dim=5, n_layer=n_layer, rep_dim=16,
                          mode=mode)
    x = np.zeros((1, n_layer - 1, 25, 16), np.float32)
    with pytest.raises(TypeError):
        jt.tltr_apply(params, jnp.asarray(x), mode)
    with pytest.raises(RuntimeError):
        _port_head(params, mode, 5, n_layer, 16)(torch.from_numpy(x))


@pytest.mark.parametrize("pos_weight", [None, 3.0])
def test_losses_match_jax(pos_weight):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((4, 10)).astype(np.float32) * 3
    targets = (rng.random((4, 10)) > 0.7).astype(np.float32)
    ref = float(jt.bce_with_logits_loss(jnp.asarray(logits), jnp.asarray(targets), pos_weight))
    out = float(pt.bce_with_logits_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                                        pos_weight))
    assert out == pytest.approx(ref, rel=1e-6)
    soft = rng.random((4, 10)).astype(np.float32)
    soft /= soft.sum(axis=1, keepdims=True)
    ref = float(jt.ce_loss(jnp.asarray(logits), jnp.asarray(soft)))
    out = float(pt.ce_loss(torch.from_numpy(logits), torch.from_numpy(soft)))
    assert out == pytest.approx(ref, rel=1e-6)


@pytest.mark.parametrize("loss_type, pos_weight", [("BCE", None), ("BCE", 3.0), ("CE", None)])
def test_five_train_steps_match_jax(loss_type, pos_weight):
    """The same batches through five fp32 steps of both packages, the lr
    scale changing between steps: each loss to 1e-5 relative, then every
    parameter and both Adam moments to 1e-4."""
    params = jt.init_tltr(jax.random.PRNGKey(2), label_dim=N_CLASS, n_layer=N_LAYER,
                          rep_dim=REP_DIM, mode=MODE)
    model = _port_head(params, MODE, N_CLASS, N_LAYER, REP_DIM)
    opt = jt.make_optimizer(5e-3)
    opt_state = opt.init(params)
    jstep = jt.make_train_step(MODE, opt, loss_type, pos_weight, compute_dtype=jnp.float32)
    torch_opt = pt.make_optimizer(model.parameters(), 5e-3)
    pstep = pt.make_train_step(MODE, torch_opt, loss_type, pos_weight,
                               compute_dtype=torch.float32)
    rng = np.random.default_rng(3)
    for i, scale in enumerate([1.0, 1.0, 0.5, 0.5, 0.25]):
        feats = rng.standard_normal((6, N_LAYER, 25, REP_DIM)).astype(np.float32)
        labels = (rng.random((6, N_CLASS)) > 0.6).astype(np.float32)
        if loss_type == "CE":
            labels = labels + 0.1
            labels /= labels.sum(axis=1, keepdims=True)
        params, opt_state, jloss = jstep(params, opt_state, jnp.asarray(feats),
                                         jnp.asarray(labels), jnp.float32(scale))
        ploss = pstep(model, torch.from_numpy(feats), torch.from_numpy(labels), scale)
        assert float(ploss) == pytest.approx(float(jloss), rel=1e-5), i
    for (path, ref), (_, out) in zip(_leaves(params),
                                     _leaves(tltr_to_jax_params(model.state_dict()))):
        np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0, err_msg=path)
    count, mu, nu = jax.tree.leaves(opt_state)[0], *opt_state[1][1:]
    names = list(dict(model.named_parameters()))
    for key, ref_tree in (("exp_avg", mu), ("exp_avg_sq", nu)):
        moments = {n: torch_opt.state[p][key] for n, p in model.named_parameters()}
        for (path, ref), (_, out) in zip(_leaves(jax.tree.map(np.asarray, ref_tree)),
                                         _leaves(tltr_to_jax_params(moments))):
            np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0, err_msg=path)
    assert int(count) == int(torch_opt.state[dict(model.named_parameters())[names[0]]]["step"])


def test_eval_step_matches_jax():
    params = jt.init_tltr(jax.random.PRNGKey(4), label_dim=N_CLASS, n_layer=N_LAYER,
                          rep_dim=REP_DIM, mode=MODE)
    model = _port_head(params, MODE, N_CLASS, N_LAYER, REP_DIM)
    x = np.random.default_rng(5).standard_normal((3, N_LAYER, 25, REP_DIM)).astype(np.float32)
    ref = np.asarray(jt.make_eval_step(MODE, jnp.float32)(params, jnp.asarray(x)))
    out = pt.make_eval_step(MODE, torch.float32)(model, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)
    # bf16 compute: both cast parameters and features, logits come back fp32
    ref16 = np.asarray(jt.make_eval_step(MODE)(params, jnp.asarray(x)))
    out16 = pt.make_eval_step(MODE)(model, torch.from_numpy(x))
    assert out16.dtype == torch.float32
    np.testing.assert_allclose(out16.numpy(), ref16, atol=0.1, rtol=0)


# --------------------------------------------------------------------------- #
# metrics
# --------------------------------------------------------------------------- #


def _scores_with_ties():
    rng = np.random.default_rng(6)
    target = (rng.random((3000, 5)) > 0.7).astype(np.float32)
    target[:, 3] = 0.0          # a class with no positive
    target[:, 4] = (rng.random(3000) > 0.99).astype(np.float32)
    output = np.round(target + rng.standard_normal((3000, 5)), 1).astype(np.float32)  # ties
    return output, target


def test_calculate_stats_matches_jax():
    """Every class with both values against the JAX package (scikit-learn
    underneath): AP and AUC to 1e-12, the subsampled curves elementwise."""
    output, target = _scores_with_ties()
    ref = jax_stats.calculate_stats(output, target)
    out = pt.calculate_stats(output, target)
    for k in (0, 1, 2, 4):
        for key in ("AP", "auc", "acc"):
            assert out[k][key] == pytest.approx(ref[k][key], abs=1e-12), (k, key)
        for key in ("precisions", "recalls", "fpr", "fnr"):
            np.testing.assert_array_equal(out[k][key], ref[k][key], err_msg=f"{k} {key}")
    assert out[3]["AP"] == pytest.approx(ref[3]["AP"], abs=1e-12)


def test_calculate_stats_class_without_positive(monkeypatch, capsys):
    """A class with one target value reports -1 curves and AUC and prints
    "class k no true sample", as the JAX package does with a scikit-learn
    whose roc_auc_score raises there (this one's returns NaN instead:
    `roc_auc_score` is wrapped to raise as older releases did)."""
    output, target = _scores_with_ties()
    roc_auc = metrics.roc_auc_score

    def raising(y_true, y_score, **kw):
        if np.unique(y_true).size != 2:
            raise ValueError("Only one class present in y_true.")
        return roc_auc(y_true, y_score, **kw)

    monkeypatch.setattr(jax_stats.metrics, "roc_auc_score", raising)
    ref = jax_stats.calculate_stats(output, target)
    ref_out = capsys.readouterr().out
    out = pt.calculate_stats(output, target)
    assert capsys.readouterr().out == ref_out == "class 3 no true sample\n"
    for k in range(5):
        for key in ("AP", "auc"):
            assert out[k][key] == pytest.approx(ref[k][key], abs=1e-12), (k, key)
        for key in ("precisions", "recalls", "fpr", "fnr"):
            np.testing.assert_array_equal(out[k][key], ref[k][key], err_msg=f"{k} {key}")
    assert out[3]["auc"] == out[3]["fpr"] == -1
    assert pt.mean_auc(out) == pytest.approx(jax_stats.mean_auc(ref), abs=1e-12)
    assert pt.mean_average_precision(out) == pytest.approx(
        jax_stats.mean_average_precision(ref), abs=1e-12)
    for auc in (0.5, 0.73, 0.999, pt.mean_auc(out)):
        assert pt.d_prime(auc) == pytest.approx(jax_stats.d_prime(auc), abs=1e-12)


@pytest.mark.parametrize("seed", range(4))
def test_metric_functions_match_sklearn(seed):
    """The port's curves, AP and AUC against scikit-learn on random binary
    targets with heavy ties: curves bitwise, AP and AUC to 1e-12."""
    from whisper_at_tpu_torch.train import stats

    rng = np.random.default_rng(seed)
    n = int(rng.integers(3, 4000))
    y = (rng.random(n) > rng.random()).astype(np.float32)
    y[:2] = [0, 1]
    s = np.round(rng.standard_normal(n), int(rng.integers(0, 3))).astype(np.float32)
    for name in ("precision_recall_curve", "roc_curve"):
        for a, b in zip(getattr(stats, name)(y, s), getattr(metrics, name)(y, s)):
            np.testing.assert_array_equal(a, b)
    assert stats.average_precision_score(y, s) == pytest.approx(
        metrics.average_precision_score(y, s), abs=1e-12)
    assert stats.roc_auc_score(y, s) == pytest.approx(metrics.roc_auc_score(y, s), abs=1e-12)
    labels = rng.integers(0, 5, n)
    pred = rng.integers(0, 5, n)
    assert stats.accuracy_score(labels, pred) == metrics.accuracy_score(labels, pred)


# --------------------------------------------------------------------------- #
# feature loader
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def tiny_dataset(tmp_path_factory):
    """The JAX training tests' recipe: 24 separable clips of [3, 25, 24]
    features, 8 classes, in a directory named `feat_as` (read as `.npz`)."""
    root = tmp_path_factory.mktemp("feat_as")
    feat_dir = root / "feat_as"
    feat_dir.mkdir()
    rng = np.random.default_rng(0)
    label_csv = root / "class_labels_indices.csv"
    with open(label_csv, "w") as f:
        f.write("index,mid,display_name\n")
        for i in range(N_CLASS):
            f.write(f'{i},/m/{i:03d},"class {i}"\n')
    data = []
    for i in range(N):
        cls = int(rng.integers(0, N_CLASS))
        feat = rng.standard_normal((N_LAYER, 25, REP_DIM)).astype(np.float32)
        feat[:, :, cls] += 4.0
        np.savez(feat_dir / f"clip{i}.npz", feat)
        labels = f"/m/{cls:03d}" if i % 3 else f"/m/{cls:03d},/m/{(cls + 1) % N_CLASS:03d}"
        data.append({"wav": f"/fake/clip{i}.wav", "labels": labels})
    train_json = root / "train.json"
    with open(train_json, "w") as f:
        json.dump({"data": data}, f)
    return {"root": root, "feat_dir": str(feat_dir), "label_csv": str(label_csv),
            "train_json": str(train_json)}


def _conf(ds, **kw):
    conf = {"freqm": 0, "timem": 0, "mixup": 0, "dataset": "tiny", "label_smooth": 0.0,
            "tar_path": ds["feat_dir"]}
    conf.update(kw)
    return conf


@pytest.mark.parametrize("balanced", [False, True])
def test_loader_batches_bitwise(tiny_dataset, balanced):
    """Shuffled or balanced sampling with mixup, SpecAug masks and label
    smoothing: two epochs of batches bitwise equal to the JAX package's."""
    conf = _conf(tiny_dataset, freqm=6, timem=5, mixup=0.5, label_smooth=0.1)
    weights = (pt.balanced_sample_weights(tiny_dataset["train_json"], tiny_dataset["label_csv"])
               if balanced else None)
    if balanced:
        np.testing.assert_array_equal(weights, jt.balanced_sample_weights(
            tiny_dataset["train_json"], tiny_dataset["label_csv"]))

    def loader(pkg):
        ds = pkg.FeatureDataset(tiny_dataset["train_json"], conf, tiny_dataset["label_csv"])
        return pkg.DataLoader(ds, batch_size=5, shuffle=not balanced, sampler_weights=weights,
                              num_workers=3, seed=7)

    ours, ref = loader(pt), loader(jt)
    for _ in range(2):
        a, b = list(ours), list(ref)
        assert len(a) == len(b) == N // 5
        for (fa, ta), (fb, tb) in zip(a, b):
            np.testing.assert_array_equal(fa, fb)
            np.testing.assert_array_equal(ta, tb)
    assert ours.dataset.missing == 0


def test_loader_counts_the_zero_fallback(tiny_dataset, tmp_path, capsys):
    """A feature directory whose name does not say `.npz` is read as `.npy`:
    every item falls back to zeros, as in the JAX package, and is counted."""
    other = tmp_path / "features"
    shutil.copytree(tiny_dataset["feat_dir"], other)
    conf = _conf(tiny_dataset, tar_path=str(other))
    ds = pt.FeatureDataset(tiny_dataset["train_json"], conf, tiny_dataset["label_csv"])
    ref = jt.FeatureDataset(tiny_dataset["train_json"], conf, tiny_dataset["label_csv"])
    feat, _ = ds.__getitem__(0, rng=np.random.default_rng(0))
    ref_feat, _ = ref.__getitem__(0, rng=np.random.default_rng(0))
    np.testing.assert_array_equal(feat, ref_feat)
    assert not feat.any() and ds.missing == 1
    assert "a missing file" in capsys.readouterr().out


# --------------------------------------------------------------------------- #
# checkpoint files
# --------------------------------------------------------------------------- #


def test_checkpoint_files_cross_packages(tmp_path):
    """A file written by either package loads bitwise in the other, dims
    included."""
    params = jt.init_tltr(jax.random.PRNGKey(8), label_dim=N_CLASS, n_layer=N_LAYER,
                          rep_dim=REP_DIM, mode="wa_down_tr_32_4")
    tree = jax.tree.map(np.asarray, params)
    jax_ckpt.save_params(str(tmp_path / "jax.npz"), params, jax_dims_for("tiny"))
    ckpt.save_params(str(tmp_path / "port.npz"), tree, dims_for("tiny"))
    for path in ("jax.npz", "port.npz"):
        jd, jtree = jax_ckpt.load_params(str(tmp_path / path))
        pd, ptree = ckpt.load_params(str(tmp_path / path))
        assert vars(pd) == vars(jd) == vars(dims_for("tiny"))
        for (pa, a), (pb, b), (pc, c) in zip(_leaves(ptree), _leaves(jax.tree.map(
                np.asarray, jtree)), _leaves(tree)):
            assert pa == pb == pc
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, c)
    assert ckpt._unflatten(ckpt._flatten(tree)).keys() == tree.keys()
    _, half = ckpt.load_params(str(tmp_path / "jax.npz"), dtype=np.float16)
    assert half["mlp"]["w"].dtype == np.float16


# --------------------------------------------------------------------------- #
# train(), weight averaging, resume, CLI
# --------------------------------------------------------------------------- #


def _loaders(pkg, ds):
    data = pkg.FeatureDataset(ds["train_json"], _conf(ds), ds["label_csv"])
    return (pkg.DataLoader(data, batch_size=8, shuffle=True, num_workers=2),
            pkg.DataLoader(data, batch_size=8, num_workers=2))


def _result(exp_dir):
    return np.loadtxt(os.path.join(exp_dir, "result.csv"), delimiter=",")


def _jax_train(ds, exp_dir, n_epochs, seed=0, resume=False):
    params = jt.init_tltr(jax.random.PRNGKey(seed), label_dim=N_CLASS, n_layer=N_LAYER,
                          rep_dim=REP_DIM, mode=MODE)
    jt.train(params, MODE, *_loaders(jt, ds), exp_dir=exp_dir, lr=5e-3, n_epochs=n_epochs,
             dataset="tiny", compute_dtype=jnp.float32, n_print_steps=1000, resume=resume)
    return params


def _port_train(ds, exp_dir, n_epochs, params, resume=False, report=None):
    model = _port_head(params, MODE, N_CLASS, N_LAYER, REP_DIM)
    return pt.train(model, MODE, *_loaders(pt, ds), exp_dir=exp_dir, lr=5e-3,
                    n_epochs=n_epochs, dataset="tiny", compute_dtype=torch.float32,
                    n_print_steps=1000, resume=resume, device="cpu", report=report)


@pytest.fixture(scope="module")
def three_epochs(tiny_dataset, tmp_path_factory):
    root = tmp_path_factory.mktemp("train")
    jax_dir, port_dir = str(root / "jax"), str(root / "port")
    params = _jax_train(tiny_dataset, jax_dir, 3)
    report = {}
    model = _port_train(tiny_dataset, port_dir, 3, params, report=report)
    return jax_dir, port_dir, model, report


def test_train_three_epochs_matches_jax(three_epochs):
    """Every result.csv row (acc, mAP, AUC, lr) to 1e-4, and the same files."""
    jax_dir, port_dir, _, report = three_epochs
    np.testing.assert_allclose(_result(port_dir), _result(jax_dir), atol=1e-4, rtol=0)
    assert _result(port_dir)[2, 1] > 0.5
    for epoch in (1, 2, 3):
        for name in (f"models/audio_model.{epoch}.npz", f"models/train_state.{epoch}.npz",
                     f"stats_{epoch}.pickle"):
            assert os.path.exists(os.path.join(port_dir, name)), name
    with np.load(os.path.join(port_dir, "models/train_state.3.npz")) as a, \
            np.load(os.path.join(jax_dir, "models/train_state.3.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in b.files:
            assert a[key].shape == b[key].shape and a[key].dtype == b[key].dtype, key
            np.testing.assert_allclose(a[key], b[key], atol=1e-4, rtol=0, err_msg=key)
    with open(os.path.join(port_dir, "progress.pkl"), "rb") as f:
        assert [row[0] for row in pickle.load(f)] == [1, 2, 3]
    assert sorted(report) == [1, 2, 3]
    assert all(np.isfinite(list(r.values())).all() for r in report.values())
    assert latest_resumable_epoch(port_dir) == jax_latest(jax_dir) == 3


def test_weight_averaging_matches_jax(three_epochs, tiny_dataset):
    jax_dir, port_dir, _, _ = three_epochs
    ref = jt.wa_model(jax_dir, 2, 3)
    out = pt.wa_model(port_dir, 2, 3)
    for (pa, a), (pb, b) in zip(_leaves(out), _leaves(jax.tree.map(np.asarray, ref))):
        assert pa == pb and a.dtype == b.dtype == np.float32
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0, err_msg=pa)
    _, on_disk = ckpt.load_params(os.path.join(port_dir, "models", "audio_model_wa.npz"))
    for (_, a), (_, b) in zip(_leaves(on_disk), _leaves(out)):
        np.testing.assert_array_equal(a, b)
    _, val = _loaders(pt, tiny_dataset)
    stats, _ = pt.validate(pt.make_eval_step(MODE, torch.float32), load_tltr(out, MODE, "cpu"),
                           val)
    _, jval = _loaders(jt, tiny_dataset)
    ref_stats, _ = jt.validate(jt.make_eval_step(MODE, jnp.float32), ref, jval)
    assert pt.mean_average_precision(stats) == pytest.approx(
        jt.mean_average_precision(ref_stats), abs=1e-4)


def test_port_resumes_a_jax_run(tiny_dataset, tmp_path):
    """JAX trains two epochs; from a copy of its files the port resumes the
    third with a fresh head, as JAX resumes its own: row 3 agrees to 1e-4,
    rows 1-2 are JAX's as written."""
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    _jax_train(tiny_dataset, jax_dir, 2)
    shutil.copytree(jax_dir, port_dir)
    _jax_train(tiny_dataset, jax_dir, 3, seed=99, resume=True)
    fresh = jt.init_tltr(jax.random.PRNGKey(99), label_dim=N_CLASS, n_layer=N_LAYER,
                         rep_dim=REP_DIM, mode=MODE)
    _port_train(tiny_dataset, port_dir, 3, fresh, resume=True)
    ours, ref = _result(port_dir), _result(jax_dir)
    np.testing.assert_array_equal(ours[:2], ref[:2])
    np.testing.assert_allclose(ours[2], ref[2], atol=1e-4, rtol=0)
    # and JAX resumes a run the port wrote
    _jax_train(tiny_dataset, port_dir, 4, seed=5, resume=True)
    assert _result(port_dir)[3, 1] > 0


def test_train_refuses_a_mesh(tiny_dataset, tmp_path):
    """A mesh that is not a `parallel.mesh.Mesh` is refused with TypeError
    (meshes train: test_torch_parallel_train.py)."""
    model = TLTR(N_CLASS, N_LAYER, REP_DIM, MODE)
    with pytest.raises(TypeError, match="mesh"):
        pt.train(model, MODE, *_loaders(pt, tiny_dataset), exp_dir=str(tmp_path), mesh=object(),
                 device="cpu")
    with pytest.raises(TypeError, match="mesh"):
        pt.make_sharded_train_step(object(), MODE, model, 1e-3)


def test_run_main_writes_the_artifact_suite(tmp_path):
    """`run.main` with the JAX CLI's arguments and --device cpu: balanced
    sampling, mixup, masks, a pretrained head with the classifier expanded
    past its classes, two epochs and weight averaging."""
    rng = np.random.default_rng(9)
    n_layer, rep_dim = jt.tltr_shape_for("whisper-tiny")
    feat_dir = tmp_path / "feat_as_tiny"
    feat_dir.mkdir()
    n_class = 6
    with open(tmp_path / "labels.csv", "w") as f:
        f.write("index,mid,display_name\n")
        for i in range(n_class):
            f.write(f"{i},/m/{i},c{i}\n")
    data = []
    for i in range(16):
        np.savez(feat_dir / f"a{i}.npz",
                 rng.standard_normal((n_layer - 1, 25, rep_dim)).astype(np.float32))
        data.append({"wav": f"/x/a{i}.wav", "labels": f"/m/{i % n_class}"})
    with open(tmp_path / "train.json", "w") as f:
        json.dump({"data": data}, f)
    head = jt.init_tltr(jax.random.PRNGKey(3), label_dim=4, n_layer=n_layer, rep_dim=rep_dim,
                        mode="lw_tr_1_8")
    jax_ckpt.save_params(str(tmp_path / "head.npz"), head)
    exp = tmp_path / "exp"
    argv = ["--data-train", str(tmp_path / "train.json"), "--data-val",
            str(tmp_path / "train.json"), "--label-csv", str(tmp_path / "labels.csv"),
            "--n_class", str(n_class), "--model", "whisper-high-lw_tr_1_8",
            "--model_size", "tiny", "--dataset", "tiny", "--tar_path_train", str(feat_dir),
            "--tar_path_val", str(feat_dir), "--exp-dir", str(exp), "-b", "8", "-w", "2",
            "--n-epochs", "2", "--mixup", "0.5", "--timem", "5", "--bal", "bal",
            "--label_smooth", "0.1", "--wa", "True", "--wa_start", "1", "--wa_end", "2",
            "--pretrained_model", str(tmp_path / "head.npz"), "--n-print-steps", "1"]
    model = port_run.main(argv + ["--device", "cpu"])
    for name in ("result.csv", "args.pkl", "progress.pkl", "stats_1.pickle", "stats_2.pickle",
                 "wa_res.csv", "models/audio_model.1.npz", "models/audio_model.2.npz",
                 "models/train_state.2.npz", "models/audio_model_wa.npz"):
        assert os.path.exists(exp / name), name
    assert np.isfinite(_result(exp)).all()
    assert np.loadtxt(exp / "wa_res.csv", delimiter=",")[:2].tolist() == [1, 2]
    assert tuple(model.mlp.weight.shape) == (n_class, rep_dim)
    # the pretrained head's first rows are the file's; the rest drawn as JAX draws them
    tree = tltr_to_jax_params(TLTR(n_class, n_layer, rep_dim, "lw_tr_1_8").state_dict())
    merged = port_run.load_pretrained_head(tree, str(tmp_path / "head.npz"), n_class)
    ref = jax_run.load_pretrained_head(tree, str(tmp_path / "head.npz"), n_class)
    for (pa, a), (pb, b) in zip(_leaves(merged), _leaves(jax.tree.map(np.asarray, ref))):
        np.testing.assert_array_equal(a, b, err_msg=pa)
    np.testing.assert_array_equal(merged["mlp"]["w"][:, :4], np.asarray(head["mlp"]["w"]))


# --------------------------------------------------------------------------- #
# operation counts
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("size", ["tiny", "base", "small", "medium", "large-v1"])
def test_flops_are_the_jax_integers(size):
    for mode in ALL_MODES + ["lw_tr_1_8", "lw_down_tr_512_1_8", "tl_tr_1_8",
                             "tl_down_tr_512_1_8"]:
        for n_layer, rep_dim, t in ((32, 1280, 25), (5, 384, 12), (13, 768, 25)):
            assert flops.tltr_flops(mode, n_layer, rep_dim, t) == jax_flops.tltr_flops(
                mode, n_layer, rep_dim, t), (mode, n_layer)
    dims, jdims = dims_for(size), jax_dims_for(size)
    assert flops.encoder_flops(dims) == jax_flops.encoder_flops(jdims)
    for n_tokens in (1, 100, 448):
        assert flops.decoder_flops(dims, n_tokens) == jax_flops.decoder_flops(jdims, n_tokens)
    for mode in ("tl_tr_1_8", "tl_down_tr_512_1_8"):
        assert flops.at_overhead(dims, mode) == jax_flops.at_overhead(jdims, mode)
    params = jt.init_tltr(jax.random.PRNGKey(0), label_dim=5, n_layer=3, rep_dim=16,
                          mode="lw_tr_1_4")
    assert flops.count_parameters(jax.tree.map(np.asarray, params)) == \
        flops.count_parameters(_port_head(params, "lw_tr_1_4", 5, 3, 16)) == \
        jax_flops.count_parameters(params)
    assert flops.tltr_flops("lw_tr_1_8", 32, 1280) == 16_412_281_600  # 16.41 GMAC a clip
