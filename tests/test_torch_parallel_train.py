"""The port's sharded TL-TR training against a single device and the JAX
package, on two and four gloo ranks (`torch_mesh_worker.py`, one spawn per
world size running every case).

The step: the JAX mesh test's head (lw_tr_1_4, 8 labels, 2 layers, rep 64)
through three fp32 steps on dp x tp meshes (dp 2 / tp 2 on two ranks;
dp 2 x tp 2 and tp 4 on four, where the time transformer's single head
splits across ranks), losses within the JAX test's rtol 2e-4 / atol 1e-5 of
the JAX and the port's single-device steps. The loop: `train(mesh=)` for two
epochs on the training tests' tiny feature set, every rank drawing the same
global batches and stepping on its dp slice; its checkpoints are the
single-device format and hold to a single-device run's, and one device
resumes the mesh run's files for a third epoch.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_at_tpu import train as jt
from whisper_at_tpu_torch import checkpoint as ckpt
from whisper_at_tpu_torch import train as pt
from whisper_at_tpu_torch.convert import tltr_from_jax_params
from whisper_at_tpu_torch.train.tltr import TLTR

from test_torch_train import N_CLASS, N_LAYER, REP_DIM, _conf, _leaves, tiny_dataset  # noqa: F401
from torch_mesh_worker import run_ranks, value

MODE = "lw_tr_1_4"
STEP_SHAPE = (8, 2, 64)  # label_dim, n_layer, rep_dim of the JAX mesh test
STEP_MESHES = {2: [(2, 1), (1, 2)], 4: [(2, 2), (1, 4)]}
LOOP_MESHES = {2: (1, 2), 4: (2, 2)}
LR = 5e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's passes here run on one thread, which keeps the file's time
    steady when other test processes share the cores (a thread pool per
    process oversubscribes them)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _head(params, shape) -> TLTR:
    head = TLTR(*shape, mode=MODE)
    head.load_state_dict(tltr_from_jax_params(params, list(head.state_dict())))
    return head


@pytest.fixture(scope="module")
def step_case():
    params = jt.init_tltr(jax.random.PRNGKey(1), label_dim=8, n_layer=2, rep_dim=64, mode=MODE)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((8, 2, 25, 64)).astype(np.float32)
    labels = (rng.random((8, 8)) > 0.8).astype(np.float32)
    return params, feats, labels


@pytest.fixture(scope="module")
def loop_init():
    return jt.init_tltr(jax.random.PRNGKey(0), label_dim=N_CLASS, n_layer=N_LAYER,
                        rep_dim=REP_DIM, mode=MODE)


def _run(world, step_case, loop_init, tiny_dataset, root):
    params, feats, labels = step_case
    loop_shape = (N_CLASS, N_LAYER, REP_DIM)
    payload = dict(
        tltr=dict(meshes=STEP_MESHES, shape=STEP_SHAPE, mode=MODE, lr=1e-3, steps=3,
                  state=_head(params, STEP_SHAPE).state_dict(), feats=feats, labels=labels),
        loop=dict(meshes=LOOP_MESHES, shape=loop_shape, mode=MODE, lr=LR, epochs=2,
                  state=_head(loop_init, loop_shape).state_dict(),
                  train_json=tiny_dataset["train_json"], label_csv=tiny_dataset["label_csv"],
                  conf=_conf(tiny_dataset), exp_dir=str(root / "exp")))
    return run_ranks(world, "train", payload, root / "ranks"), str(root / "exp")


@pytest.fixture(scope="module")
def ranks2(step_case, loop_init, tiny_dataset, tmp_path_factory):
    return _run(2, step_case, loop_init, tiny_dataset, tmp_path_factory.mktemp("train2"))


@pytest.fixture(scope="module")
def ranks4(step_case, loop_init, tiny_dataset, tmp_path_factory):
    return _run(4, step_case, loop_init, tiny_dataset, tmp_path_factory.mktemp("train4"))


@pytest.fixture(scope="module")
def single_losses(step_case):
    """Three fp32 steps on one device in both packages."""
    params, feats, labels = step_case
    optimizer = jt.make_optimizer(1e-3)
    step = jt.make_train_step(MODE, optimizer, compute_dtype=jnp.float32)
    p, o, jax_losses = params, optimizer.init(params), []
    for _ in range(3):
        p, o, loss = step(p, o, jnp.asarray(feats), jnp.asarray(labels), jnp.float32(1.0))
        jax_losses.append(float(loss))
    head = _head(params, STEP_SHAPE)
    pstep = pt.make_train_step(MODE, pt.make_optimizer(head.parameters(), 1e-3),
                               compute_dtype=torch.float32)
    port_losses = [float(pstep(head, torch.from_numpy(feats), torch.from_numpy(labels), 1.0))
                   for _ in range(3)]
    return jax_losses, port_losses


def _ranks(request, world):
    """(every rank's results, the mesh run's experiment directory)."""
    return request.getfixturevalue(f"ranks{world}")


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_training_matches_single_device(request, world, single_losses):
    """dp x tp sharded training gives the single device's losses on every
    rank, and each rank holds its shard of the split parameters."""
    jax_losses, port_losses = single_losses
    np.testing.assert_allclose(port_losses, jax_losses, rtol=2e-4, atol=1e-5)
    results, _ = _ranks(request, world)
    for rank in range(world):
        for (dp, tp), got in value(results, "train_step", rank).items():
            np.testing.assert_allclose(got["losses"], jax_losses, rtol=2e-4, atol=1e-5)
            np.testing.assert_allclose(got["losses"], port_losses, rtol=2e-4, atol=1e-5)
            shapes = got["shapes"]
            assert shapes["time_tr.attn.query.weight"] == (64 // tp, 64), (dp, tp)
            assert shapes["time_tr.attn.out.weight"] == (64, 64 // tp), (dp, tp)
            assert shapes["layer_tr.mlp.0.bias"] == (256 // tp,), (dp, tp)
            assert shapes["mlp.weight"] == (8, 64), (dp, tp)


def _loaders(ds):
    data = pt.FeatureDataset(ds["train_json"], _conf(ds), ds["label_csv"])
    return (pt.DataLoader(data, batch_size=8, shuffle=True, num_workers=2),
            pt.DataLoader(data, batch_size=8, num_workers=2))


def _result(exp_dir):
    return np.loadtxt(os.path.join(exp_dir, "result.csv"), delimiter=",")


def _resume_third_epoch(exp: str, tiny_dataset) -> None:
    """A fresh head on one device resuming `exp` for a third epoch."""
    pt.train(TLTR(N_CLASS, N_LAYER, REP_DIM, MODE), MODE, *_loaders(tiny_dataset), exp_dir=exp,
             lr=LR, n_epochs=3, dataset="tiny", compute_dtype=torch.float32,
             n_print_steps=1000, device="cpu", resume=True)


@pytest.fixture(scope="module")
def single_run(loop_init, tiny_dataset, tmp_path_factory):
    """The same two epochs on one device, and a copy of its files resumed
    for a third: (the two epochs' directory, the resumed one's)."""
    root = tmp_path_factory.mktemp("single")
    exp, resumed = str(root / "exp"), str(root / "resumed")
    head = _head(loop_init, (N_CLASS, N_LAYER, REP_DIM))
    pt.train(head, MODE, *_loaders(tiny_dataset), exp_dir=exp, lr=LR, n_epochs=2,
             dataset="tiny", compute_dtype=torch.float32, n_print_steps=1000, device="cpu")
    shutil.copytree(exp, resumed)
    _resume_third_epoch(resumed, tiny_dataset)
    return exp, resumed


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_train_writes_single_device_checkpoints(request, world, single_run):
    """Rank 0 writes whole tensors: each epoch's parameters and Adam state
    hold to the single-device run's (1e-4), and the metrics too."""
    results, exp = _ranks(request, world)
    single, _ = single_run
    for rank in range(world):
        report = value(results, "train_loop", rank)
        assert sorted(report) == [1, 2]
    np.testing.assert_allclose(_result(exp), _result(single), atol=1e-4, rtol=0)
    for epoch in (1, 2):
        _, ours = ckpt.load_params(os.path.join(exp, "models", f"audio_model.{epoch}.npz"))
        _, ref = ckpt.load_params(os.path.join(single, "models", f"audio_model.{epoch}.npz"))
        for (pa, a), (pb, b) in zip(_leaves(ours), _leaves(ref)):
            assert pa == pb and a.shape == b.shape
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=0, err_msg=pa)
        with np.load(os.path.join(exp, "models", f"train_state.{epoch}.npz")) as a, \
                np.load(os.path.join(single, "models", f"train_state.{epoch}.npz")) as b:
            assert sorted(a.files) == sorted(b.files)
            for key in b.files:
                assert a[key].shape == b[key].shape, key
                np.testing.assert_allclose(a[key], b[key], atol=1e-4, rtol=0, err_msg=key)


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_checkpoint_resumes_on_one_device(request, world, tiny_dataset, single_run):
    """One device resumes the mesh run's files for a third epoch as it
    resumes its own: row 3 holds to the single-device resume's (1e-4), rows
    1-2 stay as the mesh wrote them."""
    results, exp = _ranks(request, world)
    value(results, "train_loop", 0)
    written = _result(exp).copy()
    _resume_third_epoch(exp, tiny_dataset)
    ours = _result(exp)
    np.testing.assert_array_equal(ours[:2], written)
    np.testing.assert_allclose(ours[2], _result(single_run[1])[2], atol=1e-4, rtol=0)
