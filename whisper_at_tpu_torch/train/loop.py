"""Train / validate loops of the TL-TR head, schedulers, meters, and
checkpoint weight averaging.

Counterpart of `whisper_at_tpu/train/loop.py`, with the same artifacts in
the same formats: `result.csv` (acc, mAP, AUC, lr a row per epoch),
`models/audio_model.{n}.npz` (the JAX parameter tree, `checkpoint.py`),
`models/train_state.{n}.npz` (optax's Adam state in its leaf order, then
`__scale__` and `__epoch__`), `stats_{n}.pickle`, `progress.pkl` and
`audio_model_wa.npz`, so a run started by either package resumes in the
other. Host control as in the JAX loop: timing meters, the NaN abort, the
"as-full" 10%-of-epoch break, MultiStepLR / ReduceLROnPlateau as lr scales,
and the loss read one step late: step i's loss is copied to the host
behind its step and read after step i+1 is launched, so the host never
waits for the step in flight.

`train(mesh=)` runs the sharded step (`steps.make_sharded_train_step`) in
every rank of the mesh: each rank draws the same global batch from the same
seeded loader and steps on its dp slice, so the JAX package's random
streams are kept. Every rank validates. Checkpoints are gathered to whole
tensors on every rank and written by rank 0 alone, in the single-device
format: either kind of run resumes the other.
"""

import os
import pickle
import time
from typing import List, Optional

import numpy as np
import torch

from ..checkpoint import load_params, save_params
from ..convert import (
    jax_leaf_order,
    tltr_from_jax_params,
    tltr_leaf_from_jax,
    tltr_leaf_to_jax,
    tltr_to_jax_params,
)
from ..parallel.mesh import all_gather, as_mesh, shard_batch, split_rows, tltr_split_dim
from ..utils import resolve_device
from .stats import calculate_stats, d_prime, mean_auc, mean_average_precision
from .steps import (
    bce_with_logits_loss,
    ce_loss,
    make_eval_step,
    make_optimizer,
    make_sharded_train_step,
    make_train_step,
)
from .tltr import TLTR, count_parameters


class AverageMeter:
    """Running value/average meter (the reference's utilities/util.py)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count if self.count else 0.0


class MultiStepLR:
    """gamma decay at milestones start, start+step, ... (traintest.py:59)."""

    def __init__(self, start: int, step: int, gamma: float):
        self.milestones = set(range(start, 1000, step))
        self.gamma = gamma
        self.scale = 1.0
        self.epoch = 0

    def step(self, metric: Optional[float] = None):
        self.epoch += 1
        if self.epoch in self.milestones:
            self.scale *= self.gamma


class ReduceLROnPlateau:
    """Halve the lr when the metric stops improving (mode='max')."""

    def __init__(self, factor: float = 0.5, patience: int = 2):
        self.factor = factor
        self.patience = patience
        self.best = -np.inf
        self.bad_epochs = 0
        self.scale = 1.0

    def step(self, metric: float):
        if metric > self.best:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.scale *= self.factor
                self.bad_epochs = 0


def _to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def validate(eval_step, model: TLTR, val_loader, loss_fn=None):
    """Batched inference and the metrics (traintest.py:204-267): (stats,
    mean loss or NaN)."""
    device = next(model.parameters()).device
    predictions, targets, losses = [], [], []
    for feats, labels in val_loader:
        logits = eval_step(model, _to_device(feats, device)).cpu()
        predictions.append(logits.numpy())
        targets.append(labels)
        if loss_fn is not None:
            losses.append(float(loss_fn(logits, torch.from_numpy(labels))))
    output = np.concatenate(predictions)
    target = np.concatenate(targets)
    stats = calculate_stats(output, target)
    loss = float(np.mean(losses)) if losses else np.nan
    return stats, loss


def _adam_params(model: TLTR):
    """(name, parameter) in the JAX package's leaf order."""
    named = dict(model.named_parameters())
    return [(name, named[name]) for name in jax_leaf_order(named)]


def _whole(name: str, t: torch.Tensor, mesh=None) -> torch.Tensor:
    """A parameter (or its Adam moment) whole: gathered over tp along its
    split axis under a mesh, else `t`."""
    dim = tltr_split_dim(name, t.dim()) if mesh is not None else None
    if dim is None:
        return t
    return torch.cat(all_gather(t.contiguous(), mesh, "tp"), dim=dim)


def _save_train_state(path: str, optimizer, model: TLTR, scheduler_scale: float, epoch: int,
                      mesh=None):
    """optax's Adam state as `jax.tree.leaves` orders it (its step count,
    then the first moments, then the second, in the JAX layouts), then the
    scheduler scale and the epoch. Under a mesh every rank gathers the
    moments whole and rank 0 writes."""
    params = _adam_params(model)
    states = [optimizer.state.get(p, {}) for _, p in params]
    count = int(states[0]["step"]) if "step" in states[0] else 0
    leaves = [np.asarray(count, np.int32)]
    for key in ("exp_avg", "exp_avg_sq"):
        leaves += [tltr_leaf_to_jax(name, _whole(name, st[key] if key in st
                                                 else torch.zeros_like(p), mesh))
                   for (name, p), st in zip(params, states)]
    if mesh is not None and mesh.rank != 0:
        return
    arrays = {f"leaf_{i}": x for i, x in enumerate(leaves)}
    arrays["__scale__"] = np.asarray(scheduler_scale)
    arrays["__epoch__"] = np.asarray(epoch)
    np.savez(path, **arrays)


def _shard_adam_state(full: dict, optimizer, model, mesh) -> None:
    """Adam state of the whole head ({name: state}) as the state of this
    rank's shards of `model`'s parameters."""
    tp, index = mesh.size("tp"), mesh.coord("tp")
    for name, p in model.named_parameters():
        st = full.get(name)
        if not st:
            continue
        dim = tltr_split_dim(name, p.dim())
        part = (lambda t: t) if dim is None else (lambda t: split_rows(t, dim, tp, index))
        optimizer.state[p] = {"step": st["step"], "exp_avg": part(st["exp_avg"]),
                              "exp_avg_sq": part(st["exp_avg_sq"])}


def _load_train_state(path: str, optimizer, model: TLTR):
    """Restore Adam's step and moments from a train-state file written by
    either package; returns (scheduler scale, epoch)."""
    params = _adam_params(model)
    n = len(params)
    with np.load(path) as data:
        count = int(data["leaf_0"])
        leaves = [data[f"leaf_{i}"] for i in range(1, 2 * n + 1)]
        scale = float(data["__scale__"])
        epoch = int(data["__epoch__"])
    for i, (name, p) in enumerate(params):
        optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": tltr_leaf_from_jax(name, leaves[i]).to(p.device, p.dtype),
            "exp_avg_sq": tltr_leaf_from_jax(name, leaves[n + i]).to(p.device, p.dtype)}
    return scale, epoch


def latest_resumable_epoch(exp_dir: str) -> int:
    """Highest epoch with both a model checkpoint and a train-state file."""
    epoch = 0
    models_dir = os.path.join(exp_dir, "models")
    if not os.path.isdir(models_dir):
        return 0
    for name in os.listdir(models_dir):
        if name.startswith("train_state.") and name.endswith(".npz"):
            n = int(name.split(".")[1])
            if os.path.exists(os.path.join(models_dir, f"audio_model.{n}.npz")):
                epoch = max(epoch, n)
    return epoch


def load_tltr(tree: dict, mode: str, device="cuda") -> TLTR:
    """A head of `mode` holding the JAX-layout tree `tree` (shapes read from
    it), on `device`."""
    w = np.asarray(tree["mlp"]["w"])
    rep_dim = np.asarray(tree["down_ln"]["scale"]).shape[0] if "down_ln" in tree else w.shape[0]
    n_layer = np.asarray(tree["layer_weight"]).shape[0] if "layer_weight" in tree else 1
    model = TLTR(w.shape[1], n_layer, rep_dim, mode, device=resolve_device(device))
    names = list(model.state_dict())
    model.load_state_dict(tltr_from_jax_params(tree, names))
    return model


class _LossFetch:
    """A step's loss copied to the host behind the step (pinned buffer and
    event on the card), read only when asked."""

    def __init__(self, loss: torch.Tensor, n: int):
        self.n = n
        if loss.is_cuda:
            self.host = torch.empty((), dtype=loss.dtype, pin_memory=True)
            self.host.copy_(loss, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = loss, None

    def value(self) -> float:
        if self.event is not None:
            self.event.synchronize()
        return float(self.host)


def train(
    model: TLTR,
    mode: str,
    train_loader,
    val_loader,
    *,
    exp_dir: str,
    lr: float = 1e-4,
    n_epochs: int = 30,
    loss_type: str = "BCE",
    pos_weight: Optional[float] = None,
    metrics_name: str = "mAP",
    lr_adapt: bool = False,
    lr_patience: int = 2,
    lrscheduler_start: int = 15,
    lrscheduler_step: int = 5,
    lrscheduler_decay: float = 0.75,
    dataset: str = "as-full",
    save_model: bool = True,
    n_print_steps: int = 100,
    compute_dtype=torch.bfloat16,
    n_class_sonyc: Optional[int] = None,
    resume: bool = False,
    mesh=None,
    device="cuda",
    report: Optional[dict] = None,
) -> TLTR:
    """Train the TL-TR head on `device` (the card unless "cpu"); returns the
    trained model (moved to `device`, trained in place). `report`, when
    given, receives each epoch's meters (loss, per-sample data / DNN / total
    seconds, validation seconds, mAP, AUC) as the epoch ends.

    Epoch semantics mirror the reference: for 'as-full', each epoch breaks
    at 10% of the loader (traintest.py:136-139), so 30 epochs == 3 passes.

    mesh: a ('dp', 'tp') `parallel.mesh.Mesh`; every rank calls train with
    the same arguments and runs on the mesh's device (not `device`). The
    batch (every train batch size a multiple of dp) splits over dp, the
    head's blocks over tp; the returned model is this rank's shard.
    """
    if mesh is not None:
        mesh = as_mesh(mesh)
        dev = mesh.device
    else:
        dev = resolve_device(device)
    lead = mesh is None or mesh.rank == 0
    log = print if lead else (lambda *args, **kwargs: None)
    model = model.to(dev)
    os.makedirs(os.path.join(exp_dir, "models"), exist_ok=True)

    optimizer = make_optimizer(model.parameters(), lr)
    eval_step = make_eval_step(mode, compute_dtype)

    def loss_fn(logits, labels):
        if loss_type == "BCE":
            return bce_with_logits_loss(logits, labels, pos_weight)
        return ce_loss(logits, labels)

    if lr_adapt:
        scheduler = ReduceLROnPlateau(factor=0.5, patience=lr_patience)
        log("Override to use adaptive learning rate scheduler.")
    else:
        scheduler = MultiStepLR(lrscheduler_start, lrscheduler_step, lrscheduler_decay)
        log("The learning rate scheduler starts at {:d} epoch with decay rate "
            "of {:.3f} every {:d} epochs".format(lrscheduler_start, lrscheduler_decay,
                                                 lrscheduler_step))
    log("Total trainable parameter number is : {:.3f} million".format(
        count_parameters(model) / 1e6))

    loss_meter = AverageMeter()
    per_sample_time = AverageMeter()
    per_sample_data_time = AverageMeter()
    per_sample_dnn_time = AverageMeter()
    progress: List[list] = []
    best_mAP, best_acc, best_epoch = -np.inf, -np.inf, 0
    global_step = 0
    start_time = time.time()
    result = np.zeros([n_epochs, 4])

    start_epoch = 1
    if resume:
        last = latest_resumable_epoch(exp_dir)
        if last > 0:
            _, tree = load_params(os.path.join(exp_dir, "models", f"audio_model.{last}.npz"))
            with torch.no_grad():
                model.load_state_dict(tltr_from_jax_params(tree, list(model.state_dict())))
            scheduler.scale, _ = _load_train_state(
                os.path.join(exp_dir, "models", f"train_state.{last}.npz"), optimizer, model)
            if hasattr(scheduler, "epoch"):
                scheduler.epoch = last
            start_epoch = last + 1
            prev = np.loadtxt(os.path.join(exp_dir, "result.csv"), delimiter=",")
            result[: min(last, n_epochs)] = np.atleast_2d(prev)[: min(last, n_epochs)]
            log(f"resuming from epoch {last}")

    if mesh is not None:
        # the whole head's Adam state (restored above, or empty) onto the shards
        full_state = {name: optimizer.state.get(p) for name, p in model.named_parameters()}
        train_step, model, optimizer = make_sharded_train_step(
            mesh, mode, model, lr, loss_type, pos_weight, compute_dtype)
        _shard_adam_state(full_state, optimizer, model, mesh)
        prepare = lambda x: _to_device(shard_batch(mesh, x), dev)  # noqa: E731
    else:
        train_step = make_train_step(mode, optimizer, loss_type, pos_weight, compute_dtype)
        prepare = lambda x: _to_device(x, dev)  # noqa: E731

    for epoch in range(start_epoch, n_epochs + 1):
        begin_time = time.time()
        end_time = time.time()
        n_batches = len(train_loader)
        pending = None

        for i, (feats, labels) in enumerate(train_loader):
            data_t = time.time() - end_time
            loss = train_step(model, prepare(feats), prepare(labels), scheduler.scale)
            b = feats.shape[0]
            if pending is not None:
                loss_meter.update(pending.value(), pending.n)
            pending = _LossFetch(loss, b)
            # each iteration's meters cover exactly its own wall interval:
            # its data load, its launches and the previous loss's read
            body_end = time.time()
            per_sample_data_time.update(data_t / b)
            per_sample_time.update((body_end - end_time) / b)
            per_sample_dnn_time.update((body_end - end_time - data_t) / b)

            if global_step % n_print_steps == 0 and global_step != 0:
                log("Epoch: [{0}][{1}/{2}]\t"
                      "Per Sample Total Time {3:.5f}\t"
                      "Per Sample Data Time {4:.5f}\t"
                      "Per Sample DNN Time {5:.5f}\t"
                      "Train Loss {6:.4f}".format(
                          epoch, i, n_batches, per_sample_time.avg,
                          per_sample_data_time.avg, per_sample_dnn_time.avg,
                          loss_meter.val), flush=True)
                if np.isnan(loss_meter.avg):
                    log("training diverged...")
                    return model

            end_time = time.time()
            global_step += 1

            # as-full: 10% of iterations per epoch (traintest.py:136-139)
            if dataset == "as-full" and i > 0.1 * n_batches:
                break

        if pending is not None:
            loss_meter.update(pending.value(), pending.n)

        log("start validation")
        valid_t0 = time.time()
        stats, valid_loss = validate(eval_step, model, val_loader, loss_fn)
        valid_s = time.time() - valid_t0
        mAP = mean_average_precision(stats)
        mAUC = mean_auc(stats)
        acc = stats[0]["acc"]

        log("mAP: {:.6f}".format(mAP) if metrics_name == "mAP"
            else "acc: {:.6f}".format(acc))
        log("AUC: {:.6f}".format(mAUC))
        log("d_prime: {:.6f}".format(d_prime(mAUC)))
        log("train_loss: {:.6f}".format(loss_meter.avg))
        log("valid_loss: {:.6f}".format(valid_loss))

        if n_class_sonyc is not None and n_class_sonyc > 527:
            sonyc_mAP = float(np.mean([s["AP"] for s in stats[527:n_class_sonyc]]))
            original_mAP = float(np.mean([s["AP"] for s in stats[:527]]))
            log(f"Original AudioSet classes mAP: {original_mAP:.6f}")
            log(f"SONYC classes mAP: {sonyc_mAP:.6f}")

        result[epoch - 1, :] = [acc, mAP, mAUC, lr * scheduler.scale]
        if lead:
            np.savetxt(os.path.join(exp_dir, "result.csv"), result, delimiter=",")

        if mAP > best_mAP:
            best_mAP = mAP
            if metrics_name == "mAP":
                best_epoch = epoch
        if acc > best_acc:
            best_acc = acc
            if metrics_name == "acc":
                best_epoch = epoch

        if save_model:
            state = {name: _whole(name, t, mesh) for name, t in model.state_dict().items()}
            if lead:
                save_params(os.path.join(exp_dir, "models", f"audio_model.{epoch}.npz"),
                            tltr_to_jax_params(state))
            _save_train_state(os.path.join(exp_dir, "models", f"train_state.{epoch}.npz"),
                              optimizer, model, scheduler.scale, epoch, mesh)

        scheduler.step(mAP if metrics_name == "mAP" else acc)

        progress.append([epoch, global_step, best_epoch, best_mAP, time.time() - start_time])
        if lead:
            with open(os.path.join(exp_dir, f"stats_{epoch}.pickle"), "wb") as handle:
                pickle.dump(stats, handle, protocol=pickle.HIGHEST_PROTOCOL)
            with open(os.path.join(exp_dir, "progress.pkl"), "wb") as f:
                pickle.dump(progress, f)

        log("epoch {:d} training time: {:.3f}".format(epoch, time.time() - begin_time))
        if report is not None:
            report[epoch] = dict(loss=loss_meter.avg, valid_loss=valid_loss, mAP=mAP, mAUC=mAUC,
                                 per_sample_data_s=per_sample_data_time.avg,
                                 per_sample_dnn_s=per_sample_dnn_time.avg,
                                 per_sample_s=per_sample_time.avg, valid_s=valid_s)
        loss_meter.reset()
        per_sample_time.reset()
        per_sample_data_time.reset()
        per_sample_dnn_time.reset()

    return model


def wa_model(exp_dir: str, start_epoch: int = 16, end_epoch: int = 30) -> dict:
    """Average epoch checkpoints start..end (run.py:213-227) in float64;
    writes `models/audio_model_wa.npz` and returns the fp32 tree."""

    def add(a, b):
        return {k: add(v, b[k]) if isinstance(v, dict) else v + b[k] for k, v in a.items()}

    def each(fn, a):
        return {k: each(fn, v) if isinstance(v, dict) else fn(v) for k, v in a.items()}

    _, summed = load_params(os.path.join(exp_dir, "models", f"audio_model.{start_epoch}.npz"))
    summed = each(lambda a: a.astype(np.float64), summed)
    model_cnt = 1
    for epoch in range(start_epoch + 1, end_epoch + 1):
        path = os.path.join(exp_dir, "models", f"audio_model.{epoch}.npz")
        if os.path.exists(path):
            _, other = load_params(path)
            summed = add(summed, other)
            model_cnt += 1
    print("wa {:d} models from {:d} to {:d}".format(model_cnt, start_epoch, end_epoch))
    averaged = each(lambda a: (a / float(model_cnt)).astype(np.float32), summed)
    save_params(os.path.join(exp_dir, "models", "audio_model_wa.npz"), averaged)
    return averaged
