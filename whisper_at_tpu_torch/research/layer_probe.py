"""Layer-wise linear probing of encoder representations (the ESC-50
experiment).

Counterpart of `whisper_at_tpu/research/layer_probe.py` (the reference's
noise_robust_asr/baseline_sound_classification.py:22-82), which fits
scikit-learn's Pipeline(StandardScaler(), MLPClassifier(hidden_layer_sizes=
(), max_iter, random_state=0)) a layer and fold. The port has no
scikit-learn: `fit_linear_probe` takes that fit's steps in torch, as
scikit-learn 1.9 takes them.

* Scaling: mean and population variance of the fold's training rows in
  float64 (the corrected two-pass sums), a near-constant feature scaled by
  1, both cast to the input dtype before `(x - mean) / scale`.
* Labels: the sorted unique training labels; two (or one) classes give one
  logistic unit and binary cross-entropy, more give softmax and
  cross-entropy.
* Initialisation: Glorot-uniform with factor 6 (the default relu hidden
  activation) from numpy.random.RandomState(0), coefficients then
  intercepts.
* Epochs: the sample indices shuffled by the same RandomState as
  sklearn.utils.shuffle does, mini-batches of min(200, n) rows; the loss
  with the L2 term alpha = 1e-4 over the batch's rows; Adam at lr 1e-3,
  betas 0.9 / 0.999, eps 1e-8 with the bias correction folded into the step
  size, the step in float64 and the parameters rounded back to their dtype,
  as numpy's type promotion does there.
* Stopping: the epoch loss (the row-weighted mean) has not improved on its
  best by tol = 1e-4 for more than 10 epochs, or max_iter epochs ran.

Within a fold every layer's classifier has the same rows, width and
classes, so scikit-learn draws the same initial values and permutations for
each: the fold's layers are one batched problem [L, D, C], one batched
product a step. A layer freezes when its own stopping rule fires; the loop
ends when all have stopped. The draws happen on the host with numpy, the
arithmetic on `device` (the card unless the caller asks for the CPU).
"""

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..utils import resolve_device

ALPHA = 1e-4
LEARNING_RATE = 1e-3
BETA_1, BETA_2, EPSILON = 0.9, 0.999, 1e-8
TOL = 1e-4
N_ITER_NO_CHANGE = 10
MAX_BATCH = 200
RANDOM_STATE = 0


def _float_dtype(x: np.ndarray) -> np.dtype:
    """float32 and float64 stay; anything else is fitted in float64."""
    return x.dtype if x.dtype in (np.float32, np.float64) else np.dtype(np.float64)


def _layers_first(x: np.ndarray, dtype: np.dtype, dev) -> torch.Tensor:
    """[n, L, D] numpy -> [L, n, D] tensor of `dtype` on `dev`."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x).astype(dtype, copy=False).transpose(1, 0, 2))).to(dev)


def _scaler(x: torch.Tensor):
    """StandardScaler's mean and scale [L, D] (float64) of x [L, n, D]."""
    n = x.shape[1]
    x64 = x.double()
    mean = x64.sum(1) / n
    centred = x64 - mean[:, None]
    correction = centred.sum(1)
    var = ((centred * centred).sum(1) - correction * correction / n) / n
    eps = torch.finfo(torch.float64).eps
    constant = var <= n * eps * var + (n * mean * eps) ** 2
    return mean, torch.where(constant, torch.ones_like(var), var.sqrt())


def _standardise(x: torch.Tensor, mean: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(x - mean) / scale in x's dtype, the statistics cast to it first."""
    return (x - mean.to(x.dtype)[:, None]) / scale.to(x.dtype)[:, None]


def _output(z: torch.Tensor, softmax: bool) -> torch.Tensor:
    if softmax:
        e = torch.exp(z - z.amax(-1, keepdim=True))
        return e / e.sum(-1, keepdim=True)
    return torch.sigmoid(z)


@dataclass
class ProbeFit:
    """One fold's fitted probes, a layer each: the scaler's `mean` and
    `scale` [L, D] (float64), `coefs` [L, D, K] and `intercepts` [L, K] in
    the fit's dtype (K = 1 for two classes or fewer), the epochs each layer
    ran (`n_iter` [L]) and its epoch losses (`loss_curves`)."""

    classes: np.ndarray
    mean: torch.Tensor
    scale: torch.Tensor
    coefs: torch.Tensor
    intercepts: torch.Tensor
    n_iter: np.ndarray
    loss_curves: List[List[float]]

    def scaled(self, x: np.ndarray) -> torch.Tensor:
        """x [n, L, D] standardised with the fold's statistics: [L, n, D]."""
        dtype = np.float64 if self.coefs.dtype == torch.float64 else np.float32
        return _standardise(_layers_first(x, dtype, self.coefs.device), self.mean, self.scale)

    def predict(self, x: np.ndarray) -> np.ndarray:
        """Labels [L, n] of x [n, L, D]."""
        softmax = len(self.classes) > 2
        p = _output(torch.bmm(self.scaled(x), self.coefs) + self.intercepts[:, None], softmax)
        idx = p.argmax(-1) if softmax else (p[..., 0] > 0.5).long()
        return self.classes[np.minimum(idx.cpu().numpy(), len(self.classes) - 1)]

    def score(self, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        """Accuracy of each layer's probe on (x, y): [L] float64."""
        return np.array([float(np.mean(pred == np.asarray(y))) for pred in self.predict(x)])


def fit_linear_probe(x: np.ndarray, y: np.ndarray, max_iter: int = 200,
                     device="cuda") -> ProbeFit:
    """Fit a scaled linear classifier to each layer of x [n, L, D] with
    labels y [n], as scikit-learn's Pipeline(StandardScaler(),
    MLPClassifier(hidden_layer_sizes=(), max_iter=max_iter,
    random_state=0)) fits it, all layers at once on `device`."""
    dev = resolve_device(device)
    x = np.asarray(x)
    dtype = _float_dtype(x)
    xt = _layers_first(x, dtype, dev)
    n_layer, n, width = xt.shape
    mean, scale = _scaler(xt)
    xs = _standardise(xt, mean, scale)

    classes, y_idx = np.unique(np.asarray(y), return_inverse=True)
    softmax = len(classes) > 2
    k = len(classes) if softmax else 1
    target = (np.eye(k, dtype=dtype)[y_idx] if softmax
              else (y_idx == 1).astype(dtype)[:, None])
    target = torch.from_numpy(target).to(dev)

    rs = np.random.RandomState(RANDOM_STATE)
    bound = np.sqrt(6.0 / (width + k))
    coef0 = rs.uniform(-bound, bound, (width, k)).astype(dtype, copy=False)
    icpt0 = rs.uniform(-bound, bound, k).astype(dtype, copy=False)
    coef = torch.from_numpy(coef0).to(dev).expand(n_layer, width, k).clone()
    icpt = torch.from_numpy(icpt0).to(dev).expand(n_layer, k).clone()
    m_c, v_c = torch.zeros_like(coef), torch.zeros_like(coef)
    m_i, v_i = torch.zeros_like(icpt), torch.zeros_like(icpt)
    eps = torch.finfo(xs.dtype).eps

    def adam(p, m, v, g, lr):
        m = BETA_1 * m + (1 - BETA_1) * g
        v = BETA_2 * v + (1 - BETA_2) * (g * g)
        step = -lr * m.double() / (v.sqrt() + EPSILON).double()
        return (p.double() + step).to(p.dtype), m, v

    batch = min(MAX_BATCH, n)
    sample_idx = np.arange(n)
    active = np.ones(n_layer, bool)
    n_iter = np.zeros(n_layer, np.int64)
    curves: List[List] = [[] for _ in range(n_layer)]
    best = [np.inf] * n_layer
    no_improvement = [0] * n_layer
    t = 0
    for _ in range(max_iter):
        perm = np.arange(n)
        rs.shuffle(perm)
        sample_idx = sample_idx[perm]
        keep = torch.from_numpy(active).to(dev)
        total = torch.zeros(n_layer, dtype=xs.dtype, device=dev)
        for start in range(0, n, batch):
            rows = torch.from_numpy(sample_idx[start:start + batch]).to(dev)
            xb, yb = xs[:, rows], target[rows]
            nb = rows.shape[0]
            p = _output(torch.bmm(xb, coef) + icpt[:, None], softmax)
            pc = p.clamp(eps, 1 - eps)
            ll = yb * torch.log(pc)
            if not softmax:
                ll = ll + (1 - yb) * torch.log(1 - pc)
            loss = -ll.mean(1).sum(-1) + (0.5 * ALPHA) * (coef * coef).sum((1, 2)) / nb
            total = total + loss * nb
            delta = p - yb
            g_c = (torch.bmm(xb.transpose(1, 2), delta) + ALPHA * coef) / nb
            g_i = delta.sum(1) / nb
            t += 1
            lr = LEARNING_RATE * np.sqrt(1 - BETA_2**t) / (1 - BETA_1**t)
            new_c, m_c, v_c = adam(coef, m_c, v_c, g_c, lr)
            new_i, m_i, v_i = adam(icpt, m_i, v_i, g_i, lr)
            coef = torch.where(keep[:, None, None], new_c, coef)
            icpt = torch.where(keep[:, None], new_i, icpt)
        losses = (total / n).cpu().numpy()
        for layer in np.flatnonzero(active):
            loss = losses[layer]
            n_iter[layer] += 1
            curves[layer].append(loss)
            if loss > best[layer] - TOL:
                no_improvement[layer] += 1
            else:
                no_improvement[layer] = 0
            if loss < best[layer]:
                best[layer] = loss
            if no_improvement[layer] > N_ITER_NO_CHANGE:
                active[layer] = False
        if not active.any():
            break
    return ProbeFit(classes, mean, scale, coef, icpt, n_iter,
                    [[float(v) for v in c] for c in curves])


def _fold_defs(n_samples: int, folds: Optional[np.ndarray]):
    if folds is None:
        split = int(0.8 * n_samples)
        return [(np.arange(split), np.arange(split, n_samples))]
    return [(np.where(folds != f)[0], np.where(folds == f)[0]) for f in np.unique(folds)]


def layer_wise_probe(
    features: np.ndarray,  # [n_samples, n_layers, dim] time-pooled taps
    labels: np.ndarray,  # [n_samples]
    folds: Optional[np.ndarray] = None,  # [n_samples] fold ids, or None
    max_iter: int = 200,
    device="cuda",
) -> List[Dict]:
    """A linear probe a layer and fold (folds in turn; with folds=None the
    first 80% of the rows train and the rest test). Returns one dict a
    layer: {'layer', 'accuracy' (the folds' mean), 'fold_accuracies'}."""
    features, labels = np.asarray(features), np.asarray(labels)
    n_samples, n_layers, _ = features.shape
    fold_accs = [[] for _ in range(n_layers)]
    for train_idx, test_idx in _fold_defs(n_samples, folds):
        fit = fit_linear_probe(features[train_idx], labels[train_idx], max_iter, device)
        for layer, acc in enumerate(fit.score(features[test_idx], labels[test_idx])):
            fold_accs[layer].append(float(acc))
    return [{"layer": layer, "accuracy": float(np.mean(accs)), "fold_accuracies": accs}
            for layer, accs in enumerate(fold_accs)]
