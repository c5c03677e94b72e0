"""Evaluation metrics: per-class AP / AUC / PR and ROC curves, mAP, d-prime.

Counterpart of `whisper_at_tpu/train/stats.py`, in numpy and `scipy.stats`
only (the card's machine has no scikit-learn): the functions below compute
scikit-learn's definitions, operation for operation, of
`average_precision_score`, `roc_auc_score`, `precision_recall_curve`,
`roc_curve` (with its default `drop_intermediate=True`) and
`accuracy_score` for binary targets: scores sorted descending (stable),
tied scores grouped at one threshold, true and false positives counted in
float64.

A class whose targets hold one value only (no positive, or no negative)
has no ROC AUC. It reports -1 curves and AUC and prints "class k no true
sample", the reference's convention (older scikit-learn raised there;
1.6 and later return NaN, which would make mAUC NaN on any validation set
that misses a class).
"""

from typing import List

import numpy as np
from scipy import stats as scipy_stats


def d_prime(auc: float) -> float:
    return scipy_stats.norm().ppf(auc) * np.sqrt(2.0)


def _binary(y_true: np.ndarray) -> np.ndarray:
    """y_true == 1 as float64, for targets in {0, 1} (or {-1, 1})."""
    y_true = np.asarray(y_true).reshape(-1)
    values = np.unique(y_true)
    if values.size > 2 or not np.isin(values, (-1, 0, 1)).all():
        raise ValueError(f"targets must be binary (0/1), got values {values[:5]}")
    return (y_true == 1).astype(np.float64)


def _curve_counts(y_true: np.ndarray, y_score: np.ndarray):
    """(fps, tps, thresholds) at each distinct score, descending."""
    y_true, y_score = _binary(y_true), np.asarray(y_score).reshape(-1)
    if not (np.isfinite(y_score).all()):
        raise ValueError("scores must be finite")
    order = y_score.size - 1 - np.argsort(y_score[::-1], kind="stable")[::-1]
    y_score, y_true = y_score[order], y_true[order]
    idx = np.r_[np.nonzero(np.diff(y_score))[0], y_true.size - 1]
    tps = np.cumsum(y_true, dtype=np.float64)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    return fps, tps, y_score[idx]


def precision_recall_curve(y_true, y_score):
    """(precision, recall, thresholds), recall decreasing, ending (1, 0)."""
    fps, tps, thresholds = _curve_counts(y_true, y_score)
    ps = tps + fps
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(ps != 0, tps / ps, 0.0)
    recall = np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1]
    return (np.concatenate([precision[::-1], [1.0]]),
            np.concatenate([recall[::-1], [0.0]]), thresholds[::-1])


def roc_curve(y_true, y_score):
    """(fpr, tpr, thresholds) from (0, 0), points in between collinear
    neighbours dropped."""
    fps, tps, thresholds = _curve_counts(y_true, y_score)
    if fps.shape[0] > 2:
        keep = np.where(np.concatenate(
            [[True], np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), [True]]))[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps = np.concatenate([[0.0], tps])
    fps = np.concatenate([[0.0], fps])
    thresholds = np.concatenate([[np.inf], thresholds.astype(np.float64)])
    fpr = np.full(fps.shape, np.nan) if fps[-1] <= 0 else fps / fps[-1]
    tpr = np.full(tps.shape, np.nan) if tps[-1] <= 0 else tps / tps[-1]
    return fpr, tpr, thresholds


def average_precision_score(y_true, y_score) -> float:
    precision, recall, _ = precision_recall_curve(y_true, y_score)
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def roc_auc_score(y_true, y_score) -> float:
    """Trapezoidal area under the ROC curve; ValueError for one class."""
    if np.unique(np.asarray(y_true)).size != 2:
        raise ValueError("Only one class present in y_true. ROC AUC score is not "
                         "defined in that case.")
    fpr, tpr, _ = roc_curve(y_true, y_score)
    return float(np.trapezoid(tpr, fpr))


def accuracy_score(y_true, y_pred) -> float:
    return float(np.average(np.asarray(y_true) == np.asarray(y_pred)))


def calculate_stats(output: np.ndarray, target: np.ndarray) -> List[dict]:
    """Per-class statistics of multi-label predictions, output and target
    [n_samples, n_classes]; curves subsampled 1 in 1000."""
    output = np.asarray(output)
    target = np.asarray(target)
    acc = accuracy_score(np.argmax(target, 1), np.argmax(output, 1))
    out_stats = []
    for k in range(target.shape[-1]):
        avg_precision = average_precision_score(target[:, k], output[:, k])
        try:
            auc = roc_auc_score(target[:, k], output[:, k])
            precisions, recalls, _ = precision_recall_curve(target[:, k], output[:, k])
            fpr, tpr, _ = roc_curve(target[:, k], output[:, k])
            every = 1000  # subsample curves to bound pickle size
            entry = {"precisions": precisions[0::every], "recalls": recalls[0::every],
                     "AP": avg_precision, "fpr": fpr[0::every],
                     "fnr": 1.0 - tpr[0::every], "auc": auc,
                     "acc": acc}  # not class-wise; kept for schema consistency
        except ValueError:
            entry = {"precisions": -1, "recalls": -1, "AP": avg_precision, "fpr": -1,
                     "fnr": -1, "auc": -1, "acc": acc}
            print("class {:s} no true sample".format(str(k)))
        out_stats.append(entry)
    return out_stats


def mean_average_precision(stats: List[dict]) -> float:
    return float(np.mean([s["AP"] for s in stats]))


def mean_auc(stats: List[dict]) -> float:
    return float(np.mean([s["auc"] for s in stats]))
