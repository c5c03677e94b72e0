"""The paper's figures for the noise-robustness experiments.

Counterpart of `whisper_at_tpu/research/plots.py` (the reference's
noise_robust_asr/plots/): WER against SNR a model (figure 1 upper),
layer-wise ESC-50 accuracy (figure 1 lower), the noise classes that hurt
speech recognition most (figure 2) and the best-layer histogram (figure 3).
matplotlib is optional and imported only when a figure is drawn; without
it (`HAVE_MPL` false) every function returns its data and draws nothing.
"""

import importlib.util
from typing import Dict, List, Optional, Sequence

import numpy as np


def _mpl_available() -> bool:
    try:
        return importlib.util.find_spec("matplotlib") is not None
    except ValueError:  # sys.modules holds None for it: its import is blocked
        return False


HAVE_MPL = _mpl_available()

SNR_LEVELS = [-20, -15, -10, -5, 0, 5, 10, 15, 20]


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _finish(plt, fig, out_path: Optional[str]) -> None:
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=150)
    plt.close(fig)


def plot_wer_vs_snr(
    wer_by_model: Dict[str, Sequence[float]],
    out_path: Optional[str] = None,
    snr_levels: Sequence[int] = tuple(SNR_LEVELS),
):
    """WER against SNR, one line a speech recognition model."""
    if not HAVE_MPL:
        return wer_by_model
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 4))
    for model, wers in wer_by_model.items():
        ax.plot(snr_levels, np.asarray(wers) * 100, marker="o", label=model)
    ax.set_xlabel("SNR (dB)")
    ax.set_ylabel("WER (%)")
    ax.legend()
    ax.grid(alpha=0.3)
    _finish(plt, fig, out_path)
    return wer_by_model


def plot_layerwise_accuracy(
    acc_by_model: Dict[str, Sequence[float]],
    out_path: Optional[str] = None,
):
    """Layer-wise sound classification accuracy against relative depth."""
    if not HAVE_MPL:
        return acc_by_model
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 4))
    for model, accs in acc_by_model.items():
        accs = np.asarray(accs)
        ax.plot(np.arange(len(accs)) / max(len(accs) - 1, 1), accs * 100,
                marker=".", label=model)
    ax.set_xlabel("relative layer depth")
    ax.set_ylabel("ESC-50 accuracy (%)")
    ax.legend()
    ax.grid(alpha=0.3)
    _finish(plt, fig, out_path)
    return acc_by_model


def plot_classwise_noise(
    wer_per_class: np.ndarray,  # [n_classes] WER at a fixed SNR
    class_names: List[str],
    out_path: Optional[str] = None,
    top_k: int = 20,
):
    """The top_k noise classes by WER: [(name, WER)], highest first."""
    order = np.argsort(wer_per_class)[::-1][:top_k]
    top = [(class_names[i], float(wer_per_class[i])) for i in order]
    if not HAVE_MPL:
        return top
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.bar(range(len(order)), wer_per_class[order] * 100)
    ax.set_xticks(range(len(order)))
    ax.set_xticklabels([class_names[i] for i in order], rotation=60, ha="right")
    ax.set_ylabel("WER (%)")
    _finish(plt, fig, out_path)
    return top


def plot_best_layer_histogram(
    best_layers: Sequence[int],
    n_layers: int,
    out_path: Optional[str] = None,
):
    """How many classes each layer is best for: counts [n_layers]."""
    counts = np.bincount(np.asarray(best_layers), minlength=n_layers)
    if not HAVE_MPL:
        return counts
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.bar(range(n_layers), counts)
    ax.set_xlabel("layer")
    ax.set_ylabel("# classes with best F1")
    _finish(plt, fig, out_path)
    return counts
