"""ESC-50-style layer-wise probing on the PyTorch/CUDA port
(`examples/esc50_probe.py` in the port's API).

The reference's representation analysis (noise_robust_asr/
baseline_sound_classification.py and the figure 1 lower / figure 3 plots):
all-layer, time-pooled encoder features of labelled clips (5 s clips, the
mel truncated to 500 frames: the ESC-50 recipe), a linear probe a layer and
fold (`research.layer_probe`, the port's own classifier), and the
layer-wise accuracy plotted where matplotlib is installed. Runs offline
with synthetic tones and a random-weight model. Runs on the card unless
--device cpu.
"""

import argparse
import os
import sys
import tempfile
import wave

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import whisper_at_tpu_torch as whisper  # noqa: E402
from whisper_at_tpu_torch.research.feature_extract import extract_features  # noqa: E402
from whisper_at_tpu_torch.research.layer_probe import layer_wise_probe  # noqa: E402
from whisper_at_tpu_torch.research.plots import (  # noqa: E402
    plot_best_layer_histogram,
    plot_layerwise_accuracy,
)


def make_clips(root: str, n: int = 40, n_class: int = 5):
    """n 5 s tones with a little noise, a class a frequency, as WAVs under
    `root` (default_rng(0)); folds i % 4. Returns (paths, labels, folds)."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(0)
    freqs = [200 * (1.5**i) for i in range(n_class)]
    paths, labels, folds = [], [], []
    for i in range(n):
        cls = int(rng.integers(0, n_class))
        t = np.arange(16000 * 5) / 16000.0
        x = 0.4 * np.sin(2 * np.pi * freqs[cls] * t)
        x += 0.05 * rng.standard_normal(len(t))
        path = os.path.join(root, f"clip{i}.wav")
        with wave.open(path, "wb") as wf:
            wf.setnchannels(1)
            wf.setsampwidth(2)
            wf.setframerate(16000)
            wf.writeframes((x * 32767).astype(np.int16).tobytes())
        paths.append(path)
        labels.append(cls)
        folds.append(i % 4)
    return paths, np.asarray(labels), np.asarray(folds)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=None,
                        help="working directory (default: a new one under the "
                             "temporary directory)")
    parser.add_argument("--model", default="tiny")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args()
    args.root = args.root or tempfile.mkdtemp(prefix="wat_esc50_torch_")

    model = whisper.build_model(args.model, device=args.device)  # random; real use: load_model
    paths, labels, folds = make_clips(args.root)

    # the ESC-50 recipe: 5 s clips, the mel truncated to 500 frames,
    # all-layer taps pooled over time
    feats = []
    for path in paths:
        f = extract_features(model, path, n_frames=500)  # [L, T', D]
        feats.append(f.mean(axis=1))  # pooled over time: [L, D]
    feats = np.stack(feats)  # [N, L, D]

    results = layer_wise_probe(feats, labels, folds, max_iter=1000, device=args.device)
    accs = [r["accuracy"] for r in results]
    print("layer-wise probe accuracy:")
    for r in results:
        print(f"  layer {r['layer']}: {r['accuracy']:.3f}")

    plot_layerwise_accuracy({args.model: accs}, os.path.join(args.root, "layerwise_acc.png"))
    best = int(np.argmax(accs))
    plot_best_layer_histogram([best], len(accs), os.path.join(args.root, "best_layer.png"))
    print(f"best layer: {best}; figures -> {args.root}")


if __name__ == "__main__":
    main()
