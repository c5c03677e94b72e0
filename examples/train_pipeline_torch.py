"""TL-TR training on the PyTorch/CUDA port, wavs to a model file:
extraction, training, weight averaging, validation and the model file
(`examples/train_pipeline.py` in the port's API).

The same synthetic labelled wavs as the JAX example (six tone classes). The
head is trained in the model's own architecture (`lw_tr_1_8`, the training
stack's name of the model's `tl_tr_1_8` head) over 527 label rows, the six
tone classes first, so that it can be merged into the model:
the last step saves the reference-layout `.pt` ({"dims",
"model_state_dict"}) with the averaged head in it and reads it back with
`load_model`. (The JAX example trains `lw_tr_1_4` over six rows and exports
the head alone.) mAP is printed over the six tone classes; the 521 rows no
clip carries report "no true sample", and those lines are left out. Runs on
the card unless --device cpu.
"""

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import wave

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import whisper_at_tpu_torch as whisper  # noqa: E402
from whisper_at_tpu_torch.audio import N_FRAMES, log_mel_spectrogram, pad_or_trim  # noqa: E402
from whisper_at_tpu_torch.convert import at_head_state_dict  # noqa: E402
from whisper_at_tpu_torch.research.feature_extract import extract_feature_set  # noqa: E402
from whisper_at_tpu_torch.train import (  # noqa: E402
    DataLoader,
    FeatureDataset,
    init_tltr,
    make_eval_step,
    mean_average_precision,
    train,
    validate,
    wa_model,
)
from whisper_at_tpu_torch.train.loop import load_tltr  # noqa: E402

N_LABELS = 527


def make_synthetic_dataset(root: str, n_clips: int = 24, n_class: int = 6):
    """Labelled 10 s wavs, a class a tone frequency (default_rng(0)), their
    data json, and a 527-row label csv whose first n_class rows are the
    tones. Returns (data json, label csv)."""
    os.makedirs(os.path.join(root, "audio"), exist_ok=True)
    rng = np.random.default_rng(0)
    freqs = [220 * (1.3**i) for i in range(n_class)]
    data = []
    for i in range(n_clips):
        cls = int(rng.integers(0, n_class))
        t = np.arange(16000 * 10) / 16000.0
        x = 0.4 * np.sin(2 * np.pi * freqs[cls] * t)
        x += 0.02 * rng.standard_normal(len(t))
        path = os.path.join(root, "audio", f"clip{i}.wav")
        with wave.open(path, "wb") as wf:
            wf.setnchannels(1)
            wf.setsampwidth(2)
            wf.setframerate(16000)
            wf.writeframes((x * 32767).astype(np.int16).tobytes())
        data.append({"wav": path, "labels": f"/m/{cls:03d}"})

    with open(os.path.join(root, "data.json"), "w") as f:
        json.dump({"data": data}, f)
    with open(os.path.join(root, "labels.csv"), "w") as f:
        f.write("index,mid,display_name\n")
        for c in range(N_LABELS):
            f.write(f'{c},/m/{c:03d},"{f"tone {c}" if c < n_class else f"class {c}"}"\n')
    return os.path.join(root, "data.json"), os.path.join(root, "labels.csv")


def without_empty_classes(fn, *args, **kwargs):
    """fn(*args, **kwargs), its output printed without the lines of classes
    that no clip carries."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kwargs)
    lines = [ln for ln in buf.getvalue().splitlines() if not ln.endswith("no true sample")]
    if lines:
        print("\n".join(lines))
    return out


def clip_tags(model, path: str) -> torch.Tensor:
    """Tag logits [3, 527] of a clip's 30 s window (fp32)."""
    mel = pad_or_trim(log_mel_spectrogram(path, device=model.device), N_FRAMES)
    with torch.no_grad():
        _, taps = model.embed_audio(mel, fp16=False)
        return model.at_forward(taps)[0].float().cpu()


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=None,
                        help="working directory (default: a new one under the "
                             "temporary directory)")
    parser.add_argument("--model", default="tiny", help="feature-source size")
    parser.add_argument("--epochs", type=int, default=4)
    parser.add_argument("--synthetic", action="store_true", default=True)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args()
    args.root = args.root or tempfile.mkdtemp(prefix="wat_train_torch_")

    data_json, label_csv = make_synthetic_dataset(args.root)
    model = whisper.build_model(args.model, device=args.device)  # random backbone; real use:
    # model = whisper.load_model(args.model, device=args.device)

    # 1. all-layer pooled features (batched, resume by skip); the directory
    #    name holds 'feat_as' so the loader reads .npz
    feat_dir = os.path.join(args.root, "feat_as")
    written = extract_feature_set(model, data_json, feat_dir, n_frames=1000)
    print(f"extracted {len(written)} feature files -> {feat_dir}")

    # 2. the TL-TR head on the features, in the model's own architecture
    conf = {"freqm": 0, "timem": 3, "mixup": 0.2, "dataset": "demo",
            "label_smooth": 0.05, "tar_path": feat_dir}
    ds = FeatureDataset(data_json, conf, label_csv=label_csv)
    loader = DataLoader(ds, batch_size=8, shuffle=True, num_workers=2)
    # evaluation targets stay binary for AP / AUC (label smoothing only in training)
    val_conf = dict(conf, freqm=0, timem=0, mixup=0, label_smooth=0.0)
    val_loader = DataLoader(FeatureDataset(data_json, val_conf, label_csv=label_csv),
                            batch_size=8, num_workers=2)

    mode = model.at_mode.replace("tl_", "lw_")  # tl_tr_1_8 -> lw_tr_1_8
    gen = torch.Generator(device=model.device)
    gen.manual_seed(0)
    head = init_tltr(gen, label_dim=N_LABELS, n_layer=model.dims.n_audio_layer,
                     rep_dim=model.dims.n_audio_state, mode=mode)
    exp_dir = os.path.join(args.root, "exp")
    without_empty_classes(train, head, mode, loader, val_loader, exp_dir=exp_dir, lr=5e-3,
                          n_epochs=args.epochs, dataset="demo", compute_dtype=torch.float32,
                          n_print_steps=100, device=args.device)

    # 3. the checkpoint tail averaged and validated again
    averaged = wa_model(exp_dir, max(1, args.epochs - 1), args.epochs)
    stats, _ = without_empty_classes(validate, make_eval_step(mode, torch.float32),
                                     load_tltr(averaged, mode, args.device), val_loader)
    print(f"weight-averaged mAP over the 6 tone classes: "
          f"{mean_average_precision(stats[:6]):.4f}")

    # 4. the model with the averaged head, as a reference-layout file, read
    #    back with load_model
    state = model.state_dict()
    state.update({k: v.to(model.device) for k, v in at_head_state_dict(averaged).items()})
    model.load_state_dict(state)
    out = os.path.join(exp_dir, "whisper_at_trained.pt")
    torch.save({"dims": model.dims.__dict__,
                "model_state_dict": {k: v.cpu() for k, v in state.items()}}, out)
    reloaded = whisper.load_model(out, device=args.device, dtype=torch.float32)
    with open(data_json) as f:
        first = json.load(f)["data"][0]["wav"]
    same = torch.equal(clip_tags(reloaded, first), clip_tags(model, first))
    print(f"model with the trained head -> {out}; reloaded by load_model, tags of "
          f"{os.path.basename(first)} equal: {same}")


if __name__ == "__main__":
    main()
