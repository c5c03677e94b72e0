"""TL-TR head training trajectory on the PyTorch/CUDA port
(`examples/train_trajectory.py` in the port's API): the offline analogue
of the reference's released training logs (src/whisper_at_train/log/*.txt).

There is no AudioSet audio here, so the trajectory is shown on a synthetic
multi-label sound-event corpus with six acoustically distinct classes
(tone / chirp / noise burst / AM tone / click train / harmonic stack),
through the real pipeline:

  wavs -> research.feature_extract (all-layer pooled features)
       -> train.FeatureDataset / DataLoader (mixup, SpecAug, label smoothing)
       -> train.train (per-epoch checkpoints, result.csv)
       -> the per-epoch eval mAP trajectory (must rise)
       -> train.wa_model weight averaging (reference run.py:258-300)

Run:  python examples/train_trajectory_torch.py [--epochs 8] [--root DIR]
      [--device cpu]
`--mesh-dp N` trains over a ('dp', 'tp') mesh of N ranks
(`parallel.mesh`): started by torchrun (or `python -m torch.distributed.run
--nproc-per-node N`) it joins that group; started alone it writes the corpus
and the features, then starts N ranks of itself on this host (NCCL over the
cards, gloo with --device cpu), which train; rank 0 prints.
"""

import argparse
import csv
import json
import os
import socket
import subprocess
import sys
import tempfile
import wave

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import whisper_at_tpu_torch as whisper  # noqa: E402
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

SR = 16000
CLASSES = ["tone", "chirp", "noise_burst", "am_tone", "click_train",
           "harmonics"]


def _event(cls: int, dur_s: float, rng) -> np.ndarray:
    """One synthetic sound event of class `cls`."""
    n = int(SR * dur_s)
    t = np.arange(n) / SR
    if cls == 0:  # steady tone
        f = rng.uniform(300, 500)
        x = np.sin(2 * np.pi * f * t)
    elif cls == 1:  # rising chirp
        f0, f1 = rng.uniform(150, 250), rng.uniform(1500, 2500)
        x = np.sin(2 * np.pi * (f0 * t + (f1 - f0) / (2 * dur_s) * t * t))
    elif cls == 2:  # white noise burst
        x = rng.standard_normal(n)
    elif cls == 3:  # amplitude-modulated tone (tremolo)
        f = rng.uniform(600, 900)
        x = np.sin(2 * np.pi * f * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 6 * t))
    elif cls == 4:  # click train
        x = np.zeros(n)
        period = int(SR / rng.uniform(8, 14))
        x[::period] = 1.0
        x = np.convolve(x, np.hanning(64), mode="same")
    else:  # harmonic stack
        f = rng.uniform(180, 260)
        x = sum(np.sin(2 * np.pi * f * k * t) / k for k in range(1, 6))
    return (x / (np.abs(x).max() + 1e-9)).astype(np.float32)


def make_corpus(root: str, n_train: int, n_eval: int, seed: int = 0):
    """Multi-label clips: 1-2 events at random offsets over light noise."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "audio"), exist_ok=True)

    def one_split(name, n_clips, start_idx):
        data = []
        for i in range(n_clips):
            n = SR * 10
            x = 0.01 * rng.standard_normal(n).astype(np.float32)
            k_events = int(rng.integers(1, 3))
            labels = sorted(
                rng.choice(len(CLASSES), size=k_events, replace=False).tolist()
            )
            for cls in labels:
                dur = rng.uniform(2.0, 5.0)
                ev = _event(cls, dur, rng) * rng.uniform(0.25, 0.5)
                off = int(rng.integers(0, n - len(ev)))
                x[off:off + len(ev)] += ev
            path = os.path.join(root, "audio", f"{name}{start_idx + i}.wav")
            with wave.open(path, "wb") as wf:
                wf.setnchannels(1)
                wf.setsampwidth(2)
                wf.setframerate(SR)
                wf.writeframes(
                    (np.clip(x, -1, 1) * 32767).astype(np.int16).tobytes()
                )
            data.append({
                "wav": path,
                "labels": ",".join(f"/m/{c:03d}" for c in labels),
            })
        out = os.path.join(root, f"{name}.json")
        with open(out, "w") as f:
            json.dump({"data": data}, f)
        return out

    train_json = one_split("train", n_train, 0)
    eval_json = one_split("eval", n_eval, n_train)
    label_csv = os.path.join(root, "labels.csv")
    with open(label_csv, "w") as f:
        f.write("index,mid,display_name\n")
        for c, name in enumerate(CLASSES):
            f.write(f'{c},/m/{c:03d},"{name}"\n')
    return train_json, eval_json, label_csv


def split_paths(root: str):
    return (os.path.join(root, "train.json"), os.path.join(root, "eval.json"),
            os.path.join(root, "labels.csv"), os.path.join(root, "feat_as"))


def prepare(args) -> None:
    """The corpus and its all-layer pooled features under args.root."""
    print(f"=== corpus: {args.n_train} train / {args.n_eval} eval clips, "
          f"{len(CLASSES)} classes, multi-label ===")
    train_json, eval_json, _, feat_dir = split_paths(args.root)
    make_corpus(args.root, args.n_train, args.n_eval)
    # frozen backbone: random weights here (nothing is downloaded); with a
    # real checkpoint use whisper.load_model(args.model)
    model = whisper.build_model(args.model, device=args.device)
    n_written = len(extract_feature_set(model, train_json, feat_dir, n_frames=1000))
    n_written += len(extract_feature_set(model, eval_json, feat_dir, n_frames=1000))
    print(f"extracted {n_written} all-layer pooled feature files")


def start_ranks(n: int, root: str) -> int:
    """This script again as n ranks of one process group on this host, all
    over `root`; returns the first non-zero exit code, else 0."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(n):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(n),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__)]
                                      + sys.argv[1:] + ["--root", root], env=env))
    codes = [p.wait() for p in procs]
    return next((c for c in codes if c), 0)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=None,
                        help="working directory (default: a new one under the "
                             "temporary directory)")
    parser.add_argument("--model", default="tiny", help="feature-source size")
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--n-train", type=int, default=96)
    parser.add_argument("--n-eval", type=int, default=32)
    # 2e-4 learns cleanly on this corpus; 1e-3 and above oscillate around
    # chance (a 6-class head sees only ~8 steps an epoch here)
    parser.add_argument("--lr", type=float, default=2e-4)
    parser.add_argument("--mesh-dp", type=int, default=0,
                        help="train the head over an N-rank ('dp', 'tp') mesh "
                             "(parallel.mesh); started alone, the script starts "
                             "the N ranks itself")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args()

    is_rank = "RANK" in os.environ
    lead = not is_rank or os.environ["RANK"] == "0"
    if is_rank and args.root is None:
        parser.error("the ranks of a process group need --root DIR, their shared directory")
    args.root = args.root or tempfile.mkdtemp(prefix="wat_trajectory_torch_")
    train_json, eval_json, label_csv, feat_dir = split_paths(args.root)
    mesh = None
    if is_rank:
        if not args.mesh_dp:
            parser.error("a rank of a process group needs --mesh-dp N")
        from whisper_at_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(n_devices=args.mesh_dp, tp=1, device=args.device)
        if lead and not os.path.exists(eval_json):
            prepare(args)
        torch.distributed.barrier()
        if lead:
            print(f"=== sharded training over mesh {mesh.shape} ===")
    else:
        prepare(args)
        if args.mesh_dp:
            raise SystemExit(start_ranks(args.mesh_dp, args.root))
    with np.load(os.path.join(feat_dir, sorted(os.listdir(feat_dir))[0])) as f:
        n_layer, _, rep_dim = f["arr_0"].shape  # the backbone's layers and width

    conf = {"freqm": 0, "timem": 3, "mixup": 0.3, "dataset": "demo",
            "label_smooth": 0.05, "tar_path": feat_dir}
    # sharded batches must divide by dp; 16 works for dp in {1, 2, 4, 8}
    train_bs = 16 if args.mesh_dp else 12
    loader = DataLoader(FeatureDataset(train_json, conf, label_csv=label_csv),
                        batch_size=train_bs, shuffle=True, num_workers=2)
    val_conf = dict(conf, timem=0, mixup=0, label_smooth=0.0)
    val_loader = DataLoader(FeatureDataset(eval_json, val_conf, label_csv=label_csv),
                            batch_size=16, num_workers=2)

    mode = "lw_tr_1_8"
    gen = torch.Generator(device=whisper.resolve_device(args.device))
    gen.manual_seed(0)
    head = init_tltr(gen, label_dim=len(CLASSES), n_layer=n_layer, rep_dim=rep_dim, mode=mode)
    exp_dir = os.path.join(args.root, "exp")
    train(head, mode, loader, val_loader, exp_dir=exp_dir, lr=args.lr, n_epochs=args.epochs,
          dataset="demo", compute_dtype=torch.float32, n_print_steps=1000, mesh=mesh,
          device=args.device)
    if not lead:
        return

    # the trajectory (the reference logs' analogue): result.csv an epoch
    with open(os.path.join(exp_dir, "result.csv")) as f:
        rows = [r for r in csv.reader(f) if r]
    maps = [float(r[1]) for r in rows]  # columns: acc, mAP, mAUC, lr
    print("\nepoch  eval mAP")
    for e, m in enumerate(maps, 1):
        print(f"{e:5d}  {m:.4f}")
    assert maps[-1] > maps[0], "trajectory did not improve"
    print(f"\nfinal-epoch mAP {maps[-1]:.4f} "
          f"(chance ~{1.5 / len(CLASSES):.2f}; epoch-1 {maps[0]:.4f})")

    # weight averaging over the checkpoint tail (run.py's wa)
    start = max(1, args.epochs // 2)
    averaged = wa_model(exp_dir, start, args.epochs)
    stats, _ = validate(make_eval_step(mode, torch.float32),
                        load_tltr(averaged, mode, args.device), val_loader)
    wa_map = mean_average_precision(stats)
    print(f"wa_model(epochs {start}-{args.epochs}) mAP {wa_map:.4f} "
          f"vs final epoch {maps[-1]:.4f}"
          + ("  <- averaging helped" if wa_map >= maps[-1] else ""))


if __name__ == "__main__":
    main()
