"""Training entry point of the TL-TR head:

    python -m whisper_at_tpu_torch.train.run --device cuda --data-train ... \
        --data-val ... --label-csv ... --tar_path_train ... --tar_path_val ... \
        --exp-dir ... --model whisper-high-lw_tr_1_8 --model_size large-v1

Counterpart of `whisper_at_tpu/train/run.py`, with the same arguments plus
`--device` (the card unless "cpu"; without a card "cuda" raises): datasets
and loaders (optional balanced sampling), a head of the mode's shape drawn
from `torch.Generator(seed)`, an optional partial load of a pretrained head
in the JAX package's `.npz` layout (classifier rows past the file's
expanded, as for SONYC), training, then optional checkpoint weight
averaging and its validation (`wa_res.csv`).
"""

import argparse
import os
import pickle

import numpy as np
import torch

from ..checkpoint import load_params
from ..convert import tltr_from_jax_params, tltr_to_jax_params
from ..utils import resolve_device
from .dataloader import DataLoader, FeatureDataset, balanced_sample_weights
from .loop import load_tltr, train, validate, wa_model
from .stats import mean_average_precision
from .steps import make_eval_step
from .tltr import init_tltr, tltr_shape_for


def get_parser() -> argparse.ArgumentParser:
    # fmt: off
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--data-train", type=str, help="training data json")
    parser.add_argument("--data-val", type=str, help="validation data json")
    parser.add_argument("--data-eval", type=str, default=None, help="evaluation data json")
    parser.add_argument("--label-csv", type=str, help="csv with class labels")
    parser.add_argument("--n_class", type=int, default=527, help="number of classes")
    parser.add_argument("--model", type=str, default="whisper-high-lw_tr_1_8", help="model: whisper-high-<tltr mode>")
    parser.add_argument("--model_size", type=str, default="large-v1", help="feature source size (tiny..large-v2)")
    parser.add_argument("--dataset", type=str, default="as-full", help="dataset name (as-full enables 10%%-epoch break)")
    parser.add_argument("--dataset_mean", type=float, default=0, help="dataset mean (unused for features)")
    parser.add_argument("--dataset_std", type=float, default=0, help="dataset std (unused for features)")
    parser.add_argument("--tar_path_train", type=str, help="precomputed train feature dir")
    parser.add_argument("--tar_path_val", type=str, help="precomputed val feature dir")
    parser.add_argument("--tar_path_eval", type=str, default=None, help="precomputed eval feature dir")
    parser.add_argument("--exp-dir", type=str, default="", help="experiment directory")
    parser.add_argument("--lr", "--learning-rate", type=float, default=5e-5, dest="lr")
    parser.add_argument("--head_lr", type=float, default=1.0, help="lr multiplier for the classifier head")
    parser.add_argument("--optim", type=str, default="adam", help="optimizer")
    parser.add_argument("-b", "--batch-size", type=int, default=48)
    parser.add_argument("-w", "--num-workers", type=int, default=8)
    parser.add_argument("--n-epochs", type=int, default=30)
    parser.add_argument("--lr_patience", type=int, default=2, help="epochs of plateau before lr halving (adaptive)")
    parser.add_argument("--lr_adapt", type=lambda s: s == "True", default=False, help="use ReduceLROnPlateau")
    parser.add_argument("--lrscheduler_start", type=int, default=15)
    parser.add_argument("--lrscheduler_step", type=int, default=5)
    parser.add_argument("--lrscheduler_decay", type=float, default=0.75)
    parser.add_argument("--n-print-steps", type=int, default=100)
    parser.add_argument("--save_model", type=lambda s: s == "True", default=True)
    parser.add_argument("--freqm", type=int, default=0, help="frequency mask max width")
    parser.add_argument("--timem", type=int, default=0, help="time mask max width")
    parser.add_argument("--mixup", type=float, default=0, help="mixup rate")
    parser.add_argument("--bal", type=str, default="none", help="'bal' enables balanced sampling")
    parser.add_argument("--weight_file", type=str, default=None, help="suffix of the sample-weight csv")
    parser.add_argument("--label_smooth", type=float, default=0.0)
    parser.add_argument("--metrics", type=str, default="mAP", choices=["mAP", "acc"])
    parser.add_argument("--loss", type=str, default="BCE", choices=["BCE", "CE"])
    parser.add_argument("--wa", type=lambda s: s == "True", default=False, help="weight averaging")
    parser.add_argument("--wa_start", type=int, default=16)
    parser.add_argument("--wa_end", type=int, default=30)
    parser.add_argument("--pretrained_model", type=str, default=None, help="pretrained head checkpoint (.npz)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--resume", type=lambda s: s == "True", default=False,
                        help="resume from the last saved epoch in exp-dir")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (the card) or cpu")
    # fmt: on
    return parser


def load_pretrained_head(params: dict, pretrained_path: str, n_class: int) -> dict:
    """Partial load of a pretrained head into `params` (JAX-layout trees):
    leaves of the same shape are taken from the file; past 527 classes the
    classifier's first rows are the file's and the rest are drawn from its
    weights' distribution (run.py:142-188, SONYC)."""
    _, pre = load_params(pretrained_path)

    def merge(dst, src):
        out = {}
        for key, val in dst.items():
            if key not in src:
                out[key] = val
            elif isinstance(val, dict):
                out[key] = merge(val, src[key])
            elif np.asarray(src[key]).shape == np.asarray(val).shape:
                out[key] = np.asarray(src[key])
            else:
                out[key] = val
        return out

    params = merge(params, pre)

    # classifier expansion: copy the first rows, init the rest from the
    # pretrained distribution
    if "mlp" in pre and np.asarray(pre["mlp"]["w"]).shape[1] < n_class:
        old_w = np.asarray(pre["mlp"]["w"])  # [d, 527]
        old_b = np.asarray(pre["mlp"]["b"])
        new_w = np.asarray(params["mlp"]["w"]).copy()
        new_b = np.asarray(params["mlp"]["b"]).copy()
        new_w[:, : old_w.shape[1]] = old_w
        new_b[: old_b.shape[0]] = old_b
        rng = np.random.default_rng(0)
        extra = n_class - old_w.shape[1]
        new_w[:, old_w.shape[1]:] = rng.normal(old_w.mean(), old_w.std(),
                                               size=(old_w.shape[0], extra))
        new_b[old_b.shape[0]:] = rng.normal(old_b.mean(), old_b.std(), size=extra)
        params["mlp"] = {"w": new_w.astype(np.float32), "b": new_b.astype(np.float32)}
    return params


def main(argv=None):
    args = get_parser().parse_args(argv)
    dev = resolve_device(args.device)

    assert args.model.startswith("whisper-high-"), "model must be whisper-high-<mode>"
    mode = args.model.split("-")[-1]
    n_layer, rep_dim = tltr_shape_for(f"whisper-{args.model_size}")

    audio_conf = {
        "freqm": args.freqm, "timem": args.timem, "mixup": args.mixup,
        "dataset": args.dataset, "label_smooth": args.label_smooth,
        "tar_path": args.tar_path_train,
    }
    val_audio_conf = {
        "freqm": 0, "timem": 0, "mixup": 0, "dataset": args.dataset,
        "tar_path": args.tar_path_val,
    }

    sampler_weights = None
    if args.bal == "bal":
        print("balanced sampler is being used")
        suffix = "_weight" if args.weight_file is None else f"_{args.weight_file}"
        weight_path = args.data_train[:-5] + suffix + ".csv"
        if not os.path.exists(weight_path):
            sampler_weights = balanced_sample_weights(args.data_train, args.label_csv)
        else:
            sampler_weights = np.loadtxt(weight_path, delimiter=",")
    else:
        print("balanced sampler is not used")

    train_loader = DataLoader(
        FeatureDataset(args.data_train, audio_conf, args.label_csv),
        batch_size=args.batch_size,
        shuffle=sampler_weights is None,
        sampler_weights=sampler_weights,
        num_workers=args.num_workers,
        seed=args.seed,
    )
    val_loader = DataLoader(
        FeatureDataset(args.data_val, val_audio_conf, args.label_csv),
        batch_size=args.batch_size,
        shuffle=False,
        num_workers=args.num_workers,
        drop_last=True,
    )

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    model = init_tltr(gen, label_dim=args.n_class, n_layer=n_layer, rep_dim=rep_dim,
                      mode=mode)
    if args.pretrained_model is not None and os.path.exists(args.pretrained_model):
        print(f"Loading pretrained model from {args.pretrained_model}")
        tree = load_pretrained_head(tltr_to_jax_params(model.state_dict()),
                                    args.pretrained_model, args.n_class)
        model.load_state_dict(tltr_from_jax_params(tree, list(model.state_dict())))

    os.makedirs(os.path.join(args.exp_dir, "models"), exist_ok=True)
    with open(os.path.join(args.exp_dir, "args.pkl"), "wb") as f:
        pickle.dump(vars(args), f)

    pos_weight = 3.0 if args.n_class > 527 else None

    model = train(
        model, mode, train_loader, val_loader,
        exp_dir=args.exp_dir,
        lr=args.lr,
        n_epochs=args.n_epochs,
        loss_type=args.loss,
        pos_weight=pos_weight,
        metrics_name=args.metrics,
        lr_adapt=args.lr_adapt,
        lr_patience=args.lr_patience,
        lrscheduler_start=args.lrscheduler_start,
        lrscheduler_step=args.lrscheduler_step,
        lrscheduler_decay=args.lrscheduler_decay,
        dataset=args.dataset,
        save_model=args.save_model,
        n_print_steps=args.n_print_steps,
        n_class_sonyc=args.n_class if args.n_class > 527 else None,
        resume=args.resume,
        device=dev,
    )

    if args.wa:
        averaged = wa_model(args.exp_dir, args.wa_start, args.wa_end)
        stats, _ = validate(make_eval_step(mode), load_tltr(averaged, mode, dev), val_loader)
        wa_res = mean_average_precision(stats)
        print("val mAP of model with weights averaged from checkpoint "
              "{:d}-{:d} is {:.4f}".format(args.wa_start, args.wa_end, wa_res))
        np.savetxt(os.path.join(args.exp_dir, "wa_res.csv"),
                   [args.wa_start, args.wa_end, wa_res], delimiter=",")
    return model


if __name__ == "__main__":
    main()
