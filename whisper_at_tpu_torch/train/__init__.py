"""Training stack of the TL-TR head (counterpart of `whisper_at_tpu/train`):
the head in its nine modes, its steps, metrics, feature loader, loops and
the `python -m whisper_at_tpu_torch.train.run` entry point."""

from .dataloader import DataLoader, FeatureDataset, balanced_sample_weights, gen_weight_file
from .loop import AverageMeter, train, validate, wa_model
from .stats import calculate_stats, d_prime, mean_auc, mean_average_precision
from .steps import (
    bce_with_logits_loss,
    ce_loss,
    make_eval_step,
    make_optimizer,
    make_sharded_train_step,
    make_train_step,
)
from .tltr import count_parameters, init_tltr, parse_tltr_mode, tltr_apply, tltr_shape_for

__all__ = [
    "DataLoader", "FeatureDataset", "balanced_sample_weights", "gen_weight_file",
    "AverageMeter", "train", "validate", "wa_model",
    "calculate_stats", "d_prime", "mean_auc", "mean_average_precision",
    "bce_with_logits_loss", "ce_loss", "make_eval_step", "make_optimizer",
    "make_sharded_train_step", "make_train_step",
    "count_parameters", "init_tltr", "parse_tltr_mode", "tltr_apply",
    "tltr_shape_for",
]
