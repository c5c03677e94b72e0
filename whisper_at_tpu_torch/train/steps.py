"""Training and evaluation steps of the TL-TR head: losses, optimizer, step.

Counterpart of `whisper_at_tpu/train/steps.py`. The step computes as the
JAX one does: every fp32 parameter is cast to the compute dtype (bf16 on
the card) by a differentiable copy, the features too, the head runs on
those copies (`torch.func.functional_call`), the logits are widened to fp32
and the loss is taken in fp32; the fp32 masters receive the gradients. No
autocast: it would keep other ops in fp32 than the JAX step does.

The optimizer is the JAX chain add_decayed_weights(5e-7) -> scale_by_adam
(0.95, 0.999, 1e-8) -> lr, which is `torch.optim.Adam` with L2 weight
decay. The JAX step multiplies its update by a dynamic `lr_scale`; here
each step sets the group's lr to lr * lr_scale.

Signatures follow the stateful module: `make_optimizer` takes the head's
parameters, a step is `step(model, feats, labels, lr_scale) -> loss` (the
model and the optimizer are updated in place), an eval step is
`eval_step(model, feats) -> fp32 logits`.
"""

from typing import Callable, Optional

import torch
import torch.nn.functional as F


def bce_with_logits_loss(logits: torch.Tensor, targets: torch.Tensor,
                         pos_weight: Optional[float] = None) -> torch.Tensor:
    """torch BCEWithLogitsLoss semantics (mean reduction, optional pos_weight)."""
    log_p = F.logsigmoid(logits)
    log_not_p = F.logsigmoid(-logits)
    pw = 1.0 if pos_weight is None else pos_weight
    return (-(pw * targets * log_p + (1.0 - targets) * log_not_p)).mean()


def ce_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """torch CrossEntropyLoss with soft (probability) targets, mean reduction."""
    return -(targets * torch.log_softmax(logits, dim=-1)).sum(dim=-1).mean()


def make_optimizer(params, lr: float, weight_decay: float = 5e-7) -> torch.optim.Adam:
    """Adam(betas=(0.95, 0.999), eps=1e-8) with L2 weight decay added to the
    gradient before the moments, as the JAX chain orders it."""
    return torch.optim.Adam(params, lr=lr, betas=(0.95, 0.999), eps=1e-8,
                            weight_decay=weight_decay)


def _cast_params(model, compute_dtype) -> dict:
    return {name: p.to(compute_dtype) if p.dtype == torch.float32 else p
            for name, p in model.named_parameters()}


def _forward(model, feats: torch.Tensor, mode: str, compute_dtype) -> torch.Tensor:
    cast = _cast_params(model, compute_dtype)
    return torch.func.functional_call(model, cast, (feats.to(compute_dtype),),
                                      {"mode": mode}, strict=True).float()


def make_train_step(mode: str, optimizer: torch.optim.Optimizer, loss_type: str = "BCE",
                    pos_weight: Optional[float] = None,
                    compute_dtype=torch.bfloat16) -> Callable:
    """step(model, feats, labels, lr_scale) -> the loss (a device scalar,
    not synchronized); the model's parameters and `optimizer` advance one
    step. The forward runs in compute_dtype, loss and optimizer in fp32."""
    base_lrs = [g["lr"] for g in optimizer.param_groups]

    def loss_fn(model, feats, labels):
        logits = _forward(model, feats, mode, compute_dtype)
        if loss_type == "BCE":
            return bce_with_logits_loss(logits, labels, pos_weight)
        return ce_loss(logits, labels)

    def train_step(model, feats, labels, lr_scale: float = 1.0):
        for group, lr in zip(optimizer.param_groups, base_lrs):
            group["lr"] = lr * float(lr_scale)
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, feats, labels)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step


def make_eval_step(mode: str, compute_dtype=torch.bfloat16) -> Callable:
    """eval_step(model, feats) -> fp32 logits [B, label_dim]."""

    @torch.no_grad()
    def eval_step(model, feats):
        return _forward(model, feats, mode, compute_dtype)

    return eval_step


def make_sharded_train_step(*args, **kwargs):
    raise NotImplementedError(
        "the sharded (mesh) train step is not ported yet: ROADMAP module 18 "
        "(parallelism on torch.distributed)")
