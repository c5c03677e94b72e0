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

`make_sharded_train_step` is the JAX package's pjit step over a ('dp', 'tp')
mesh in SPMD form: each rank steps on its dp slice of the batch, the
gradients are averaged over dp (the whole batch's gradient, the slices being
equal), and the head's blocks are split over tp by `parallel.mesh`'s TL-TR
rules, Adam running on each rank's shard.
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
                    compute_dtype=torch.bfloat16, mesh=None) -> Callable:
    """step(model, feats, labels, lr_scale) -> the loss (a device scalar,
    not synchronized); the model's parameters and `optimizer` advance one
    step. The forward runs in compute_dtype, loss and optimizer in fp32.
    With a mesh, feats and labels are this rank's dp slice: the gradients
    and the returned loss are averaged over dp."""
    dp = mesh.size("dp") if mesh is not None else 1
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
        loss = loss.detach()
        if dp > 1:
            from ..parallel.mesh import all_reduce_

            for group in optimizer.param_groups:
                for p in group["params"]:
                    if p.grad is not None:
                        all_reduce_(p.grad, mesh, "dp").div_(dp)
            loss = all_reduce_(loss.clone(), mesh, "dp") / dp
        optimizer.step()
        return loss

    return train_step


def make_eval_step(mode: str, compute_dtype=torch.bfloat16) -> Callable:
    """eval_step(model, feats) -> fp32 logits [B, label_dim]."""

    @torch.no_grad()
    def eval_step(model, feats):
        return _forward(model, feats, mode, compute_dtype)

    return eval_step


def shard_tltr(model, mesh):
    """Split a TL-TR head's transformer blocks over the mesh's tp axis in
    place (`parallel.tensor.split_block`, the `parallel.mesh.tltr_split_dim`
    rules); the classifier, layer weights, down projection and LNs stay
    whole. Returns the model."""
    from ..parallel.tensor import TP, split_block

    tp = TP(mesh)
    for name in ("time_tr", "layer_tr"):
        block = getattr(model, name, None)
        if block is not None:
            split_block(block, tp)
    return model


def make_sharded_train_step(mesh, mode: str, model, lr: float, loss_type: str = "BCE",
                            pos_weight: Optional[float] = None,
                            compute_dtype=torch.bfloat16, weight_decay: float = 5e-7):
    """The train step over a ('dp', 'tp') mesh. Every rank's head becomes
    rank 0's, then its blocks split over tp (`shard_tltr`); Adam runs on the
    rank's shard. Returns (step, the sharded model, its optimizer); step
    takes this rank's dp slice (`parallel.mesh.shard_batch`) and returns
    the loss of the whole batch."""
    from ..parallel.mesh import as_mesh, replicate_params

    mesh = as_mesh(mesh)
    replicate_params(mesh, model)
    shard_tltr(model, mesh)
    optimizer = make_optimizer(model.parameters(), lr, weight_decay)
    step = make_train_step(mode, optimizer, loss_type, pos_weight, compute_dtype, mesh=mesh)
    return step, model, optimizer
