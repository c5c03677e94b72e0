"""Tensor parallelism: the Megatron column / row split of a linear layer and
the collectives between them.

The JAX package states the split as PartitionSpecs and lets GSPMD insert
one psum after each row-split product. Here each rank holds its slice:

  ColumnLinear  rows `rank` of `size` of the weight ([out/tp, in]) and of
                the bias: the query, key, value and fc1 projections. Its
                output is this rank's heads (or hidden units).
  RowLinear     columns `rank` of `size` of the weight ([out, in/tp]):
                the attention out and fc2 projections. Each rank's product
                is a partial sum; one all_reduce over tp adds them, then the
                whole bias is added once. It keeps the whole weight's
                per-output-channel amax, so int8 / int4 quantization of the
                slice gives the whole weight's scales and codes.

For training the collectives are differentiable with Megatron's pair: the
row split's all_reduce passes the gradient through unchanged, and a column
split's input is copied in the forward and all-reduced in the backward (the
input gradient is the sum of every rank's columns). So every rank's
gradient is that of the one global loss. (`torch.distributed.nn.functional.
all_reduce` also all-reduces in its backward, which would scale the
gradients of everything before a row split by tp.)
"""

from typing import Optional

import torch
from torch import nn

from ..models.layers import Linear, QuantLinear, QuantLinear4, attention, quantize_weight
from .mesh import Mesh, all_gather, all_reduce_, split_rows


class TP:
    """The tensor-parallel axis of a mesh as the layers see it."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.size = mesh.size("tp")
        self.rank = mesh.coord("tp")

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        return all_reduce_(t, self.mesh, "tp")


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return tp.all_reduce_(x.contiguous().clone())

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.tp.all_reduce_(grad.contiguous().clone()), None


class _GatherColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp, ctx.n = tp, x.shape[-1]
        return torch.cat(all_gather(x, tp.mesh, "tp"), dim=-1)

    @staticmethod
    def backward(ctx, grad):
        full = ctx.tp.all_reduce_(grad.contiguous().clone())
        return full.narrow(-1, ctx.tp.rank * ctx.n, ctx.n), None


def _needs_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def reduce_from_tp(x: torch.Tensor, tp: TP) -> torch.Tensor:
    """The sum of every tp rank's `x` (a fresh product: reduced in place
    when no gradient is taken)."""
    if _needs_grad(x):
        return _ReduceFromTP.apply(x, tp)
    return tp.all_reduce_(x.contiguous())


def copy_to_tp(x: torch.Tensor, tp: TP) -> torch.Tensor:
    """`x` as the input of a column split (all-reduced in the backward)."""
    return _CopyToTP.apply(x, tp) if _needs_grad(x) else x


def gather_columns(x: torch.Tensor, tp: TP) -> torch.Tensor:
    """Every tp rank's columns of `x`, concatenated along the last axis."""
    return _GatherColumns.apply(x, tp)


def _param(t: torch.Tensor, like: nn.Parameter) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=like.requires_grad)


class ColumnLinear(Linear):
    """Rows `tp.rank` of `tp.size` of `lin` (see the module docstring)."""

    def __init__(self, lin: Linear, tp: TP):
        nn.Module.__init__(self)
        self.weight = _param(split_rows(lin.weight.data, 0, tp.size, tp.rank), lin.weight)
        self.bias = (None if lin.bias is None else
                     _param(split_rows(lin.bias.data, 0, tp.size, tp.rank), lin.bias))
        self.tp = tp

    def forward(self, x):
        return super().forward(copy_to_tp(x, self.tp))

    def attend(self, q, k, v, n_head: int, mask: Optional[torch.Tensor] = None):
        """Attention over this rank's columns of q, k and v (of n_head heads
        in all): its own n_head / tp heads where they divide, else the whole
        attention over the gathered columns, of which it keeps its own."""
        if n_head % self.tp.size == 0:
            return attention(q, k, v, n_head // self.tp.size, mask=mask)
        full = attention(gather_columns(q, self.tp), gather_columns(k, self.tp),
                         gather_columns(v, self.tp), n_head, mask=mask)
        n = q.shape[-1]
        return full.narrow(-1, self.tp.rank * n, n)


class RowLinear(Linear):
    """Columns `tp.rank` of `tp.size` of `lin`, the partial products summed
    over tp, the whole bias added once (see the module docstring)."""

    def __init__(self, lin: Linear, tp: TP):
        nn.Module.__init__(self)
        self.weight = _param(split_rows(lin.weight.data, 1, tp.size, tp.rank), lin.weight)
        self.bias = None if lin.bias is None else _param(lin.bias.data.clone(), lin.bias)
        # the whole weight's per-output-channel amax (not a buffer: it is no
        # state of the checkpoint)
        self.amax = lin.weight.detach().float().abs().amax(dim=1)
        self.tp = tp

    def partial(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's share of the product, no bias."""
        return torch.matmul(x, self.weight.to(x.dtype).t())

    def forward(self, x):
        y = reduce_from_tp(self.partial(x), self.tp)
        return y if self.bias is None else y + self.bias.to(x.dtype)

    def quantized(self, bits: int = 8) -> "RowParallel":
        """int8 (bits 8) or packed int4 (bits 4) codes of the slice with the
        whole weight's scales: the whole quantized weight's columns."""
        codes, scale = quantize_weight(self.weight, bits, amax=self.amax)
        inner = (QuantLinear4 if bits == 4 else QuantLinear)(codes, scale, None)
        return RowParallel(inner, self.bias, self.tp)


class RowParallel(nn.Module):
    """A quantized row split: `inner` (no bias) on this rank's input
    columns, summed over tp, then the bias."""

    def __init__(self, inner: nn.Module, bias: Optional[torch.Tensor], tp: TP):
        super().__init__()
        self.inner = inner
        self.bias = bias
        self.tp = tp

    def forward(self, x):
        y = reduce_from_tp(self.inner(x), self.tp)
        return y if self.bias is None else y + self.bias.to(x.dtype)


_COLUMN_NAMES = ("query", "key", "value")


def split_block(block: nn.Module, tp: TP) -> None:
    """The Megatron split of one transformer block, in place: self and
    cross q / k / v and fc1 by columns of the output, attention out and fc2
    by rows of the input; LNs stay whole."""
    for attn in (block.attn, getattr(block, "cross_attn", None)):
        if attn is None:
            continue
        for name in _COLUMN_NAMES:
            setattr(attn, name, ColumnLinear(getattr(attn, name), tp))
        attn.out = RowLinear(attn.out, tp)
    block.mlp[0] = ColumnLinear(block.mlp[0], tp)
    block.mlp[2] = RowLinear(block.mlp[2], tp)


def gather_head_logits(qk: torch.Tensor, head_mask, tp: TP) -> torch.Tensor:
    """Per-head logits [B, n_sel, S, F] of the heads `head_mask` (bool
    [L, H], every head of every rank) selects, from each rank's own
    selection among its H / tp heads, in (layer, head) order."""
    mask = torch.as_tensor(head_mask, dtype=torch.bool)
    hl = mask.shape[1] // tp.size
    picks = [torch.nonzero(mask[:, r * hl:(r + 1) * hl]).tolist() for r in range(tp.size)]
    most = max(len(p) for p in picks)
    pad = qk.new_zeros((qk.shape[0], most - qk.shape[1]) + tuple(qk.shape[2:]))
    parts = all_gather(torch.cat([qk, pad], dim=1), tp.mesh, "tp")
    rows = sorted(((layer, r * hl + head), part[:, i])
                  for r, (pick, part) in enumerate(zip(picks, parts))
                  for i, (layer, head) in enumerate(pick))
    return torch.stack([row for _, row in rows], dim=1)


__all__ = [
    "ColumnLinear", "RowLinear", "RowParallel", "TP", "copy_to_tp", "gather_columns",
    "gather_head_logits", "reduce_from_tp", "split_block",
]
