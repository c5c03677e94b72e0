"""Sequence-parallel encoder: ring attention over an 'sp' mesh axis.

Counterpart of `whisper_at_tpu/parallel/sequence.py`. The encoder's 1500
positions split into S chunks, one a rank; everything position-wise (LNs,
the projections, the MLP on K2) runs on the rank's chunk. Attention runs as
ring attention: each rank keeps its queries, the K/V chunks hop around the
ring (isend / irecv, through host memory under gloo) and an online softmax
carried in fp32 (running max, denominator, numerator) folds each one in, so
no rank holds a whole attention row. The JAX package computes this outside
any Pallas kernel; here it is plain torch.matmul likewise.

The Whisper-AT taps pool 20 positions a window, and windows straddle chunk
edges wherever 20 does not divide T / S (375 at S = 4): each rank adds its
positions into per-window fp32 partial sums and one all_reduce over sp
completes every window.
"""

from typing import Optional, Tuple

import torch

from ..models.encoder import POOL, _stem, mlp_block
from .mesh import Mesh, all_gather, all_reduce_, as_mesh, init_distributed, replicate_params
from .mesh import ring_shift


def make_sp_mesh(n_shards: Optional[int] = None, device="cuda") -> Mesh:
    """A 1-D ('sp',) mesh over every rank of the process group (n_shards,
    when given, must be its size)."""
    import torch.distributed as dist

    init_distributed(device)
    n = dist.get_world_size()
    if n_shards is not None and n_shards != n:
        raise ValueError(f"n_shards={n_shards}, but the process group has {n} ranks")
    return Mesh({"sp": n}, device)


def place_encoder_sp(encoder, mesh: Mesh):
    """Rank 0's encoder weights on every shard, in place; returns it."""
    return replicate_params(as_mesh(mesh), encoder)


def _ring_attention(q, k, v, n_head: int, mesh: Mesh) -> torch.Tensor:
    """Non-causal attention of the local queries [B, C, D] over every
    rank's keys and values, the local K/V chunks passed around the ring.
    Logits, softmax state and the value product in fp32."""
    b, c, d = q.shape
    dh = d // n_head
    heads = lambda t: t.reshape(b, c, n_head, dh).transpose(1, 2)  # noqa: E731
    qh = heads(q).float()
    kh, vh = heads(k).contiguous(), heads(v).contiguous()
    m = torch.full((b, n_head, c, 1), float("-inf"), device=q.device)
    den = torch.zeros((b, n_head, c, 1), device=q.device)
    acc = torch.zeros((b, n_head, c, dh), device=q.device)
    n = mesh.size("sp")
    for step in range(n):
        logits = torch.matmul(qh, kh.float().transpose(-1, -2)) * dh ** -0.5
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        p = torch.exp(logits - m_new)
        alpha = torch.exp(m - m_new)
        den = den * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p, vh.float())
        m = m_new
        if step < n - 1:
            kh, vh = ring_shift(kh, mesh, "sp"), ring_shift(vh, mesh, "sp")
    return (acc / den).to(q.dtype).transpose(1, 2).reshape(b, c, d)


def encoder_apply_sp(encoder, mel: torch.Tensor, mesh: Mesh, n_head: int,
                     compute_dtype=torch.float32, mlp_impl: str = "fused"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`encoder_apply` with the sequence split over the mesh's 'sp' axis.
    mel [B, 80, 3000] on every rank; S must divide 1500. Returns (x
    [B, 1500, D] after ln_post, taps [B, L, 75, D]) on every rank, equal to
    the single-device encoder's up to the online softmax's rounding."""
    mesh = as_mesh(mesh)
    n, i = mesh.size("sp"), mesh.coord("sp")
    x = _stem(encoder, mel, compute_dtype)
    b, t, d = x.shape
    if t % n:
        raise ValueError(f"sequence length {t} not divisible by sp={n}")
    c = t // n
    x = x[:, i * c:(i + 1) * c].contiguous()
    window = (i * c + torch.arange(c, device=x.device)) // POOL
    partial = torch.zeros((b, len(encoder.blocks), t // POOL, d), device=x.device)
    for layer, block in enumerate(encoder.blocks):
        h = block.attn_ln(x)
        q, k, v = block.attn.query(h), block.attn.key(h), block.attn.value(h)
        x = x + block.attn.out(_ring_attention(q, k, v, n_head, mesh))
        x = mlp_block(block, x, mlp_impl)
        partial[:, layer].index_add_(1, window, x.float())
    taps = (all_reduce_(partial, mesh, "sp") / POOL).to(compute_dtype)
    full = torch.cat(all_gather(x, mesh, "sp"), dim=1)
    return encoder.ln_post(full), taps


__all__ = ["encoder_apply_sp", "make_sp_mesh", "place_encoder_sp"]
