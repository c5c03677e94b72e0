"""Pipeline-parallel encoder: the GPipe schedule over a 'pp' mesh axis.

Counterpart of `whisper_at_tpu/parallel/pipeline.py`. Stage s of P holds
blocks [s L/P, (s+1) L/P); M microbatches flow through the stages in
M + P - 1 ticks, stage s working on microbatch tick - s, so that every
stage computes a different microbatch at once (bubble (P-1)/(M+P-1)). The
activations [mb, 1500, D] move stage to stage by isend / irecv (through
host memory under gloo). A stage's blocks run on K1 and K2 on the card, as
`encoder_apply`'s do: each stage's activations are its own, whole tensors.

The conv stem and positional embedding are computed on every stage (a
fraction of one block). At the end the last stage's hidden states are
broadcast to every stage, and each stage's pooled taps of its own layers
are gathered, so every rank returns `encoder_apply`'s (x [B, 1500, D] after
ln_post, taps [B, L, 75, D]), from the same per-block arithmetic.
"""

from typing import Optional, Tuple

import torch

from ..models.encoder import POOL, _stem, run_blocks
from .mesh import Mesh, all_gather, as_mesh, broadcast_, init_distributed, recv, send
from .mesh import replicate_params


def make_pp_mesh(n_stages: Optional[int] = None, device="cuda") -> Mesh:
    """A 1-D ('pp',) mesh over every rank of the process group (n_stages,
    when given, must be its size)."""
    import torch.distributed as dist

    init_distributed(device)
    n = dist.get_world_size()
    if n_stages is not None and n_stages != n:
        raise ValueError(f"n_stages={n_stages}, but the process group has {n} ranks")
    return Mesh({"pp": n}, device)


def place_encoder_pp(encoder, mesh: Mesh):
    """Rank 0's encoder weights on every stage, in place; returns it."""
    return replicate_params(as_mesh(mesh), encoder)


def encoder_apply_pp(encoder, mel: torch.Tensor, mesh: Mesh, n_head: int,
                     compute_dtype=torch.float32, n_micro: Optional[int] = None,
                     attn_impl: str = "single", mlp_impl: str = "fused"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`encoder_apply` over the mesh's 'pp' stages. mel [B, 80, 3000] on
    every rank; n_micro microbatches (default B; must divide B); P must
    divide n_audio_layer. Returns (x [B, 1500, D], taps [B, L, 75, D]) on
    every rank."""
    mesh = as_mesh(mesh)
    n_stages, stage = mesh.size("pp"), mesh.coord("pp")
    n_layer = len(encoder.blocks)
    if n_layer % n_stages:
        raise ValueError(f"n_audio_layer={n_layer} not divisible by pp={n_stages}")
    per = n_layer // n_stages
    mine = list(encoder.blocks)[stage * per:(stage + 1) * per]
    x = _stem(encoder, mel, compute_dtype)
    b, t, d = x.shape
    n_micro = b if n_micro is None else n_micro
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by n_micro={n_micro}")
    mb = b // n_micro
    like = x[:mb]
    outs, taps, sends = [None] * n_micro, [None] * n_micro, []
    for tick in range(n_micro + n_stages - 1):
        m = tick - stage  # the microbatch this stage works on now
        if not 0 <= m < n_micro:
            continue  # a bubble
        h = x[m * mb:(m + 1) * mb] if stage == 0 else recv(like, mesh, "pp", stage - 1)
        pooled = []
        for h in run_blocks(mine, h, n_head, attn_impl, mlp_impl):
            pooled.append(h.reshape(mb, t // POOL, POOL, d).mean(dim=2))
        taps[m] = torch.stack(pooled, dim=1)  # [mb, L/P, T/20, D]
        if stage < n_stages - 1:
            sends.append(send(h, mesh, "pp", stage + 1))
        else:
            outs[m] = h
    for request, _ in sends:
        request.wait()
    # the last stage's hidden states to every stage; each stage's layers'
    # taps gathered along the layer axis
    out = torch.cat(outs) if stage == n_stages - 1 else torch.empty_like(x)
    broadcast_(out, mesh, "pp", src=n_stages - 1)
    all_taps = torch.cat(all_gather(torch.cat(taps), mesh, "pp"), dim=1)
    return encoder.ln_post(out), all_taps


__all__ = ["encoder_apply_pp", "make_pp_mesh", "place_encoder_pp"]
