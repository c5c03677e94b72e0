"""TL-TR audio-tagging head (the Whisper-AT component).

Counterpart of `whisper_at_tpu/models/at_head.py`: a transformer over the
time axis of each decision window (mean-pooled), then one over the layer
axis (mean-pooled), then LN + Linear to the 527 AudioSet classes. The
low-compute modes first project the taps to a narrower width in fp32.
Module names follow the released head checkpoints (`at_model.time_tr.*`,
`at_model.mlp_layer.{0,1}.*`, `at_model.down_layer.{0,1}.*`).
"""

import math
from typing import Tuple

import torch
from torch import nn

from .layers import LayerNorm, Linear, ResidualAttentionBlock, layer_norm, linear

LABEL_DIM = 527


def parse_mode(mode: str) -> dict:
    """Structure of a head mode string, e.g. 'tl_tr_1_8' or 'tl_down_tr_512_1_8'."""
    parts = mode.split("_")
    if "tl_down_tr" in mode:
        return {"down": True, "inter_dim": int(parts[-3]),
                "n_tatt_head": int(parts[-2]), "n_latt_head": int(parts[-1])}
    if "tl_tr" in mode:
        return {"down": False, "inter_dim": None,
                "n_tatt_head": int(parts[-2]), "n_latt_head": int(parts[-1])}
    raise ValueError(f"Unsupported ATModel mode: {mode}")


class ATHead(nn.Module):
    def __init__(self, rep_dim: int, mode: str,
                 label_dim: int = LABEL_DIM, device=None, dtype=torch.float32):
        super().__init__()
        cfg = parse_mode(mode)
        kw = dict(device=device, dtype=dtype)
        d = cfg["inter_dim"] if cfg["down"] else rep_dim
        self.mode = mode
        self.time_tr = ResidualAttentionBlock(d, **kw)
        self.layer_tr = ResidualAttentionBlock(d, **kw)
        self.mlp_layer = nn.Sequential(LayerNorm(d, **kw), Linear(d, label_dim, **kw))
        self.down_layer = (nn.Sequential(LayerNorm(rep_dim, **kw),
                                         Linear(rep_dim, cfg["inter_dim"], **kw))
                           if cfg["down"] else None)


def at_head_apply(head: ATHead, audio_rep: torch.Tensor, decision_window: int,
                  n_seg: int) -> torch.Tensor:
    """audio_rep [B, L, T, D] -> logits [B, n_seg, 527]. T is zero-padded
    (or trimmed) to n_seg * decision_window."""
    cfg = parse_mode(head.mode)
    b, n_layer, t, d = audio_rep.shape
    target = n_seg * decision_window
    if t < target:
        audio_rep = torch.cat(
            [audio_rep, audio_rep.new_zeros(b, n_layer, target - t, d)], dim=2)
    else:
        audio_rep = audio_rep[:, :, :target]
    x = audio_rep.reshape(b, n_layer, n_seg, decision_window, d).transpose(1, 2)
    x = x.reshape(b * n_seg * n_layer, decision_window, d)
    if cfg["down"]:
        ln, proj = head.down_layer[0], head.down_layer[1]
        x = linear(layer_norm(x.float(), ln.weight, ln.bias), proj.weight, proj.bias)
        d = x.shape[-1]
    x = head.time_tr(x, cfg["n_tatt_head"]).mean(dim=1)
    x = x.reshape(b * n_seg, n_layer, d)
    x = head.layer_tr(x, cfg["n_latt_head"]).mean(dim=1)
    ln, proj = head.mlp_layer[0], head.mlp_layer[1]
    logits = linear(layer_norm(x.float(), ln.weight, ln.bias), proj.weight, proj.bias)
    return logits.reshape(b, n_seg, -1)


def at_window_geometry(audio_len: int, time_resolution: float) -> Tuple[int, int]:
    """(decision_window, n_seg) in pooled frames: 2.5 pooled frames per second
    (100 mel frames/s, conv stride 2, pooling 20)."""
    window = int(time_resolution * 2.5)
    return window, math.ceil(audio_len / window)
