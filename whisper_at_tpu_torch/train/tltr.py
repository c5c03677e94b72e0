"""The TL-TR research head in its nine modes, as an `nn.Module`.

Counterpart of `whisper_at_tpu/train/tltr.py`: input [B, n_layer, T,
rep_dim] encoder taps (T = 25 for the AudioSet features), output
[B, label_dim] clip logits. Modes: mean_mlp, last_mlp, wa_mlp, mean_tr_N,
last_tr_N, wa_tr_N, wa_down_tr_D_N, lw_tr_T_L and lw_down_tr_D_T_L (the
proposed TL-TR: a time transformer over each layer's frames, then a layer
transformer over the layers' means).

Parameter names: `mlp_ln`, `mlp` (the classifier), `layer_weight`,
`down_ln`, `down`, and the transformer blocks `time_tr` / `layer_tr` with
the reference checkpoints' block names (`attn.query.weight`, `mlp.0.weight`,
...). `convert.tltr_from_jax_params` / `tltr_to_jax_params` map them to the
JAX package's tree. The head's own layer norms (`mlp_ln`, `down_ln`) are
computed in the input dtype, as the JAX package's `_ln` is; the blocks'
in fp32, as its `residual_block` does.
"""

from typing import Optional, Tuple

import torch
from torch import nn

from ..models.layers import LayerNorm, Linear, ResidualAttentionBlock, linear, reset_random_


def parse_tltr_mode(mode: str) -> dict:
    cfg = {
        "mode": mode,
        "time_tr": False,
        "layer_tr": False,
        "layer_weight": False,
        "down": False,
        "inter_dim": None,
        "n_tatt_head": None,
        "n_latt_head": None,
    }
    parts = mode.split("_")
    if mode in ("mean_mlp", "last_mlp"):
        return cfg
    if mode == "wa_mlp":
        cfg["layer_weight"] = True
        return cfg
    if "lw_down_tr" in mode:
        cfg.update(time_tr=True, layer_tr=True, down=True, inter_dim=int(parts[-3]),
                   n_tatt_head=int(parts[-2]), n_latt_head=int(parts[-1]))
        return cfg
    if "lw_tr" in mode:
        cfg.update(time_tr=True, layer_tr=True, n_tatt_head=int(parts[-2]),
                   n_latt_head=int(parts[-1]))
        return cfg
    if "wa_down_tr" in mode:
        cfg.update(time_tr=True, layer_weight=True, down=True, inter_dim=int(parts[-2]),
                   n_tatt_head=int(parts[-1]))
        return cfg
    if "wa_tr" in mode:
        cfg.update(time_tr=True, layer_weight=True, n_tatt_head=int(parts[-1]))
        return cfg
    if "mean_tr" in mode or "last_tr" in mode:
        cfg.update(time_tr=True, n_tatt_head=int(parts[-1]))
        return cfg
    raise ValueError(f"Unsupported TLTR mode: {mode}")


class TLTR(nn.Module):
    """The head's parameters for one mode (see `parse_tltr_mode`)."""

    def __init__(self, label_dim: int = 527, n_layer: int = 33, rep_dim: int = 1280,
                 mode: str = "lw_tr_1_8", device=None, dtype=torch.float32):
        super().__init__()
        cfg = parse_tltr_mode(mode)
        self.mode = mode
        kw = dict(device=device, dtype=dtype)
        d = cfg["inter_dim"] if cfg["down"] else rep_dim
        self.mlp_ln = LayerNorm(d, **kw)
        self.mlp = Linear(d, label_dim, **kw)
        if cfg["layer_weight"]:
            self.layer_weight = nn.Parameter(torch.full((n_layer,), 1.0 / n_layer, **kw))
        if cfg["down"]:
            self.down_ln = LayerNorm(rep_dim, **kw)
            self.down = Linear(rep_dim, cfg["inter_dim"], **kw)
        if cfg["time_tr"]:
            self.time_tr = ResidualAttentionBlock(d, **kw)
        if cfg["layer_tr"]:
            self.layer_tr = ResidualAttentionBlock(d, **kw)

    def forward(self, audio_rep: torch.Tensor, mode: Optional[str] = None) -> torch.Tensor:
        return tltr_apply(self, audio_rep, mode or self.mode)


def init_tltr(gen: torch.Generator, label_dim: int = 527, n_layer: int = 33,
              rep_dim: int = 1280, mode: str = "lw_tr_1_8", dtype=torch.float32) -> TLTR:
    """A head on `gen`'s device, drawn from `gen`: linear weights and biases
    U(+-1/sqrt(in)), layer norms ones and zeros, layer weights 1/n_layer (the
    JAX package's `init_tltr` distributions, not its draws)."""
    model = TLTR(label_dim, n_layer, rep_dim, mode, device=gen.device, dtype=dtype)
    reset_random_(model, gen)
    return model


def _ln(ln: LayerNorm, x: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-5) * ln.weight + ln.bias


def _mlp_head(model: TLTR, x: torch.Tensor) -> torch.Tensor:
    return linear(_ln(model.mlp_ln, x), model.mlp.weight, model.mlp.bias)


def _weight_average(model: TLTR, x: torch.Tensor) -> torch.Tensor:
    # x [..., L] contracted against the layer weights, normalized by their sum
    w = model.layer_weight
    return torch.matmul(x, w) / w.sum()


def _down(model: TLTR, x: torch.Tensor) -> torch.Tensor:
    return linear(_ln(model.down_ln, x), model.down.weight, model.down.bias)


def tltr_apply(model: TLTR, audio_rep: torch.Tensor, mode: str) -> torch.Tensor:
    """audio_rep [B, L, T, D] -> [B, label_dim] clip logits."""
    cfg = parse_tltr_mode(mode)
    b, n_layer, t, d = audio_rep.shape

    if mode == "mean_mlp":
        return _mlp_head(model, audio_rep.mean(dim=1).mean(dim=1))
    if mode == "last_mlp":
        return _mlp_head(model, audio_rep[:, -1].mean(dim=1))
    if mode == "wa_mlp":
        x = audio_rep.mean(dim=2)                                  # [B, L, D]
        return _mlp_head(model, _weight_average(model, x.transpose(1, 2)))

    if cfg["layer_tr"]:  # lw_tr / lw_down_tr (the proposed TL-TR)
        x = _down(model, audio_rep) if cfg["down"] else audio_rep
        dd = x.shape[-1]
        x = model.time_tr(x.reshape(b * n_layer, t, dd), cfg["n_tatt_head"])
        x = model.layer_tr(x.mean(dim=1).reshape(b, n_layer, dd), cfg["n_latt_head"])
        return _mlp_head(model, x.mean(dim=1))

    # single-transformer baselines
    if "mean_tr" in mode:
        x = audio_rep.mean(dim=1)
    elif "last_tr" in mode:
        x = audio_rep[:, -1]
    else:  # wa_tr / wa_down_tr
        x = _weight_average(model, audio_rep.permute(0, 2, 3, 1))  # [B, T, D]
        if cfg["down"]:
            x = _down(model, x)
    x = model.time_tr(x, cfg["n_tatt_head"])
    return _mlp_head(model, x.mean(dim=1))


def count_parameters(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


# layer/dim lookup for feature sources (the reference run.py:125-129)
MODEL_SHAPES = {
    "whisper-tiny": (5, 384),
    "whisper-base": (7, 512),
    "whisper-small": (13, 768),
    "whisper-medium": (25, 1024),
    "whisper-large": (33, 1280),
    "whisper-large-v1": (33, 1280),
    "whisper-large-v2": (33, 1280),
    "w2v": (13, 768),
    "hubert": (25, 1024),
    "hubert-xl": (49, 1280),
}


def tltr_shape_for(model_name: str) -> Tuple[int, int]:
    """(n_layer, rep_dim) of the feature source named in run.py configs."""
    for key, shape in MODEL_SHAPES.items():
        if model_name.startswith(key):
            return shape
    raise ValueError(f"Unknown feature source: {model_name}")
