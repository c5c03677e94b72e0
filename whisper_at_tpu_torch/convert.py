"""Weights bridge: the JAX package's parameter tree -> this port's state dict.

`from_jax_params(tree)` takes the tree as nested dicts of arrays (anything
`numpy.asarray` accepts) with the JAX layouts:

* linear `{"w": [in, out], "b": [out]}`        -> `weight [out, in]`, `bias`
* conv   `{"w": [3, in, out], "b": [out]}`     -> `weight [out, in, 3]`, `bias`
* layer norm `{"scale", "bias"}`               -> `weight`, `bias`
* `blocks`: every leaf stacked on a leading layer axis -> `blocks.{i}.*`

and returns `{name: torch.Tensor}` for `Whisper.load_state_dict`. Only the
tests produce such a tree with JAX; this module imports numpy and torch.
Only the plain weights cross: the int8 and int4 decode forms are made from
them by `Whisper.decoder_params_decode`, as the JAX package makes its own.
"""

from typing import Dict

import numpy as np
import torch


def _np(x) -> np.ndarray:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":  # numpy has no bf16 that torch reads
        arr = arr.astype(np.float32)
    return arr


def _linear(out: dict, prefix: str, p: dict, layer=None) -> None:
    pick = (lambda a: _np(a)) if layer is None else (lambda a: _np(a)[layer])
    out[f"{prefix}.weight"] = pick(p["w"]).T
    if "b" in p:
        out[f"{prefix}.bias"] = pick(p["b"])


def _ln(out: dict, prefix: str, p: dict, layer=None) -> None:
    pick = (lambda a: _np(a)) if layer is None else (lambda a: _np(a)[layer])
    out[f"{prefix}.weight"] = pick(p["scale"])
    out[f"{prefix}.bias"] = pick(p["bias"])


def _block(out: dict, prefix: str, p: dict, layer=None) -> None:
    for attn in ("attn", "cross_attn"):
        if attn not in p:
            continue
        for proj in ("query", "key", "value", "out"):
            _linear(out, f"{prefix}.{attn}.{proj}", p[attn][proj], layer)
        _ln(out, f"{prefix}.{attn}_ln", p[f"{attn}_ln"], layer)
    _linear(out, f"{prefix}.mlp.0", p["mlp"]["fc1"], layer)
    _linear(out, f"{prefix}.mlp.2", p["mlp"]["fc2"], layer)
    _ln(out, f"{prefix}.mlp_ln", p["mlp_ln"], layer)


def _stack(out: dict, prefix: str, blocks: dict) -> None:
    n_layer = _np(blocks["attn"]["query"]["w"]).shape[0]
    for i in range(n_layer):
        _block(out, f"{prefix}.{i}", blocks, layer=i)


def from_jax_params(tree: dict) -> Dict[str, torch.Tensor]:
    """State dict of `models.whisper.Whisper` from the JAX parameter tree
    {"encoder", "decoder", "at_model"}."""
    out = {}
    enc, dec, head = tree["encoder"], tree["decoder"], tree["at_model"]
    for conv in ("conv1", "conv2"):
        out[f"encoder.{conv}.weight"] = _np(enc[conv]["w"]).transpose(2, 1, 0)
        out[f"encoder.{conv}.bias"] = _np(enc[conv]["b"])
    out["encoder.positional_embedding"] = _np(enc["positional_embedding"])
    _stack(out, "encoder.blocks", enc["blocks"])
    _ln(out, "encoder.ln_post", enc["ln_post"])

    out["decoder.token_embedding.weight"] = _np(dec["token_embedding"])
    out["decoder.positional_embedding"] = _np(dec["positional_embedding"])
    _stack(out, "decoder.blocks", dec["blocks"])
    _ln(out, "decoder.ln", dec["ln"])

    out = {k: torch.from_numpy(np.array(v)) for k, v in out.items()}
    out.update(at_head_state_dict(head))
    return out


def at_head_state_dict(head: dict) -> Dict[str, torch.Tensor]:
    """The `at_model.*` entries of the state dict from a JAX-layout TL-TR
    head tree: the model's own, or one the training stack fitted in the
    model's architecture (`lw_tr_1_8` for `tl_tr_1_8`, `lw_down_tr_512_1_8`
    for the low-compute `tl_down_tr_512_1_8`) over 527 classes, such as
    `train.wa_model`'s average."""
    out = {}
    _block(out, "at_model.time_tr", head["time_tr"])
    _block(out, "at_model.layer_tr", head["layer_tr"])
    _ln(out, "at_model.mlp_layer.0", head["mlp_ln"])
    _linear(out, "at_model.mlp_layer.1", head["mlp"])
    if "down" in head:
        _ln(out, "at_model.down_layer.0", head["down_ln"])
        _linear(out, "at_model.down_layer.1", head["down"])
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


# --------------------------------------------------------------------------- #
# the TL-TR research head (train/tltr.py) and its optimizer moments
# --------------------------------------------------------------------------- #

_BLOCKS = ("time_tr", "layer_tr")
_FC = {"0": "fc1", "2": "fc2"}


def tltr_jax_path(name: str):
    """Port parameter name of a `train.tltr.TLTR` -> (its path in the JAX
    package's tree, whether the array is transposed between the two)."""
    parts = name.split(".")
    if parts == ["layer_weight"]:
        return ("layer_weight",), False
    *owner, leaf = parts
    if parts[0] in _BLOCKS and len(owner) == 3 and owner[1] == "mlp":
        owner = [owner[0], "mlp", _FC[owner[2]]]
    if owner[-1].endswith("_ln"):
        return (*owner, {"weight": "scale", "bias": "bias"}[leaf]), False
    return (*owner, {"weight": "w", "bias": "b"}[leaf]), leaf == "weight"


def tltr_leaf_to_jax(name: str, value: torch.Tensor) -> np.ndarray:
    """One TL-TR tensor (a parameter or a moment under its name) as the JAX
    package's fp32 array."""
    arr = value.detach().to("cpu", torch.float32).numpy()
    return (arr.T if tltr_jax_path(name)[1] else arr).copy()


def tltr_leaf_from_jax(name: str, arr) -> torch.Tensor:
    arr = _np(arr)
    return torch.from_numpy(np.array(arr.T if tltr_jax_path(name)[1] else arr))


def tltr_to_jax_params(named) -> dict:
    """{port name: tensor} of a `train.tltr.TLTR` (its state dict, or any
    tensors under its parameter names, such as Adam's moments) -> the JAX
    package's tree of fp32 numpy arrays ([in, out] linear weights)."""
    tree: dict = {}
    for name, value in named.items():
        path = tltr_jax_path(name)[0]
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = tltr_leaf_to_jax(name, value)
    return tree


def tltr_from_jax_params(tree: dict, names) -> Dict[str, torch.Tensor]:
    """The JAX package's TL-TR tree -> {port name: tensor} for `names` (a
    `TLTR`'s parameter names, e.g. its `state_dict()` keys)."""
    out = {}
    for name in names:
        node = tree
        for part in tltr_jax_path(name)[0]:
            node = node[part]
        out[name] = tltr_leaf_from_jax(name, node)
    return out


def jax_leaf_order(names) -> list:
    """`names` in the order `jax.tree.leaves` visits their JAX paths (dict
    keys sorted at every level)."""
    return sorted(names, key=lambda n: tltr_jax_path(n)[0])
