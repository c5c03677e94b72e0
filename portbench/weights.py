"""Seeded Whisper-AT weights, made on the device in a few large calls.

A frozen copy of the port's random initialisation, written under the
reference checkpoints' parameter names (openai/whisper `*.pt` plus the
Whisper-AT head `at_model.*`):

  Linear weight and bias   U(-1/sqrt(in), 1/sqrt(in))
  Conv1d weight            U(-(3 in)^-0.5, (3 in)^-0.5), bias 0
  LayerNorm                weight 1, bias 0
  token embedding          N(0, 0.02)
  text positions           N(0, 0.01)
  audio positions          the sinusoid table

Every leaf is a view into one flat buffer in the serving dtype, each leaf
starting on a 512-byte boundary (the kernels read weights through TMA). The
uniform leaves are drawn by one generator in a few chunked calls and scaled
a run of equal bounds at a time, so making large-v1 costs a handful of
launches, not one per leaf.

The benchmark hands the same tensors to the program (`load_state_dict`
with assign=True) and to the plain reference (`reference/`), which upcasts
them to float32 as it reads them.
"""

import math
from collections import OrderedDict
from typing import Dict, List, Tuple

import numpy as np
import torch

ALIGN = 256  # elements: a leaf starts on a 512-byte boundary in bf16
CHUNK = 1 << 27  # elements drawn per generator call
LABELS = 527


def _linear(prefix: str, n_in: int, n_out: int, bias: bool = True) -> List[tuple]:
    bound = 1.0 / math.sqrt(n_in)
    leaves = [(f"{prefix}.weight", (n_out, n_in), "uniform", bound)]
    if bias:
        leaves.append((f"{prefix}.bias", (n_out,), "uniform", bound))
    return leaves


def _ln(prefix: str, d: int) -> List[tuple]:
    return [(f"{prefix}.weight", (d,), "ones", None), (f"{prefix}.bias", (d,), "zeros", None)]


def _block(prefix: str, d: int, cross: bool) -> List[tuple]:
    leaves = []
    for attn in ("attn", "cross_attn") if cross else ("attn",):
        leaves += _linear(f"{prefix}.{attn}.query", d, d)
        leaves += _linear(f"{prefix}.{attn}.key", d, d, bias=False)
        leaves += _linear(f"{prefix}.{attn}.value", d, d)
        leaves += _linear(f"{prefix}.{attn}.out", d, d)
        leaves += _ln(f"{prefix}.{attn}_ln", d)
    leaves += _linear(f"{prefix}.mlp.0", d, 4 * d)
    leaves += _linear(f"{prefix}.mlp.2", 4 * d, d)
    leaves += _ln(f"{prefix}.mlp_ln", d)
    return leaves


def leaves(dims: Dict[str, int]) -> List[tuple]:
    """(name, shape, init, bound) of every tensor of the model, in the
    reference checkpoints' order."""
    d, n_mels = dims["n_audio_state"], dims["n_mels"]
    conv_bound = lambda n_in: (3 * n_in) ** -0.5  # noqa: E731
    out = [("encoder.conv1.weight", (d, n_mels, 3), "uniform", conv_bound(n_mels)),
           ("encoder.conv1.bias", (d,), "zeros", None),
           ("encoder.conv2.weight", (d, d, 3), "uniform", conv_bound(d)),
           ("encoder.conv2.bias", (d,), "zeros", None),
           ("encoder.positional_embedding", (dims["n_audio_ctx"], d), "sinusoids", None)]
    for i in range(dims["n_audio_layer"]):
        out += _block(f"encoder.blocks.{i}", d, cross=False)
    out += _ln("encoder.ln_post", d)
    dt = dims["n_text_state"]
    out += [("decoder.token_embedding.weight", (dims["n_vocab"], dt), "normal", 0.02),
            ("decoder.positional_embedding", (dims["n_text_ctx"], dt), "normal", 0.01)]
    for i in range(dims["n_text_layer"]):
        out += _block(f"decoder.blocks.{i}", dt, cross=True)
    out += _ln("decoder.ln", dt)
    out += _block("at_model.time_tr", d, cross=False)
    out += _block("at_model.layer_tr", d, cross=False)
    out += _ln("at_model.mlp_layer.0", d)
    out += _linear("at_model.mlp_layer.1", d, LABELS)
    return out


def sinusoids(length: int, channels: int, max_timescale: float = 10000) -> np.ndarray:
    """Whisper's sinusoidal position table [length, channels]."""
    step = np.log(max_timescale) / (channels // 2 - 1)
    inv = np.exp(-step * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


def _layout(specs) -> Tuple[list, int]:
    """Leaves grouped by init kind (uniform ones by bound), each at an
    aligned offset: [(name, shape, init, bound, offset)], total elements."""
    kind_order = {"uniform": 0, "normal": 1, "ones": 2, "zeros": 3, "sinusoids": 4}
    ordered = sorted(specs, key=lambda s: (kind_order[s[2]], -(s[3] or 0.0)))
    placed, offset = [], 0
    for name, shape, init, bound in ordered:
        placed.append((name, shape, init, bound, offset))
        offset += -(-math.prod(shape) // ALIGN) * ALIGN
    return placed, offset


def _runs(placed, init: str):
    """Maximal runs [(start, end, bound)] of consecutive leaves of one init
    and one bound (the padding between them rides along)."""
    runs = []
    for name, shape, kind, bound, offset in placed:
        if kind != init:
            continue
        end = offset + math.prod(shape)
        if runs and runs[-1][2] == bound:
            runs[-1][1] = end
        else:
            runs.append([offset, end, bound])
    return runs


def make_weights(dims: Dict[str, int], seed: int, device, dtype=torch.bfloat16
                 ) -> "OrderedDict[str, torch.Tensor]":
    """The model's state dict drawn from `seed` on `device`, in `dtype`."""
    placed, total = _layout(leaves(dims))
    flat = torch.zeros(total, dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    for init, draw in (("uniform", torch.rand), ("normal", torch.randn)):
        for start, end, bound in _runs(placed, init):
            for lo in range(start, end, CHUNK):
                hi = min(end, lo + CHUNK)
                r = draw(hi - lo, generator=gen, device=device, dtype=torch.float32)
                flat[lo:hi] = (r * 2.0 - 1.0) * bound if init == "uniform" else r * bound
    for start, end, _ in _runs(placed, "ones"):
        flat[start:end] = 1.0
    state = OrderedDict()
    for name, shape, init, _, offset in placed:
        view = flat[offset:offset + math.prod(shape)].view(shape)
        if init == "sinusoids":
            view.copy_(torch.from_numpy(sinusoids(*shape)))
        state[name] = view
    return OrderedDict((name, state[name]) for name, *_ in leaves(dims))
