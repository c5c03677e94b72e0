"""Sliding median filter over the last axis, with reflect padding.

Counterpart of `whisper_at_tpu/ops/median.py` (no Pallas kernel there, so
none here). The same bubble sorting network of elementwise min/max over the
`filter_width` shifted views: it needs no [..., width] window tensor and no
sort indices, and for NaN-free input it gives the exact median, element for
element equal to the JAX package's network and to a sort.
"""

import torch


def median_filter(x: torch.Tensor, filter_width: int) -> torch.Tensor:
    """Median over windows of `filter_width` (odd) along the last axis; an
    axis no longer than filter_width // 2 is returned as it is."""
    if filter_width <= 0 or filter_width % 2 == 0:
        raise ValueError("`filter_width` should be an odd number")
    pad = filter_width // 2
    if x.shape[-1] <= pad:
        return x
    padded = torch.cat([x[..., 1:pad + 1].flip(-1), x, x[..., -pad - 1:-1].flip(-1)], dim=-1)
    length = x.shape[-1]
    vals = [padded[..., i:i + length] for i in range(filter_width)]
    # after pass i the largest i + 1 values sit at the tail, so the middle
    # slot holds the median when the passes are done
    for i in range(filter_width):
        for j in range(filter_width - 1 - i):
            lo = torch.minimum(vals[j], vals[j + 1])
            vals[j + 1] = torch.maximum(vals[j], vals[j + 1])
            vals[j] = lo
    return vals[pad]
