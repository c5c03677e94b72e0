"""Native checkpoint format: one `.npz` of a flattened parameter tree.

Counterpart of `whisper_at_tpu/checkpoint.py` (`_flatten`, `_unflatten`,
`save_params`, `load_params`), with the same file layout: each leaf of the
nested dict under its "/"-joined path, and, with `dims`, every model
dimension under `__dims__/<name>`. The trees are those of the JAX package
(linear weights [in, out], layer norms as `scale` / `bias`), so a file
written by either package loads in the other; `convert.py` maps the trees
onto the port's modules. numpy only. `rename_head_state_dict` maps a
trained head's `module.*` keys onto the reference's `at_model.*`, as the
JAX package's does; `load_model` merges head files through it.
"""

from typing import Dict, Optional, Tuple

import numpy as np

from .models.dims import ModelDimensions


def _flatten(tree: dict, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(value, dict):
            flat.update(_flatten(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def _unflatten(flat: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for path, value in flat.items():
        parts = path.split("/")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def save_params(path: str, params: dict, dims: Optional[ModelDimensions] = None) -> None:
    """Write `params` (nested dicts of arrays) and optionally `dims`."""
    flat = _flatten(params)
    meta = {}
    if dims is not None:
        meta = {f"__dims__/{k}": np.asarray(v) for k, v in dims.__dict__.items()}
    np.savez(path, **flat, **meta)


def load_params(path: str, dtype=None) -> Tuple[Optional[ModelDimensions], dict]:
    """(dims or None, nested dict of numpy arrays); with `dtype` (a numpy
    dtype), every leaf is cast to it."""
    with np.load(path) as data:
        flat = {}
        dims_kwargs = {}
        for key in data.files:
            if key.startswith("__dims__/"):
                dims_kwargs[key.split("/", 1)[1]] = int(data[key])
            else:
                flat[key] = data[key] if dtype is None else data[key].astype(dtype)
    dims = ModelDimensions(**dims_kwargs) if dims_kwargs else None
    return dims, _unflatten(flat)


def rename_head_state_dict(state_dict: Dict) -> Dict:
    """Rename trained-head keys `module.*` -> `at_model.*` so they merge with
    a Whisper checkpoint at load; other keys stay as they are."""
    return {("at_model." + k[len("module."):] if k.startswith("module.") else k): v
            for k, v in state_dict.items()}
