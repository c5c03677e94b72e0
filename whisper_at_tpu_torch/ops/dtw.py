"""K6: dynamic time warping for word timing, and its host backtrace.

Replaces `whisper_at_tpu/ops/dtw_pallas.py::_dtw_device` (Pallas). The
CUDA source is `csrc/dtw.cu`: one block per cost matrix of a batch (two
blocks of a cluster past eight warps of rows), a lane per DP row with its
costs in registers, the up neighbour passed between lanes by shuffles and
between warps through shared-memory rings under mbarriers, the inputs
staged ahead in TMA boxes. Its header gives the bound, the cell rules and
the design. Rows of x whose length is not a multiple of 4 are padded here
for the copy engine (the padding is never read).

The trace comes back skewed, int8 [G, N_max + M + 1, N_max + 1] with
trace[g, i + j, i] the step into cell (i, j) of matrix g: 0 diagonal, 1 up,
2 left (-1 where no step is defined). `backtrace` walks that layout on the
host. `dtw_trace_plain` is the same function in plain PyTorch, used for CPU
tensors and as the kernel's yardstick on the card.
"""

import ctypes
from typing import List, Sequence

import numpy as np
import torch

from .cuda import CudaKernel, ptr, require_cuda, stream_handle

KERNEL = CudaKernel(
    "dtw", "dtw.cu", "dtw_trace",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    replaces="whisper_at_tpu/ops/dtw_pallas.py:75",
)
MAX_ROWS = 511  # N_max: at most 16 warps, a lane a row (csrc/dtw.cu)
ACC_TYPES = (torch.float32, torch.float64)


def _check(x: torch.Tensor, n: torch.Tensor, dtype) -> None:
    if x.dim() != 3 or n.shape != (x.shape[0],):
        raise ValueError(f"x must be [G, N_max, M] and n [G], got {tuple(x.shape)}, "
                         f"{tuple(n.shape)}")
    if dtype not in ACC_TYPES:
        raise ValueError(f"dtype must be one of {ACC_TYPES}, got {dtype}")


def dtw_trace_plain(x: torch.Tensor, n: torch.Tensor,
                    dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """The DP as a PyTorch wavefront, one vector step per anti-diagonal, with
    the costs summed in `dtype`; the same cells, ties and layout as K6."""
    _check(x, n, dtype)
    g, n_max, m = x.shape
    k_total, w = n_max + m + 1, n_max + 1
    dev = x.device
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)
    # xp[:, i, j] = x[:, i-1, j-1], +inf on the borders i == 0 and j == 0
    xp = torch.nn.functional.pad(x.to(dtype), (1, 0, 1, 0), value=float("inf"))
    rows = torch.arange(w, device=dev)
    in_rows = rows[None, :] <= n.to(dev).long()[:, None]              # [G, W]
    inf_col = inf.expand(g, 1)
    trace = torch.full((g, k_total, w), -1, dtype=torch.int8, device=dev)
    d2 = torch.full((g, w), float("inf"), dtype=dtype, device=dev)    # diagonal 0
    d2[:, 0] = 0
    d1 = torch.full((g, w), float("inf"), dtype=dtype, device=dev)    # diagonal 1
    for k in range(2, k_total):
        cols = k - rows
        valid = in_rows & ((cols >= 0) & (cols <= m))[None, :]
        c0 = torch.cat([inf_col, d2[:, :-1]], dim=1)  # diagonal (i-1, j-1)
        c1 = torch.cat([inf_col, d1[:, :-1]], dim=1)  # up       (i-1, j)
        c2 = d1                                       # left     (i, j-1)
        t = torch.where((c0 < c1) & (c0 < c2), 0, torch.where((c1 < c0) & (c1 < c2), 1, 2))
        best = torch.where(t == 0, c0, torch.where(t == 1, c1, c2))
        xv = xp[:, rows, cols.clamp(0, m)]
        d2, d1 = d1, torch.where(valid, xv + best, inf)
        trace[:, k] = torch.where(valid, t, -1).to(torch.int8)
    return trace


def dtw_trace(x: torch.Tensor, n: torch.Tensor,
              dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Skewed int8 trace of the DTW of each x[g, :n[g]] (x [G, N_max, M]
    fp32, n [G] int32), the costs summed in `dtype` (float32 is the TPU
    kernel's arithmetic, float64 the JAX package's default host DTW)."""
    if not x.is_cuda:
        return dtw_trace_plain(x, n, dtype)
    _check(x, n, dtype)
    g, n_max, m = x.shape
    require_cuda(x, torch.float32, "x", 3)
    require_cuda(n, torch.int32, "n", 1)
    if not 1 <= n_max <= MAX_ROWS or m < 1:
        raise ValueError(f"x [G, N_max, M] needs 1 <= N_max <= {MAX_ROWS} and M >= 1")
    if m % 4:  # the copy engine's row stride is a whole 16-byte unit
        x = torch.nn.functional.pad(x, (0, 4 - m % 4))
    trace = torch.empty((g, n_max + m + 1, n_max + 1), dtype=torch.int8, device=x.device)
    KERNEL.launch(ptr(x), ptr(n), ptr(trace), g, n_max, m, x.shape[2],
                  int(dtype == torch.float64), stream_handle(x.device))
    return trace


def backtrace(trace: np.ndarray, n: int, m: int) -> np.ndarray:
    """The path from (n, m) back to (0, 0) through one skewed trace [K, W]
    -> [2, path_len] (text indices, time indices), first step first."""
    i, j = n, m
    path = []
    while i > 0 or j > 0:
        path.append((i - 1, j - 1))
        if j == 0:
            t = 1
        elif i == 0:
            t = 2
        else:
            t = trace[i + j, i]
        if t == 0:
            i -= 1
            j -= 1
        elif t == 1:
            i -= 1
        elif t == 2:
            j -= 1
        else:
            raise ValueError("Unexpected trace value")
    return np.array(path)[::-1].T


def dtw_paths(matrices: torch.Tensor, lengths: Sequence[int],
              dtype: torch.dtype = torch.float64) -> List[np.ndarray]:
    """Paths through the cost matrices matrices[g, :lengths[g]] (one K6
    launch for the batch; backtraces on the host)."""
    n = torch.tensor(list(lengths), dtype=torch.int32, device=matrices.device)
    trace = dtw_trace(matrices.contiguous(), n, dtype).cpu().numpy()
    m = matrices.shape[-1]
    return [backtrace(trace[g], int(lengths[g]), m) for g in range(len(lengths))]
