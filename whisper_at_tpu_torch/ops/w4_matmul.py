"""K5: the decode loop's int4-weight matmul, fp32 [M, N] = x @ unpack4(Wp)^T.

Replaces `whisper_at_tpu/ops/w4_matmul.py::w4_matmul` (Pallas). The CUDA
source is `csrc/w4_matmul.cu`; its header gives the bound and the design:
the packed weight is read once, 16 bytes a lane, straight into registers and
its nibbles widened there, so no bf16 copy of the weight is ever written; K
is split over a cluster of up to 8 blocks, summed in rank order. `models/layers.QuantLinear4`
calls it for bf16 rows on the card (M <= 256) and applies the scale and
bias epilogue.

Wp is int8 [N, K/2] in the `pack4` layout of `models/layers.py` (adjacent
pairs along K, low nibble first), i.e. the [out, in] weight packed along
its input axis.
"""

import ctypes

import torch

from .cuda import CudaKernel, ptr, require_cuda, stream_handle

KERNEL = CudaKernel(
    "w4_matmul", "w4_matmul.cu", "w4_matmul_bf16",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    replaces="whisper_at_tpu/ops/w4_matmul.py:67",
)
MAX_ROWS = 256
K_STEP = 32      # K a lane's 16-byte weight load covers
N_STEP = 64
MAX_K = 5120     # 8 blocks of a cluster x 5 chunks of 128


def w4_matmul_plain(x: torch.Tensor, wp: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch: fp32 x @ unpack4(wp)^T."""
    from ..models.layers import unpack4  # models.layers imports this module lazily

    return torch.matmul(x.float(), unpack4(wp).float().t())


def w4_matmul(x: torch.Tensor, wp: torch.Tensor) -> torch.Tensor:
    """fp32 [M, N] = x [M, K] @ unpack4(wp [N, K/2])^T, M <= 256."""
    if not x.is_cuda:
        return w4_matmul_plain(x, wp)
    require_cuda(x, torch.bfloat16, "x", 2)
    require_cuda(wp, torch.int8, "wp", 2)
    m, k = x.shape
    n = wp.shape[0]
    if wp.shape[1] * 2 != k:
        raise ValueError(f"wp {tuple(wp.shape)} does not pack K = {k}")
    if not 0 < m <= MAX_ROWS:
        raise ValueError(f"the kernel takes 1 to {MAX_ROWS} rows, got {m}")
    if not n or n % N_STEP or not k or k % K_STEP or k > MAX_K:
        raise ValueError(f"the kernel takes N a multiple of {N_STEP} and K a multiple of "
                         f"{K_STEP} up to {MAX_K}, got K={k}, N={n}")
    out = torch.empty((m, n), device=x.device, dtype=torch.float32)
    KERNEL.launch(ptr(x), ptr(wp), ptr(out), m, n, k, stream_handle(x.device))
    return out
