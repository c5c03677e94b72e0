"""P1 and P2: the HBM streaming-bandwidth probes of `tools/probe_dma.py`.

The JAX probe streams one int8 buffer x [rows, 128] (a whole number of
chunks of `chunk_rows` rows) through the TPU's fast memory and returns the
int32 column sums of the first 8 KB (64 rows) of every chunk, summed over
the chunks, [1, 128]: P1 (`auto`, `tools/probe_dma.py:88`) as a grid of one
step per chunk, P2 (`manual`, `:136`) as one invocation with an N-deep ring
of manual DMA copies. Its counterparts here, in `csrc/probe_dma.cu`:

- `stream_auto` (P1, `KERNEL_AUTO`): a grid over chunks x 64 KB parts, each
  thread streaming through registers in 16-byte loads;
- `stream_ring` (P2) with `engine="cp_async"` (`KERNEL_CP`: every thread
  copies 16 bytes at a time with `cp.async`) or `engine="tma"`
  (`KERNEL_TMA`: one thread issues a bulk copy per stage, completion on an
  mbarrier), both persistent (one block per SM) over a ring of `nbuf`
  stages of `stage_bytes(chunk_rows, nbuf)`.

Each wrapper returns (sums [1, 128] int32, xor [1] int32). The XOR of every
32-bit word of x is the one output the JAX probe lacks: it makes every
streamed byte reach a consumer (without it nvcc drops P1's loads outside
the slivers, and the probe would time 8 KB a chunk), and it lets a test
check the whole stream. It costs four integer XORs per 16 bytes. Both
outputs are integers merged in any order, so a kernel's result equals the
plain version's bit for bit.

For CPU tensors the wrappers run the plain version (`stream_plain`); for
CUDA tensors they launch the kernel or raise.
"""

import ctypes
from typing import Tuple

import numpy as np
import torch

from .cuda import CudaKernel, ptr, require_cuda, stream_handle

LANES = 128
SLIVER_BYTES = 8192
SLIVER_ROWS = SLIVER_BYTES // LANES
RING_BYTES = 200 * 1024  # the most a ring's stages take of a block's shared memory
RING_DEPTHS = (2, 4, 8)
ENGINES = ("cp_async", "tma")

KERNEL_AUTO = CudaKernel(
    "probe_auto", "probe_dma.cu", "probe_auto",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
    replaces="tools/probe_dma.py:88")
_RING_ARGTYPES = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong]
                  + [ctypes.c_int] * 3 + [ctypes.c_void_p])
KERNEL_CP = CudaKernel("probe_ring_cp", "probe_dma.cu", "probe_ring_cp", _RING_ARGTYPES,
                       replaces="tools/probe_dma.py:137")
KERNEL_TMA = CudaKernel("probe_ring_tma", "probe_dma.cu", "probe_ring_tma", _RING_ARGTYPES,
                        replaces="tools/probe_dma.py:137")
RING_KERNELS = {"cp_async": KERNEL_CP, "tma": KERNEL_TMA}


def probe_geometry(mb: int, chunk_kb: int) -> Tuple[int, int, int]:
    """(rows, chunk_rows, n_chunks) of an `mb` MiB buffer in chunks of
    `chunk_kb` KiB, rounded down to whole chunks as the JAX probe does.
    Raises ValueError where the JAX probe's two kernels disagree (a chunk
    under the 8 KB sliver) or have nothing to stream (no whole chunk)."""
    rows = mb * (1 << 20) // LANES
    chunk_rows = chunk_kb * (1 << 10) // LANES
    if chunk_rows < SLIVER_ROWS:
        raise ValueError(f"chunk_kb must be at least {SLIVER_BYTES // 1024}, got {chunk_kb}")
    rows = rows // chunk_rows * chunk_rows
    n_chunks = rows // chunk_rows
    if n_chunks < 1:
        raise ValueError(f"{mb} MiB holds no whole chunk of {chunk_kb} KiB")
    return rows, chunk_rows, n_chunks


def make_buffer(rows: int, seed: int = 0) -> torch.Tensor:
    """The JAX probe's buffer: int8 [rows, 128] on the CPU, values in
    -127..126, the same numpy draw byte for byte."""
    return torch.from_numpy(
        np.random.default_rng(seed).integers(-127, 127, (rows, LANES), np.int8))


def stage_bytes(chunk_rows: int, nbuf: int) -> int:
    """A ring stage: the largest power of two that divides the chunk and
    keeps `nbuf` stages within RING_BYTES (64, 32, 16 KB at N = 2, 4, 8 for
    chunks of 64 KB or more)."""
    chunk = chunk_rows * LANES
    return min(chunk & -chunk, 1 << ((RING_BYTES // nbuf).bit_length() - 1))


def _check(x: torch.Tensor, chunk_rows: int) -> None:
    if x.dtype != torch.int8 or x.dim() != 2 or x.shape[1] != LANES:
        raise ValueError(f"x must be int8 [rows, {LANES}], got {x.dtype} {tuple(x.shape)}")
    if chunk_rows < SLIVER_ROWS or x.shape[0] < chunk_rows or x.shape[0] % chunk_rows:
        raise ValueError(f"x's {x.shape[0]} rows must be a whole number (>= 1) of chunks of "
                         f"chunk_rows >= {SLIVER_ROWS}, got chunk_rows {chunk_rows}")


def stream_sum_plain(x: torch.Tensor, chunk_rows: int) -> torch.Tensor:
    """[1, 128] int32: the column sums of every chunk's first 64 rows."""
    chunks = x.view(-1, chunk_rows, LANES)[:, :SLIVER_ROWS]
    return chunks.sum(dim=(0, 1), dtype=torch.int32).view(1, LANES)


def xor_words_plain(x: torch.Tensor) -> torch.Tensor:
    """[1] int32: the XOR of every 32-bit word of x (a halving loop)."""
    w = x.reshape(-1).view(torch.int32)
    while w.numel() > 1:
        half = w.numel() // 2
        head = torch.bitwise_xor(w[:half], w[half:2 * half])
        if w.numel() % 2:
            head[:1].bitwise_xor_(w[-1:])
        w = head
    return w.reshape(1).clone()


def stream_plain(x: torch.Tensor, chunk_rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sums, xor): the function of P1 and P2 in plain PyTorch."""
    _check(x, chunk_rows)
    return stream_sum_plain(x, chunk_rows), xor_words_plain(x)


def _outputs(x: torch.Tensor):
    out = torch.zeros(LANES + 1, dtype=torch.int32, device=x.device)
    return out, out[:LANES].view(1, LANES), out[LANES:]


def stream_auto(x: torch.Tensor, chunk_rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """P1: (sums [1, 128] int32, xor [1] int32) of x int8 [rows, 128] in
    chunks of `chunk_rows` rows."""
    if not x.is_cuda:
        return stream_plain(x, chunk_rows)
    _check(x, chunk_rows)
    require_cuda(x, torch.int8, "x", 2)
    out, sums, xor = _outputs(x)
    KERNEL_AUTO.launch(ptr(x), ptr(out), x.shape[0], chunk_rows, stream_handle(x.device))
    return sums, xor


def stream_ring(x: torch.Tensor, chunk_rows: int, nbuf: int,
                engine: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """P2: `stream_auto`'s outputs through a persistent ring of `nbuf`
    stages (2, 4 or 8) filled by `engine` ("cp_async" or "tma")."""
    if nbuf not in RING_DEPTHS:
        raise ValueError(f"nbuf must be one of {RING_DEPTHS}, got {nbuf}")
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    if not x.is_cuda:
        return stream_plain(x, chunk_rows)
    _check(x, chunk_rows)
    require_cuda(x, torch.int8, "x", 2)
    out, sums, xor = _outputs(x)
    RING_KERNELS[engine].launch(ptr(x), ptr(out), x.shape[0], chunk_rows, nbuf,
                                stage_bytes(chunk_rows, nbuf), stream_handle(x.device))
    return sums, xor
