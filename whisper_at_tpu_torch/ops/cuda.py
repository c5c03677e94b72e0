"""Build, load and launch the package's hand-written CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into its own shared
library with a plain C interface, loaded with `ctypes`. A library is built
at first use (or all at once, in parallel, by `build_all`) into
`build/kernels/` at the repository root, under a name that hashes the
sources and flags, so a changed source is never served a stale binary. One
source may hold several entries (K3 and K4 have an int8 and an int4 entry),
each a `CudaKernel` of its own with its own launch count; they share the
library.

Every C entry returns `cudaGetLastError()` after its launches; `CudaKernel`
raises when that is not 0 and otherwise adds one to its launch count. The
counts are how a run shows that the main path went through the kernels.
Nothing here touches CUDA or runs `nvcc` at import time.

Several threads may reach the kernels (a server's scheduler and its session
threads): the first build and load of a library, and `build_all`, run under
one lock, and each kernel's launch count is added to under its own lock, so
no build runs twice and no launch goes uncounted.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

# registry of every kernel, by name (filled as the ops modules import)
KERNELS: Dict[str, "CudaKernel"] = {}
# held while a library is built or loaded: one nvcc per library, whatever
# the number of threads that first reach it together
_BUILD_LOCK = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


class CudaKernel:
    """One CUDA source, the C entry the wrapper calls, and its launch count.

    `argtypes` lists the C entry's parameters (ctypes.c_void_p for every
    pointer and the stream, ctypes.c_int / c_float for scalars).
    """

    def __init__(self, name: str, source: str, entry: str, argtypes: list,
                 replaces: str):
        self.name = name
        self.source = source
        self.entry = entry
        self.argtypes = argtypes
        self.replaces = replaces
        self.launches = 0
        self._count_lock = threading.Lock()
        self._lib = None
        self._fn = None
        KERNELS[name] = self

    # ------------------------------------------------------------------ #
    def _sources(self) -> List[str]:
        headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
        return [os.path.join(CSRC, self.source)] + [
            os.path.join(CSRC, h) for h in headers]

    def library_path(self) -> str:
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for path in self._sources():
            with open(path, "rb") as f:
                digest.update(f.read())
        stem = os.path.splitext(self.source)[0]
        return os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:16]}.so")

    def start_build(self) -> Optional[subprocess.Popen]:
        """Start nvcc for this kernel unless its library exists; returns the
        process (stdout+stderr to a log beside the library) or None."""
        lib = self.library_path()
        if os.path.exists(lib):
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        log = open(lib + ".log", "w")
        try:
            # a file of this process's own, moved into place whole: ranks of
            # a mesh on one host may build the same library at once
            return subprocess.Popen(
                [nvcc_path(), *NVCC_FLAGS, "-o", f"{lib}.{os.getpid()}.tmp",
                 os.path.join(CSRC, self.source)],
                stdout=log, stderr=subprocess.STDOUT)
        finally:
            log.close()

    def finish_build(self, proc: Optional[subprocess.Popen]) -> None:
        if proc is None:
            return
        lib = self.library_path()
        if proc.wait() != 0:
            with open(lib + ".log") as f:
                raise RuntimeError(f"nvcc failed for {self.source}:\n{f.read()}")
        os.replace(f"{lib}.{os.getpid()}.tmp", lib)

    def build_log(self) -> str:
        path = self.library_path() + ".log"
        if not os.path.exists(path):
            return ""
        with open(path) as f:
            return f.read()

    def _function(self):
        fn = self._fn
        if fn is None:
            with _BUILD_LOCK:
                if self._fn is None:
                    self.finish_build(self.start_build())
                    lib = ctypes.CDLL(self.library_path())
                    entry = getattr(lib, self.entry)
                    entry.argtypes = self.argtypes
                    entry.restype = ctypes.c_int
                    self._lib, self._fn = lib, entry
            fn = self._fn
        return fn

    def c_function(self, name: str, argtypes: list):
        """Another C function of this kernel's library (e.g. a size query)."""
        self._function()
        fn = getattr(self._lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        return fn

    def launch(self, *args) -> None:
        """Call the C entry on the current stream; raise on a CUDA error."""
        rc = self._function()(*args)
        if rc != 0:
            raise RuntimeError(f"{self.name}: CUDA error {rc} at launch")
        with self._count_lock:
            self.launches += 1


def build_all() -> float:
    """Compile every registered kernel's library, one nvcc process per
    source, all at once; returns the wall seconds it took (0 when everything
    was already built)."""
    t0 = time.perf_counter()
    with _BUILD_LOCK:
        procs = {}
        for k in KERNELS.values():
            if k.library_path() not in procs:
                procs[k.library_path()] = (k, k.start_build())
        for kernel, proc in procs.values():
            kernel.finish_build(proc)
    return time.perf_counter() - t0


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        with k._count_lock:
            k.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def stream_handle(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def require_cuda(t, dtype, name: str, ndim: int) -> None:
    """Check what a kernel takes: a contiguous CUDA tensor of one dtype."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
