"""Build and bind the hand-written CUDA kernels.

Each source under ``repro_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes`` (pointers and the stream pass as ``c_void_p``).  A library is
built at first use, from the repository's sources only, into
``build/cuda/`` at the root of the checkout; its file name carries a
digest of the source, so an edited kernel is never served from a stale
build.  ``build_all`` starts one ``nvcc`` per source at once.

A ``CudaKernel`` also carries the kernel's launch count: its wrapper adds
one each time it launches the kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "cuda"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P = ctypes.c_void_p
I64 = ctypes.c_int64
I32 = ctypes.c_int


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


class CudaKernel:
    """One CUDA source, the C function it exports, and its launch count."""

    def __init__(self, source: str, symbol: str, argtypes: tuple):
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.build_log = ""
        self._fn = None

    @property
    def lib_path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()
                                + " ".join(NVCC_FLAGS).encode()
                                ).hexdigest()[:12]
        return BUILD_DIR / f"{self.source.stem}-{digest}.so"

    def start_build(self) -> Optional[subprocess.Popen]:
        """Start ``nvcc`` for this source unless its library exists."""
        if self.lib_path.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.lib_path.with_suffix(f".{os.getpid()}.tmp")
        return subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def finish_build(self, proc: Optional[subprocess.Popen]) -> None:
        if proc is None:
            return
        out, _ = proc.communicate()
        self.build_log = out
        tmp = self.lib_path.with_suffix(f".{os.getpid()}.tmp")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source.name}:\n{out}")
        os.replace(tmp, self.lib_path)

    def fn(self):
        """The bound C function, building the library on first use."""
        if self._fn is None:
            self.finish_build(self.start_build())
            lib = ctypes.CDLL(str(self.lib_path))
            fn = getattr(lib, self.symbol)
            fn.argtypes = list(self.argtypes)
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        """Call the C launcher on the current stream, raise on a non-zero
        ``cudaGetLastError()``, and count the launch."""
        stream = torch.cuda.current_stream().cuda_stream
        rc = self.fn()(*args, stream)
        if rc != 0:
            raise RuntimeError(f"{self.symbol} failed to launch: CUDA error "
                               f"{rc}")
        self.launches += 1


def build_all(kernels) -> float:
    """Build every kernel's library in parallel (one ``nvcc`` each, all
    started together) and bind them; returns the wall seconds taken."""
    t0 = time.perf_counter()
    procs = [(k, k.start_build()) for k in kernels]
    for k, proc in procs:
        k.finish_build(proc)
    for k in kernels:
        k.fn()
    return time.perf_counter() - t0


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype,
               ndim: int) -> None:
    """The wrapper's operand contract: a contiguous CUDA tensor of the
    kernel's dtype and rank.  A CPU tensor is refused here — the plain
    version is chosen by the caller, never by the kernel wrapper."""
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors "
                         f"(got {getattr(t, 'device', type(t))})")
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {ndim}-d {dtype} "
                         f"tensor, got {t.dtype} {tuple(t.shape)}")
