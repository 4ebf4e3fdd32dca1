"""Build, load and launch the hand-written Hopper kernels in ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C entry point that launches its
kernel on the stream it is given and returns ``cudaGetLastError()``.  The
sources are compiled with ``nvcc`` for ``sm_90a`` into one shared library
each under ``<repo>/build/kernels/`` at first use (one ``nvcc`` process per
source, all started together), then loaded with ``ctypes``.  A library newer
than its source is reused.  Nothing here runs at import time: the CPU tests
import every module without a compiler or a card.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    return not lib.exists() or lib.stat().st_mtime < (CSRC / f"{name}.cu").stat().st_mtime


def build_all() -> dict[str, str]:
    """Compile every stale source in parallel -> {name: ptxas report}.

    Raises with the compiler's output if any build fails."""
    todo = [p.stem for p in sorted(CSRC.glob("*.cu")) if _stale(p.stem)]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = BUILD_DIR / f"lib{n}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for n, (tmp, p) in procs.items():
        out, _ = p.communicate()
        reports[n] = out
        if p.returncode != 0:
            failed.append(f"--- {n}.cu (exit {p.returncode})\n{out}")
        else:
            os.replace(tmp, _lib_path(n))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The shared library of csrc/<name>.cu, building every stale source
    together on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if _stale(name):
                build_all()
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib


P = ctypes.c_void_p  # every device pointer and the stream
I = ctypes.c_int
F = ctypes.c_float


class CudaKernel:
    """One C entry point of one library, with its launch count.

    ``launches`` goes up by one each time the kernel is launched, and only
    then; the wrappers in ``kernels/<name>/ops.py`` call ``launch`` on CUDA
    tensors and the plain PyTorch version on CPU tensors.
    """

    def __init__(self, lib: str, symbol: str, argtypes: list):
        self.lib, self.symbol, self.argtypes = lib, symbol, argtypes
        self.launches = 0
        self._fn = None

    def launch(self, *args) -> None:
        if self._fn is None:
            fn = getattr(load(self.lib), self.symbol)
            fn.argtypes = [*self.argtypes, P]
            fn.restype = I
            self._fn = fn
        stream = torch.cuda.current_stream().cuda_stream
        err = self._fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {err} at launch")
        self.launches += 1


def check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int, device: torch.device) -> None:
    """Raise unless t is a contiguous ``dtype`` tensor of rank ``ndim`` on
    ``device`` — the contract every C entry point relies on."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected rank {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
