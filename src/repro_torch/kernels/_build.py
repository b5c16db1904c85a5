"""Build and bind the hand-written CUDA kernels (``src/repro_torch/csrc``).

Each ``.cu`` file has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library under ``build/repro_torch/``
at the repository root (listed in ``.gitignore``), at first use; a
library newer than its source is reused. ``build`` starts one ``nvcc``
per source at once. The libraries are loaded with ``ctypes``: every
pointer and the stream pass as ``c_void_p``, and each C entry point
returns ``cudaGetLastError()`` after its launch.

Nothing here runs at import: the CPU tests import every module, and
this host has no ``nvcc``.

Kernels are launched from several threads at once (the serving bridge
runs one engine per thread, each on its own CUDA stream), so the lazy
build and load of a library and the launch count are each guarded by a
lock.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

#: serializes ``build`` within the process: two threads reaching a stale
#: library would otherwise both run ``nvcc`` into the same temporary file
_BUILD_LOCK = threading.RLock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (nvcc) to build the "
                           "repro_torch kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


class CudaKernel:
    """One kernel's shared library, its C entry point and its launch
    count. ``launch`` raises on a non-zero ``cudaGetLastError()`` and
    counts only launches that were accepted; it may be called from any
    thread."""

    def __init__(self, name: str, argtypes):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self.lib_path = BUILD_DIR / f"lib{name}.so"
        self.argtypes = list(argtypes) + [P]        # ..., stream
        self.launches = 0
        self.ptxas_log = ""
        self._lib = None
        self._count_lock = threading.Lock()

    def stale(self) -> bool:
        return (not self.lib_path.exists()
                or self.lib_path.stat().st_mtime
                < self.source.stat().st_mtime)

    def _entry(self):
        entry = self._lib
        if entry is not None:
            return entry
        with _BUILD_LOCK:
            if self._lib is None:
                if self.stale():
                    build([self])
                lib = ctypes.CDLL(str(self.lib_path))
                fn = getattr(lib, f"{self.name}_launch")
                fn.argtypes, fn.restype = self.argtypes, ctypes.c_int
                err = getattr(lib, f"{self.name}_error_string")
                err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
                self._lib = (lib, fn, err)
            return self._lib

    def launch(self, *args) -> None:
        _, fn, err = self._entry()
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(*args, stream)
        if code != 0:
            raise RuntimeError(f"{self.name} launch failed: CUDA error "
                               f"{code} ({err(code).decode()})")
        with self._count_lock:
            self.launches += 1


def build(kernels) -> float:
    """Compile every stale kernel, one ``nvcc`` per source, all started
    together. Returns the wall seconds the build took; raises with the
    compiler's output when a source does not build."""
    import time
    with _BUILD_LOCK:
        t0 = time.perf_counter()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for k in kernels:
            if not k.stale():
                continue
            tmp = k.lib_path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(k.source)]
            procs.append((k, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for k, tmp, p in procs:
            out, _ = p.communicate()
            k.ptxas_log = out
            if p.returncode != 0:
                failed.append(f"{k.source.name}:\n{out}")
            else:
                os.replace(tmp, k.lib_path)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        return time.perf_counter() - t0


def check_cuda(name: str, t: torch.Tensor, dtype, shape=None) -> None:
    """The wrapper-side checks of a kernel argument: device, dtype,
    shape and contiguity."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_aligned(**tensors) -> None:
    """The 16-byte alignment of tensors a kernel reads in 16-byte
    chunks."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             f"reads 16-byte chunks)")
