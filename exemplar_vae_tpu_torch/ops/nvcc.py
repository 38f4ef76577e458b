"""nvcc for the port's CUDA kernels: one source with a plain C interface
into a shared library for sm_90a, in the package's git-ignored _build/,
keyed by the source's hash (an edited source is rebuilt; a library built
from the same source is reused as it is). The kernels' wrappers hold one
``Library`` each, which builds and loads it at first use, never at import,
and launches its C functions; ``forward_only`` is their common refusal of a
call that needs a gradient."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: put the CUDA toolkit's bin/ on "
                           "PATH or set CUDA_HOME")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def compile_library(source: Path, stem: str, verbose: bool = False) -> Path:
    """``BUILD_DIR / lib<stem>_<hash>.so`` built from ``source``. With
    ``verbose`` the compiler's output (ptxas' registers and spills) is
    printed; a failed build prints it and raises."""
    src = Path(source).read_bytes()
    so = BUILD_DIR / f"lib{stem}_{hashlib.sha1(src).hexdigest()[:12]}.so"
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=so.parent, suffix=".so")
    os.close(fd)
    cmd = [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", tmp, str(source)]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if verbose or proc.returncode:
        print(proc.stdout + proc.stderr, flush=True)
    if proc.returncode:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {source}")
    os.replace(tmp, so)
    return so


class Library:
    """A kernel library loaded through ctypes at its first use:
    ``source`` compiled by compile_library under ``stem``, its C functions
    typed by ``signatures`` (name -> (argtypes, restype)). ``source`` may
    be pointed at another file, with ``lib`` set to None, to build a
    variant."""

    def __init__(self, source: Path, stem: str, signatures: dict):
        self.source, self.stem, self.signatures = Path(source), stem, signatures
        self.lib = None

    def build(self, verbose: bool = False) -> float:
        """Compile (or reuse) and load the library. Returns the seconds
        spent, 0.0 when it was already loaded."""
        if self.lib is not None:
            return 0.0
        t0 = time.perf_counter()
        lib = ctypes.CDLL(str(compile_library(self.source, self.stem,
                                              verbose)))
        for name, (argtypes, restype) in self.signatures.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        self.lib = lib
        return time.perf_counter() - t0

    def launch(self, name: str, device, *args) -> None:
        """``name(*args, stream)`` with ``device`` current and its current
        stream last; raises where the function returns a cudaError."""
        self.build()
        with torch.cuda.device(device):
            err = getattr(self.lib, name)(
                *args, torch.cuda.current_stream(device).cuda_stream)
        if err:
            raise RuntimeError(f"{self.stem} kernel launch failed: "
                               f"cudaError {err}")


def forward_only(op: str, advice: str, *tensors) -> None:
    """Raise where a call of the forward-only ``op`` would need a gradient:
    grad mode on and one of ``tensors`` requiring grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"the {op} op is forward-only; {advice}")
