"""nvcc for the port's CUDA kernels: one source with a plain C interface
into a shared library for sm_90a, in the package's git-ignored _build/,
keyed by the source's hash (an edited source is rebuilt; a library built
from the same source is reused as it is). The kernels' wrappers call it at
first use, never at import."""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

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
