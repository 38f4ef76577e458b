"""ctypes bindings of the native ingest library (native/ingest.cc; the
counterpart of exemplar_vae_tpu/data/native_ingest.py).

``build`` compiles native/ingest.cc with ``g++ -O3 -shared -fPIC`` into
_build/ at first use, keyed by the source's hash (an edited source is
rebuilt), and loads it. A missing compiler, a failed build or a failed load
raises, with the compiler's or the loader's message: the port does not
fall back to numpy for a broken toolchain. numpy parses only where the
format asks for it, as in the JAX package: ``load_idx`` returns None for a
gzipped file and for a file the native reader rejects (a type byte other
than 0x08 (uint8), a bad header), and ``load_amat`` parses with numpy when
the native parser gives up (a token longer than its 64-byte carry across a
read boundary) or counts values that do not fill whole rows.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "native" / "ingest.cc"
BUILD_DIR = _PKG / "_build"
_lib = None


def build() -> float:
    """Compile and load the library; returns the seconds spent, 0.0 when it
    was already loaded."""
    global _lib
    if _lib is not None:
        return 0.0
    t0 = time.perf_counter()
    src = SOURCE.read_bytes()
    so = BUILD_DIR / f"libingest_{hashlib.sha1(src).hexdigest()[:12]}.so"
    if not so.exists():
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError(f"g++ not found on PATH: the native ingest "
                               f"library is built from {SOURCE}")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
        os.close(fd)
        proc = subprocess.run([gxx, "-O3", "-shared", "-fPIC", str(SOURCE),
                               "-o", tmp], capture_output=True, text=True)
        if proc.returncode:
            os.unlink(tmp)
            raise RuntimeError(f"g++ failed ({proc.returncode}) on {SOURCE}:"
                               f"\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.amat_parse.restype = ctypes.c_long
    lib.amat_parse.argtypes = [ctypes.c_char_p,
                               ctypes.POINTER(ctypes.c_float), ctypes.c_long]
    lib.idx_parse.restype = ctypes.c_long
    lib.idx_parse.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                              ctypes.POINTER(ctypes.c_long),
                              ctypes.POINTER(ctypes.c_uint8), ctypes.c_long]
    _lib = lib
    return time.perf_counter() - t0


def load_amat(path: str, n_cols: int = 784) -> np.ndarray:
    """Parse a Larochelle .amat file -> float32 (rows, n_cols)."""
    build()
    max_elems = os.path.getsize(path) // 2 + 16   # every value takes >= 2 B
    out = np.empty(max_elems, np.float32)
    n = _lib.amat_parse(os.fsencode(path),
                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                        max_elems)
    if n < 0 or n % n_cols:
        return np.loadtxt(path, dtype=np.float32).reshape(-1, n_cols)
    return out[:n].reshape(-1, n_cols).copy()


def load_idx(path: str):
    """Parse an uncompressed uint8 IDX file -> uint8 array; None for a
    gzipped file or one the native reader rejects (the caller then runs
    its Python parser)."""
    if path.endswith(".gz"):
        return None
    build()
    ndim = ctypes.c_int()
    dims = (ctypes.c_long * 4)()
    total = _lib.idx_parse(os.fsencode(path), ctypes.byref(ndim), dims, None,
                           0)
    if total < 0:
        return None
    out = np.empty(total, np.uint8)
    got = _lib.idx_parse(os.fsencode(path), ctypes.byref(ndim), dims,
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                         total)
    if got != total:
        return None
    return out.reshape(tuple(dims[i] for i in range(ndim.value)))
