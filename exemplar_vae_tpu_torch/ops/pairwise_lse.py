"""Pairwise log-sum-exp of the exemplar prior: the CUDA kernel's wrapper and
its plain PyTorch version.

Counterpart of exemplar_vae_tpu/ops/pallas_lse.py. For each row z_b,

    lse[b] = logsumexp_n -0.5 * (D*log_var + |z_b - mu_n|^2 * exp(-log_var))

with the TPU kernel's masks: an exemplar whose effective index is PAD_IDX
(``valid`` False) is always masked, ``data_idx[b] == ex_idx[n]`` is the
leave-one-out mask, and without ``data_idx`` the row index is NO_LOO_IDX,
which matches an exemplar index of -1 only. Masked logits are the finite
NEG_INF. The result has no log-denominator.

``pairwise_lse`` launches csrc/pairwise_lse.cu for CUDA tensors and runs
``pairwise_lse_plain`` for CPU tensors; there is no fallback between them.
``pairwise_lse.launches`` counts kernel launches (one per call, which runs
the prep, partial and merge passes). The kernel is forward-only: a call
that needs a gradient raises on CUDA. Gradients come from
``ops/exemplar_prior.exemplar_log_prob``, whose autograd Function calls this
wrapper with grad mode off and recomputes the weights in its backward.
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

import torch

NEG_INF = -1e30
PAD_IDX = -2          # exemplar-index sentinel: always masked
NO_LOO_IDX = -1       # row-index sentinel when there is no leave-one-out

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "pairwise_lse.cu"
BUILD_DIR = _PKG / "_build"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib = None
_sm_count: dict = {}     # device index -> SM count, read once per device


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: put the CUDA toolkit's bin/ on "
                           "PATH or set CUDA_HOME")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build(verbose: bool = False) -> float:
    """Compile csrc/pairwise_lse.cu for sm_90a into _build/ (keyed by the
    source's hash, so an edited source is rebuilt) and load it. Returns the
    seconds spent, 0.0 when the library was already loaded."""
    global _lib
    if _lib is not None:
        return 0.0
    t0 = time.perf_counter()
    src = SOURCE.read_bytes()
    so = BUILD_DIR / f"libpairwise_lse_{hashlib.sha1(src).hexdigest()[:12]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
        os.close(fd)
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-o", tmp, str(SOURCE)]
        if verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if verbose or proc.returncode:
            print(proc.stdout + proc.stderr, flush=True)
        if proc.returncode:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on {SOURCE}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.pairwise_lse_max_d.argtypes = []
    lib.pairwise_lse_max_d.restype = ctypes.c_int
    lib.pairwise_lse_scratch_floats.argtypes = [ctypes.c_int] * 5
    lib.pairwise_lse_scratch_floats.restype = ctypes.c_longlong
    lib.pairwise_lse_forward.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
        + [ctypes.c_void_p] * 3)
    lib.pairwise_lse_forward.restype = ctypes.c_int
    _lib = lib
    return time.perf_counter() - t0


def _check(z, means, log_var, data_idx, ex_idx, valid):
    if z.dim() != 2 or means.dim() != 2 or z.shape[1] != means.shape[1]:
        raise ValueError(f"want z (B, D) and means (N, D); got "
                         f"{tuple(z.shape)} and {tuple(means.shape)}")
    b, n = z.shape[0], means.shape[0]
    if n == 0:
        raise ValueError("pairwise_lse needs at least one exemplar")
    for name, t in (("z", z), ("means", means), ("log_var", log_var)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if log_var.numel() != 1:
        raise ValueError(f"log_var must be a scalar, got {tuple(log_var.shape)}")
    if ex_idx.shape != (n,) or ex_idx.dtype != torch.int32:
        raise ValueError(f"ex_idx must be int32 ({n},), got {ex_idx.dtype} "
                         f"{tuple(ex_idx.shape)}")
    if valid.shape != (n,) or valid.dtype != torch.bool:
        raise ValueError(f"valid must be bool ({n},), got {valid.dtype} "
                         f"{tuple(valid.shape)}")
    if data_idx is not None and (data_idx.shape != (b,)
                                 or data_idx.dtype != torch.int32):
        raise ValueError(f"data_idx must be int32 ({b},), got "
                         f"{data_idx.dtype} {tuple(data_idx.shape)}")
    tensors = [z, means, log_var, ex_idx, valid]
    if data_idx is not None:
        tensors.append(data_idx)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("pairwise_lse inputs lie on different devices: "
                         f"{sorted({str(t.device) for t in tensors})}")


def pairwise_lse_plain(z, means, log_var, data_idx, ex_idx, valid, *,
                       in_dtype=torch.float32, block_n: int = 2048):
    """Blockwise online-LSE over exemplar tiles in plain PyTorch (the
    counterpart of exemplar_prior._lse_scan, with the kernel's masks).
    ``in_dtype=torch.bfloat16`` rounds z and means to bf16 first and
    computes in fp32, as the kernel does."""
    _check(z, means, log_var, data_idx, ex_idx, valid)
    z = z.to(in_dtype).float()
    means = means.to(in_dtype).float()
    b, d = z.shape
    eff = torch.where(valid, ex_idx, torch.full_like(ex_idx, PAD_IDX))
    didx = (data_idx if data_idx is not None
            else torch.full((b,), NO_LOO_IDX, dtype=torch.int32,
                            device=z.device))
    log_var = log_var.reshape(())
    inv_var = torch.exp(-log_var)
    z_sq = torch.sum(z * z, dim=-1, keepdim=True)
    m = torch.full((b,), NEG_INF, dtype=torch.float32, device=z.device)
    s = torch.zeros((b,), dtype=torch.float32, device=z.device)
    for start in range(0, means.shape[0], block_n):
        mu = means[start:start + block_n]
        e = eff[start:start + block_n]
        cross = z @ mu.T
        sq = torch.clamp_min(z_sq + torch.sum(mu * mu, dim=-1)[None, :]
                             - 2.0 * cross, 0.0)
        logits = -0.5 * (d * log_var + sq * inv_var)
        masked = (e == PAD_IDX)[None, :] | (didx[:, None] == e[None, :])
        logits = torch.where(masked, torch.full_like(logits, NEG_INF), logits)
        m_new = torch.maximum(m, torch.amax(logits, dim=-1))
        s = s * torch.exp(m - m_new) + torch.sum(
            torch.exp(logits - m_new[:, None]), dim=-1)
        m = m_new
    return m + torch.log(s)


def pairwise_lse(z, means, log_var, data_idx, ex_idx, valid, *,
                 in_dtype=torch.float32, block_n: int = 2048):
    """(B,) fp32 LSE. z (B, D) and means (N, D) float32; log_var a float32
    scalar tensor; data_idx (B,) int32 or None; ex_idx (N,) int32; valid
    (N,) bool. ``in_dtype`` is float32 or bfloat16 (the kernel's input
    type; accumulation is fp32). ``block_n`` is the exemplar tile of the
    plain version; the kernel picks its own tiles."""
    if in_dtype not in _DTYPE_CODE:
        raise ValueError(f"in_dtype must be float32 or bfloat16, got {in_dtype}")
    if z.device.type == "cpu":
        return pairwise_lse_plain(z, means, log_var, data_idx, ex_idx, valid,
                                  in_dtype=in_dtype, block_n=block_n)
    if z.device.type != "cuda":
        raise ValueError(f"pairwise_lse runs on cuda or cpu, not {z.device}")
    _check(z, means, log_var, data_idx, ex_idx, valid)
    if torch.is_grad_enabled() and (z.requires_grad or means.requires_grad
                                    or log_var.requires_grad):
        raise RuntimeError(
            "the pairwise-LSE CUDA kernel is forward-only; for gradients call "
            "ops.exemplar_prior.exemplar_log_prob, whose backward recomputes "
            "the weights, or call this under torch.no_grad().")
    build()
    b, d = z.shape
    n = means.shape[0]
    if d > _lib.pairwise_lse_max_d():
        raise ValueError(f"the kernel takes D <= {_lib.pairwise_lse_max_d()}, "
                         f"got {d}")
    zc = z.to(in_dtype)
    mc = means.to(in_dtype)
    for name, t in (("z", zc), ("means", mc), ("ex_idx", ex_idx),
                    ("valid", valid)) + ((("data_idx", data_idx),)
                                         if data_idx is not None else ()):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty((b,), dtype=torch.float32, device=z.device)
    if b == 0:
        return out
    lv = log_var.reshape(1).contiguous()
    sm = _sm_count.get(z.device.index)
    if sm is None:
        sm = torch.cuda.get_device_properties(z.device).multi_processor_count
        _sm_count[z.device.index] = sm
    code = _DTYPE_CODE[in_dtype]
    scratch = torch.empty((_lib.pairwise_lse_scratch_floats(code, b, n, d, sm),),
                          dtype=torch.float32, device=z.device)
    with torch.cuda.device(z.device):
        err = _lib.pairwise_lse_forward(
            code, zc.data_ptr(), mc.data_ptr(),
            lv.data_ptr(),
            data_idx.data_ptr() if data_idx is not None else None,
            ex_idx.data_ptr(), valid.data_ptr(), b, n, d, sm,
            scratch.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(z.device).cuda_stream)
    if err:
        raise RuntimeError(f"pairwise_lse kernel launch failed: cudaError {err}")
    pairwise_lse.launches += 1
    return out


pairwise_lse.launches = 0
