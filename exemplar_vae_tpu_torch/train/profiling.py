"""Tracing, the layers' spans and the NaN detector (counterpart of
exemplar_vae_tpu/train/profiling.py).

* ``trace(dir)``: a torch.profiler trace of the enclosed block (host
  operators, and the card's kernels when a card is present), written as a
  Chrome trace to ``<dir>/trace.json`` (Perfetto, chrome://tracing);
* ``span(name)``: a named range of one of the port's layers
  (``evae.step``, ``evae.prior.reencode``, ``evae.iwae.round`` ...) on the
  profiler's clock, beside the operators and kernels it encloses. It
  records only while a torch.profiler runs (``trace``, or any other
  ``torch.profiler.profile``); otherwise it is one shared null context;
* ``nan_debug()``: autograd's anomaly detection with NaN checks. It raises
  when a backward function returns NaN, naming the forward op that made
  it; a NaN that appears in the forward pass raises only once it reaches
  the backward (JAX's ``jax_debug_nans`` raises at the producing forward
  op).
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.autograd import profiler as _autograd_profiler

_NULL = contextlib.nullcontext()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block into ``<log_dir>/trace.json``."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def profiler_active() -> bool:
    """Whether a torch.profiler is recording now (the flag torch's own fast
    paths read)."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str):
    """``with span("evae.prior.knn"): ...``: a ``record_function`` range
    while a profiler is active, else the shared null context. It adds no
    device work and no sync."""
    if profiler_active():
        return torch.profiler.record_function(name)
    return _NULL


def nan_debug(enable: bool = True):
    """Turn autograd's anomaly detection (with NaN checks) on or off.
    Called, it sets the mode for the process; used as a context manager,
    it restores the previous mode on exit."""
    return torch.autograd.set_detect_anomaly(enable, check_nan=True)
