"""Tracing, timing and the NaN detector (counterpart of
exemplar_vae_tpu/train/profiling.py).

* ``trace(dir)``: a torch.profiler trace of the enclosed block (host
  operators, and the card's kernels when a card is present), written as a
  Chrome trace to ``<dir>/trace.json`` (Perfetto, chrome://tracing);
* ``nan_debug()``: autograd's anomaly detection with NaN checks. It raises
  when a backward function returns NaN, naming the forward op that made
  it; a NaN that appears in the forward pass raises only once it reaches
  the backward (JAX's ``jax_debug_nans`` raises at the producing forward
  op);
* ``fetch_sync(out)``: synchronize the device, then fetch one element to
  the host; the end of a timed region;
* ``StepTimer``: a throughput meter (images/s, exemplar distances/s).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


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


def nan_debug(enable: bool = True):
    """Turn autograd's anomaly detection (with NaN checks) on or off.
    Called, it sets the mode for the process; used as a context manager,
    it restores the previous mode on exit."""
    return torch.autograd.set_detect_anomaly(enable, check_nan=True)


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    for leaf in out:
        t = _first_tensor(leaf)
        if t is not None:
            return t
    return None


def fetch_sync(out) -> float:
    """Wait for the device, then copy one element of the first tensor in
    ``out`` (a tensor, or a list, tuple or dict holding tensors) to the
    host and return it."""
    leaf = _first_tensor(out)
    if leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)
    return float(leaf.reshape(-1)[0])


class StepTimer:
    """Throughput meter around steps whose regions end in a sync:

        t = StepTimer(images_per_step=batch, distances_per_step=batch * n)
        with t:
            out = step(...)
            fetch_sync(out)
        t.images_per_sec, t.distances_per_sec
    """

    def __init__(self, images_per_step: int = 0, distances_per_step: int = 0):
        self.images_per_step = images_per_step
        self.distances_per_step = distances_per_step
        self.total_seconds = 0.0
        self.steps = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.total_seconds += time.perf_counter() - self._t0
        self.steps += 1
        return False

    @property
    def seconds_per_step(self) -> float:
        return self.total_seconds / max(self.steps, 1)

    @property
    def images_per_sec(self) -> float:
        return self.images_per_step * self.steps / max(self.total_seconds, 1e-12)

    @property
    def distances_per_sec(self) -> float:
        return (self.distances_per_step * self.steps
                / max(self.total_seconds, 1e-12))

    def report(self) -> dict:
        return {
            "steps": self.steps,
            "seconds_per_step": self.seconds_per_step,
            "images_per_sec": self.images_per_sec,
            "distances_per_sec": self.distances_per_sec,
        }
