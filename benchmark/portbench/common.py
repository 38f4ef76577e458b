"""Seeds, peaks, the module and device checks, and the run context."""

from __future__ import annotations

import hashlib
import sys
from dataclasses import dataclass, field
from typing import Any, Optional

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W. The
# FLOP peak is the TF32 tensor-core rate: the port's fp32 work can reach
# more than the 67 TFLOP/s of the fp32 SIMT pipes (the kernel's
# error-compensated TF32 products), so a share of that rate could pass
# 100%; no fp32-accurate route reaches 495.
PEAK_FLOPS = 495e12
PEAK_HBM_BYTES_PER_S = 3.35e12

# top-level module names that no run of the port may load
BANNED_MODULES = ("jax", "jaxlib", "flax", "optax", "exemplar_vae_tpu")


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed derived from ``seed`` and ``tags`` alone (stable across
    processes, unlike hash())."""
    text = ":".join(str(t) for t in (seed,) + tags)
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") >> 1


def banned_loaded(modules=None) -> list:
    """The banned top-level names among ``modules`` (default sys.modules),
    each compared whole: ``exemplar_vae_tpu_torch`` is not
    ``exemplar_vae_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(BANNED_MODULES))


def release():
    """Return to the device the memory of what the caller has dropped."""
    import gc

    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


@dataclass
class RunContext:
    """What one run of one cell is given: the cell's files as the manifest
    resolved them, the command line, and the process's start time."""
    workload: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: Any                       # torch.device
    t0: float                         # time.perf_counter() at process start
    reference: Any                    # portbench.reference.<family> module
    flops: Any                        # portbench.flops.<family> module
    readers: dict = field(default_factory=dict)   # per-layer name -> module
    log: Any = None                   # callable(str) for progress lines

    def say(self, msg: str):
        if self.log is not None:
            self.log(msg)

    def mark(self, stage: str):
        """Log how far into the process ``stage`` ended."""
        import time
        self.say(f"{stage} at {time.perf_counter() - self.t0:.3f} s")


@dataclass
class Readings:
    """What the per-layer readers read from a traced run: the profiled
    stretch (``units`` steps or requests), its trace, the counters read
    around it, and the untimed window before it."""
    kind: str                         # "train" or "score"
    units: int
    trace: Optional[Any]              # portbench.trace.TraceSummary
    window_s: float
    window_units: int
    flops_per_unit: float
    lse_calls_per_unit: list          # [(B, N, D, loo)] per step or request
    lse_launches: int                 # the program's counter over the stretch
