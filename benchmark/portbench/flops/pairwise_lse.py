"""The least time of one pairwise log-sum-exp call, whatever implements it.

A call takes z (B, D), the means (N, D), the exemplar indices (N,) int32,
the valid mask (N,) bool, the scalar log-variance, with leave-one-out the
row indices (B,) int32, and writes (B,) fp32. Bytes: each input read once
and the output written once (the byte count of chip_smoke.py's
lse_bound_ms). Operations: the cross term, 2 B N D FLOPs, at the dense
TF32 peak. Neither an SFU term nor a multiplier for a split into several
TF32 products: the share reads the same work whatever route computes it.
"""

from __future__ import annotations

import re

from portbench.common import PEAK_FLOPS, PEAK_HBM_BYTES_PER_S

# the kernel's device functions as the trace names them (prep, partial
# and merge passes of csrc/pairwise_lse.cu)
KERNEL_NAME = re.compile(r"(?<![A-Za-z0-9_])lse_[a-z]+_kernel")


def call_bytes(b: int, n: int, d: int, loo: bool, elem: int = 4) -> int:
    return ((b * d + n * d) * elem + n * 4 + n + 4 + b * 4
            + (b * 4 if loo else 0))


def call_flops(b: int, n: int, d: int) -> float:
    return 2.0 * b * n * d


def bound_s(b: int, n: int, d: int, loo: bool) -> float:
    """max(bytes / HBM rate, FLOPs / TF32 peak), in seconds."""
    return max(call_bytes(b, n, d, loo) / PEAK_HBM_BYTES_PER_S,
               call_flops(b, n, d) / PEAK_FLOPS)


def is_kernel(name: str) -> bool:
    return KERNEL_NAME.search(name) is not None
