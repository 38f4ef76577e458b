"""The numbers that decide ``correct``, each held to its limit."""

from __future__ import annotations

import math
import statistics

# a leaf whose reference gradient norm is under this share of the median
# leaf's moves under AdamNormGrad by round-off alone (its normalized
# gradient is noise): it is left out of the parameters' change
NEGLIGIBLE_GRAD = 1e-3


def relative_gap(prog, ref) -> float:
    """The widest |prog - ref| / |ref| over paired values."""
    gaps = [abs(p - r) / abs(r) for p, r in zip(prog, ref, strict=True)]
    return max(gaps) if gaps else math.inf


def negligible_leaves(ref_grad_norms: dict) -> set:
    med = statistics.median(ref_grad_norms.values())
    return {k for k, v in ref_grad_norms.items() if v < NEGLIGIBLE_GRAD * med}


def worst_leaf(prog: dict, ref: dict, skip=()) -> tuple:
    """(gap, leaf): the largest |prog norm - ref norm| over the leaves,
    each against the larger of its reference norm and the median leaf's
    reference norm. A leaf the program lacks reads 1."""
    med = statistics.median(ref.values())
    worst = (0.0, None)
    for k, r in ref.items():
        if k in skip:
            continue
        p = prog.get(k, 0.0)
        gap = abs(p - r) / max(r, med) if max(r, med) > 0 else abs(p)
        if not gap <= worst[0]:          # NaN counts as the worst
            worst = (gap, k)
    return worst


def median_leaf(prog: dict, ref: dict, skip=()) -> float:
    """The median over the leaves of the gap worst_leaf takes the largest
    of."""
    med = statistics.median(ref.values())
    return statistics.median(
        abs(prog.get(k, 0.0) - r) / max(r, med) for k, r in ref.items()
        if k not in skip)


def passed(checks) -> bool:
    """Every (name, value, limit) holds: value finite and <= limit."""
    return bool(checks) and all(math.isfinite(v) and v <= lim
                                for _, v, lim in checks)
