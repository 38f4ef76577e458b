"""What the per-layer readers (``metrics/<name>.py``) share. Each takes a
``portbench.common.Readings`` and returns a number, or None where its cell
gives it nothing to read (another kind of traffic, or a kernel that did
not run); no share is ever returned as 0 for want of a reading."""

from __future__ import annotations

from portbench.common import PEAK_FLOPS
from portbench.flops import pairwise_lse


def idle_pct(r, kind: str):
    if r.kind != kind or r.trace is None:
        return None
    return r.trace.idle_pct


def launches_per_step(r, kind: str):
    if r.kind != kind or r.trace is None or not r.trace.device_events:
        return None
    return len(r.trace.device_events) / r.units


def mfu(r, kind: str):
    if r.kind != kind:
        return None
    return 100.0 * r.flops_per_unit * r.window_units / r.window_s / PEAK_FLOPS


def lse_roofline(r, kind: str):
    if r.kind != kind or r.trace is None:
        return None
    seconds, found = r.trace.device_seconds(pairwise_lse.is_kernel)
    if not found:
        return None
    calls = list(r.lse_calls_per_unit) * r.units
    if r.lse_launches != len(calls):
        raise RuntimeError(
            f"the port counted {r.lse_launches} pairwise-LSE launches in the "
            f"profiled stretch; the cell makes {len(calls)} calls")
    bound = sum(pairwise_lse.bound_s(*call) for call in calls)
    return 100.0 * bound / seconds
