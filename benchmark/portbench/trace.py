"""Profile a short stretch of the timed path and reduce the trace.

``profile_stretch`` runs a callable under torch.profiler (CPU and CUDA
activities), kept in memory, and returns a ``TraceSummary``: the stretch's
host-clock length, the union of the device operations' intervals (busy
time), every device operation with its name and interval, the device
operations that took most time, and the idle gaps of the device grouped by
the host operator that was running in each."""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

SPAN = "portbench.stretch"
TOP = 10
NAME_CHARS = 120


@dataclass
class TraceSummary:
    window_s: float                  # host clock, synchronized at both ends
    busy_s: float                    # union of device-op intervals
    device_events: list = field(default_factory=list)  # (name, start, end) us
    top_ops: list = field(default_factory=list)        # [name, seconds]
    idle_gaps: list = field(default_factory=list)      # [host op, seconds]

    @property
    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def device_seconds(self, match) -> tuple:
        """(seconds, count) of the device operations whose name ``match``
        accepts."""
        hits = [(e - s) for name, s, e in self.device_events if match(name)]
        return sum(hits) / 1e6, len(hits)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile_stretch(fn, device):
    """(fn's result, TraceSummary) of one call of ``fn`` under the
    profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        _sync(device)
        t0 = time.perf_counter()
        with record_function(SPAN):
            out = fn()
            _sync(device)
        wall = time.perf_counter() - t0
    return out, summarize(prof.events(), wall)


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _innermost(host, points):
    """For each of the sorted ``points``, the innermost host interval
    (start, end, name) of one thread that contains it, or None; the
    intervals of one thread nest."""
    host = sorted(host, key=lambda h: (h[0], -h[1]))
    out, stack, i = [], [], 0
    for p in points:
        while i < len(host) and host[i][0] <= p:
            while stack and stack[-1][1] <= host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def _host_at(host_by_thread: dict, points):
    """For each sorted point, the name of the shortest host operator that
    contains it on any thread (the autograd engine runs the backward's
    operators on a thread of its own), or None."""
    best = [None] * len(points)
    for host in host_by_thread.values():
        for j, iv in enumerate(_innermost(host, points)):
            if iv is not None and (best[j] is None
                                   or iv[1] - iv[0] < best[j][1] - best[j][0]):
                best[j] = iv
    return [None if iv is None else iv[2] for iv in best]


def _is_runtime(name: str) -> bool:
    """CUDA runtime and driver calls (cudaLaunchKernel, cuLaunchKernel):
    their enclosing operator says more about the layer."""
    return name.startswith("cuda") or (name.startswith("cu")
                                       and name[2:3].isupper())


def summarize(events, wall_s: float) -> TraceSummary:
    cuda = torch.autograd.DeviceType.CUDA
    cpu = torch.autograd.DeviceType.CPU
    # the device side of a record_function range is an annotation, no work
    device = [(e.name, e.time_range.start, e.time_range.end)
              for e in events if e.device_type == cuda
              and not getattr(e, "is_user_annotation", False)]
    spans = [e for e in events if e.name == SPAN and e.device_type == cpu]
    if spans:
        lo, hi = spans[0].time_range.start, spans[0].time_range.end
    else:
        lo = min((s for _, s, _ in device), default=0.0)
        hi = max((e for _, _, e in device), default=0.0)
    merged = _union([(max(s, lo), min(e, hi)) for _, s, e in device
                     if e > lo and s < hi])
    busy_us = sum(e - s for s, e in merged)

    per_name = {}
    for name, s, e in device:
        key = name[:NAME_CHARS]
        per_name[key] = per_name.get(key, 0.0) + (e - s) / 1e6
    top_ops = sorted(([k, v] for k, v in per_name.items()),
                     key=lambda kv: -kv[1])[:TOP]

    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    host = {}
    for e in events:
        if (e.device_type == cpu and e.name != SPAN
                and not _is_runtime(e.name)):
            host.setdefault(e.thread, []).append(
                (e.time_range.start, e.time_range.end, e.name))
    mids = sorted(((s + e) / 2, e - s) for s, e in gaps)
    names = _host_at(host, [m for m, _ in mids])
    by_host = {}
    for (_, dur), name in zip(mids, names):
        key = (name or "(no host operator)")[:NAME_CHARS]
        by_host[key] = by_host.get(key, 0.0) + dur / 1e6
    idle_gaps = sorted(([k, v] for k, v in by_host.items()),
                       key=lambda kv: -kv[1])[:TOP]
    return TraceSummary(window_s=wall_s, busy_s=busy_us / 1e6,
                        device_events=device, top_ops=top_ops,
                        idle_gaps=idle_gaps)
