"""The port's spans (``evae.*`` record_function ranges, which it opens only
while a profiler runs) and its re-encode counter, read from the profiled
stretch.

``reduce(events)`` takes the same ``prof.events()`` as portbench/trace.py
and gives each device operation the spans it belongs to:

* the spans open on the launching host thread when it was launched (the
  CUDA runtime call that shares the operation's correlation id);
* for the device work of a backward function, also the spans of the
  forward operator that made it: the autograd sequence number that the
  profiler records on both (``sequence_nr``, with the backward's
  ``fwd_thread``). So a forward span's time holds its backward's.

``SpanSummary.device_s(name, ...)`` is then the device time of the
operations under a span, clipped to the stretch; host synchronizations are
counted inside ``evae.step`` spans. ``install()`` makes
portbench/trace.py's reduction attach a ``SpanSummary`` to each
``TraceSummary`` it returns (``.spans``), and the re-encode's rows
(``.reencode_rows``: the change of the port's row counter over the
profiled calls, and the distinct rows of the selections it kept), so that
the per-layer readers of ``metrics/`` find them; it logs one line of the
spans' times per unit on standard error. A program with no spans gives a
summary with none, and the readers then read nothing; a reduction that
fails fails the traced run.
"""

from __future__ import annotations

import json
import sys
from dataclasses import dataclass, field

import torch

from portbench import trace

PREFIX = "evae."
STEP = "evae.step"
BACKWARD = "autograd::engine::evaluate_function: "
# host events that wait for the card: a blocking read (.item(), float(),
# bool() of a device tensor) and the runtime's synchronizations
SYNCS = ("aten::_local_scalar_dense", "cudaStreamSynchronize",
         "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")


@dataclass
class SpanSummary:
    # per device operation of the stretch: (seconds clipped to the
    # stretch, spans open at its launch, spans of its forward operator)
    ops: list = field(default_factory=list)
    counts: dict = field(default_factory=dict)   # span name -> ranges
    busy_s: float = 0.0           # union of all device operations
    covered_s: float = 0.0        # union of those under some span
    unlinked: int = 0             # device operations with no launch found
    step_syncs: int = 0           # host syncs inside evae.step ranges
    # every host sync of the stretch: "innermost span > ops > sync" -> count
    sync_sites: dict = field(default_factory=dict)
    idle_by_span: dict = field(default_factory=dict)  # innermost span -> s
    # the idle that portbench/trace.py finds under no host operator (all of
    # it, where its breakdown lists the ten largest buckets)
    no_host_op_s: float = 0.0

    def count(self, name: str) -> int:
        return self.counts.get(name, 0)

    def device_s(self, name: str, *, within: str = None,
                 without: str = None) -> float:
        """Device seconds of the operations under span ``name`` (launched
        inside it, or the backward of a forward operator inside it), only
        those also under ``within`` and not under ``without``."""
        total = 0.0
        for sec, launch, fwd in self.ops:
            under = launch | fwd
            if (name in under and (within is None or within in under)
                    and (without is None or without not in under)):
                total += sec
        return total

    def table(self, units: int) -> dict:
        """{span: [ms a unit launched inside, ms a unit of its backward]}."""
        names = sorted(self.counts)
        out = {}
        for n in names:
            fwd = sum(s for s, launch, _ in self.ops if n in launch)
            bwd = sum(s for s, launch, f in self.ops
                      if n in f and n not in launch)
            out[n] = [round(1e3 * fwd / units, 4), round(1e3 * bwd / units, 4)]
        return out


def _stacks(intervals, points):
    """For each of the sorted ``points``, the intervals (start, end, tag)
    of one thread that contain it, outermost first; intervals of one thread
    nest."""
    intervals = sorted(intervals, key=lambda h: (h[0], -h[1]))
    out, stack, i = [], [], 0
    for p in points:
        while i < len(intervals) and intervals[i][0] <= p:
            while stack and stack[-1][1] <= intervals[i][0]:
                stack.pop()
            stack.append(intervals[i])
            i += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        out.append(list(stack))
    return out


def _by_thread(items):
    out = {}
    for thread, iv in items:
        out.setdefault(thread, []).append(iv)
    return out


def _locate(intervals_by_thread, queries):
    """{query key: enclosing intervals, outermost first} for queries
    (key, thread, time): on the query's own thread, or, where that thread
    holds none, on the thread whose innermost enclosing interval is
    shortest."""
    per_thread = _by_thread((q[1], (q[2], q[0])) for q in queries)
    found = {}
    for thread, qs in per_thread.items():
        qs.sort()
        ivs = intervals_by_thread.get(thread)
        if ivs:
            for (t, key), st in zip(qs, _stacks(ivs, [t for t, _ in qs])):
                found[key] = st
    rest = sorted((q[2], q[0]) for q in queries if not found.get(q[0]))
    if rest:
        best = {key: [] for _, key in rest}
        for ivs in intervals_by_thread.values():
            for (_, key), st in zip(rest, _stacks(ivs, [t for t, _ in rest])):
                if st and (not best[key] or st[-1][1] - st[-1][0]
                           < best[key][-1][1] - best[key][-1][0]):
                    best[key] = st
        found.update(best)
    return found


def _union_s(intervals) -> float:
    return sum(e - s for s, e in trace._union(intervals)) / 1e6


def reduce(events) -> SpanSummary:
    cuda = torch.autograd.DeviceType.CUDA
    cpu = torch.autograd.DeviceType.CPU
    host = [e for e in events if e.device_type == cpu]
    stretch = [e for e in host if e.name == trace.SPAN]
    if stretch:
        lo, hi = stretch[0].time_range.start, stretch[0].time_range.end
    else:
        lo, hi = float("-inf"), float("inf")

    spans, backward, launches, forward, syncs, ops = [], [], {}, {}, [], []
    for e in host:
        s, t = e.time_range.start, e.time_range.end
        name = e.name
        if name.startswith(PREFIX):
            spans.append((e.thread, (s, t, name)))
        elif name.startswith(BACKWARD):
            if e.sequence_nr >= 0:
                backward.append((e.thread, (s, t, (e.fwd_thread,
                                                   e.sequence_nr))))
        elif trace._is_runtime(name):
            launches[e.id] = (e.thread, s)
        if name in SYNCS:
            syncs.append(e)
        if (e.sequence_nr >= 0 and not name.startswith(BACKWARD)
                and not name.startswith(PREFIX) and "Backward" not in name):
            key = (e.thread, e.sequence_nr)
            # the latest operator of a sequence number made its node
            if key not in forward or forward[key][0] <= s:
                forward[key] = (s, e.thread)
    span_ivs = _by_thread(spans)
    bwd_ivs = _by_thread(backward)
    out = SpanSummary()
    for _, (s, t, name) in spans:
        if t > lo and s < hi:
            out.counts[name] = out.counts.get(name, 0) + 1

    # the spans of each forward operator that has a sequence number
    fwd_at = _locate(span_ivs, [(key, th, s) for key, (s, th)
                                in forward.items()])
    fwd_spans = {k: frozenset(iv[2] for iv in st) for k, st in fwd_at.items()}

    device = [e for e in events if e.device_type == cuda
              and not getattr(e, "is_user_annotation", False)]
    queries = []
    for i, e in enumerate(device):
        at = launches.get(e.id)
        if at is None:
            out.unlinked += 1
        else:
            queries.append((i, at[0], at[1]))
    at_span = _locate(span_ivs, queries)
    at_bwd = {}
    for thread, qs in _by_thread((q[1], (q[2], q[0])) for q in queries
                                 ).items():
        qs.sort()
        for (_, i), st in zip(qs, _stacks(bwd_ivs.get(thread, []),
                                          [t for t, _ in qs])):
            if st:
                at_bwd[i] = st[-1][2]
    covered, everything = [], []
    for i, e in enumerate(device):
        s, t = max(e.time_range.start, lo), min(e.time_range.end, hi)
        if t <= s:
            continue
        launch = frozenset(iv[2] for iv in at_span.get(i, ()))
        fwd = fwd_spans.get(at_bwd.get(i), frozenset())
        ops.append(((t - s) / 1e6, launch, fwd))
        everything.append((s, t))
        if launch or fwd:
            covered.append((s, t))
    out.ops = ops
    out.busy_s = _union_s(everything)
    out.covered_s = _union_s(covered)

    # host syncs inside evae.step ranges: the outermost sync event of a
    # nest (a read's own cudaStreamSynchronize counts with the read)
    host_ivs = _by_thread((e.thread, (e.time_range.start, e.time_range.end,
                                      e.name))
                          for e in host if not e.name.startswith(PREFIX)
                          and not trace._is_runtime(e.name)
                          and e.name != trace.SPAN)
    sync_q = [(j, e.thread, e.time_range.start) for j, e in enumerate(syncs)
              if lo < e.time_range.start < hi]
    sync_spans = _locate(span_ivs, sync_q)
    sync_ops = _locate(host_ivs, sync_q)
    for j, _, _ in sync_q:
        names = [iv[2] for iv in sync_spans.get(j, ())]
        ops_around = [iv[2] for iv in sync_ops.get(j, ())
                      if iv[2] != syncs[j].name]
        if any(n in SYNCS for n in ops_around):
            continue
        out.step_syncs += STEP in names
        site = " > ".join(names[-1:] or ["(no span)"]) + " > " + " > ".join(
            ops_around[-2:] + [syncs[j].name])
        out.sync_sites[site] = out.sync_sites.get(site, 0) + 1

    # the idle gaps of the card by the innermost span open on any thread
    merged = trace._union(everything)
    edges = ([lo if stretch else (merged[0][0] if merged else 0.0)]
             + [x for iv in merged for x in iv]
             + [hi if stretch else (merged[-1][1] if merged else 0.0)])
    gaps = sorted(((edges[k] + edges[k + 1]) / 2, edges[k + 1] - edges[k])
                  for k in range(0, len(edges), 2) if edges[k + 1] > edges[k])
    best = [None] * len(gaps)
    for ivs in span_ivs.values():
        for k, st in enumerate(_stacks(ivs, [m for m, _ in gaps])):
            if st and (best[k] is None or st[-1][1] - st[-1][0]
                       < best[k][1] - best[k][0]):
                best[k] = st[-1]
    for (_, dur), iv in zip(gaps, best):
        key = iv[2] if iv is not None else "(no span)"
        out.idle_by_span[key] = out.idle_by_span.get(key, 0.0) + dur / 1e6
    ops_by_thread = {}
    for e in host:
        if e.name != trace.SPAN and not trace._is_runtime(e.name):
            ops_by_thread.setdefault(e.thread, []).append(
                (e.time_range.start, e.time_range.end, e.name))
    named = trace._host_at(ops_by_thread, [m for m, _ in gaps])
    out.no_host_op_s = sum(dur for (_, dur), n in zip(gaps, named)
                           if n is None) / 1e6
    return out


def reencode_rows():
    """(rows, distinct rows) of the approximate prior's re-encode over the
    calls made under the profiler: the change of the port's counter
    ``approx_log_p_top.rows`` since the first of them, and the distinct
    rows of each call's kept selection, which the port then forgets. None
    where the port keeps none."""
    try:
        from exemplar_vae_tpu_torch.train.loss import approx_log_p_top
    except ImportError:
        return None
    kept = getattr(approx_log_p_top, "kept", None)
    if kept is None or not hasattr(approx_log_p_top, "rows"):
        return None
    calls = list(kept)
    kept.clear()
    if not calls:
        return None
    rows = approx_log_p_top.rows - calls[0][0]
    distinct = sum(int(torch.unique(sel).numel()) for _, sel in calls)
    return rows, distinct


def _log(summary, spans):
    if not spans.counts:
        return
    units = max(spans.count(STEP), spans.count("evae.iwae.chunk"), 1)
    line = {"units": units, "ms_per_unit [launched, backward]":
            spans.table(units),
            "coverage_pct": round(100 * spans.covered_s
                                  / max(spans.busy_s, 1e-12), 3),
            "unlinked_ops": spans.unlinked, "step_syncs": spans.step_syncs,
            "sync_sites": spans.sync_sites,
            "no_host_operator_ms": round(1e3 * spans.no_host_op_s, 4),
            "idle_ms_by_span": {k: round(1e3 * v, 4) for k, v in sorted(
                spans.idle_by_span.items(), key=lambda kv: -kv[1])[:10]},
            "reencode_rows": getattr(summary, "reencode_rows", None)}
    print("[portbench] spans " + json.dumps(line), file=sys.stderr,
          flush=True)


def install():
    """Wrap portbench/trace.py's ``summarize`` (once) so that each
    TraceSummary carries ``.spans`` and ``.reencode_rows``."""
    if getattr(trace.summarize, "_with_spans", False):
        return
    plain = trace.summarize

    def summarize(events, wall_s):
        summary = plain(events, wall_s)
        summary.spans = reduce(events)
        summary.reencode_rows = reencode_rows()
        _log(summary, summary.spans)
        return summary

    summarize._with_spans = True
    trace.summarize = summarize


def spans_of(r, kind: str, device: bool = True):
    """The SpanSummary of a traced run of ``kind`` that holds the port's
    spans (and, with ``device``, device operations), else None."""
    if r.kind != kind or r.trace is None:
        return None
    s = getattr(r.trace, "spans", None)
    if s is None or not s.counts or (device and not s.ops):
        return None
    return s
