"""Readings that a cell's limits are set from (not run by run.py).

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,... \
        --control-seeds 7,8,9

For each of ``--seeds`` the program's first steps (train cells) or
``checked_requests`` requests (score cells) at the cell's own sizes against
the plain reference: the lower readings. For each of ``--control-seeds``
the control, the reference computed with TF32 on, against the reference in
fp32, and for train cells the fault that leaves out half of each batch,
planted in the reference: the upper readings. One JSON line per reading,
then a summary line; with ``--out`` the lines also go to that file.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

import run  # noqa: E402
from portbench import compare, manifest  # noqa: E402
from portbench.common import release  # noqa: E402


class _Selections:
    """Diagnostic only: records the kNN rows that the port's and the
    reference's approximate prior select, by wrapping their selection
    functions for the duration of a ``with`` block."""

    def __init__(self, ref_cls):
        from exemplar_vae_tpu_torch.train import loss
        self.loss, self.ref_cls = loss, ref_cls
        self.program, self.reference = [], []

    def __enter__(self):
        self.real = self.loss.knn_indices, self.ref_cls.knn

        def prog(*a, **kw):
            idx = self.real[0](*a, **kw)
            self.program.append(idx.clone())
            return idx

        def ref(obj, q_mean, k):
            idx = self.real[1](obj, q_mean, k)
            self.reference.append(idx.clone())
            return idx
        self.loss.knn_indices, self.ref_cls.knn = prog, ref
        return self

    def __exit__(self, *exc):
        self.loss.knn_indices, self.ref_cls.knn = self.real

    def differing_rows(self):
        """Per step, the batch rows whose selected sets differ."""
        return [int(sum(set(a.tolist()) != set(b.tolist())
                        for a, b in zip(p, r)))
                for p, r in zip(self.program, self.reference)]


def _train(ctx, kind, program_side: bool, control_side: bool):
    out = []
    inputs = kind.make_inputs(ctx)
    want = None
    if program_side:
        approx = ctx.config["program"]["approximate_prior"]
        sel = _Selections(ctx.reference.Reference) if approx else None
        with sel or contextlib.nullcontext():
            prog = kind.Program(ctx, inputs)
            got = kind.first_steps(prog, inputs)
            del prog
            release()
            want = kind.reference_outputs(ctx, inputs)
        extra = _worst(got, want)
        if sel:
            extra["knn_rows_differing"] = sel.differing_rows()
        out.append(("program", _all(kind, got, want), extra))
    if control_side:
        want = want or kind.reference_outputs(ctx, inputs)
        for name, kw in (("control_tf32", dict(tf32=True)),
                         ("fault_half_batch", dict(half_batch=True))):
            got = kind.reference_outputs(ctx, inputs, **kw)
            out.append((name, _all(kind, got, want), _worst(got, want)))
    return out


def _all(kind, got, want):
    """Every number the kind can compare, whatever the limits name."""
    return [(n, v, None) for n, v in kind.numbers(got, want).items()]


def _worst(got, want):
    skip = compare.negligible_leaves(want["grads"])
    return {"grad_leaf": compare.worst_leaf(got["grads"], want["grads"])[1],
            "change_leaf": compare.worst_leaf(got["change"], want["change"],
                                              skip)[1],
            "negligible": sorted(skip), "losses": got["losses"],
            "ref_losses": want["losses"]}


def _score(ctx, kind, program_side: bool, control_side: bool):
    out = []
    inputs = kind.make_inputs(ctx)
    ids = list(range(ctx.traffic["checked_requests"]))
    want = None
    if program_side:
        prog = kind.Program(ctx, inputs)
        got = {i: kind.serve(ctx, prog, inputs, i) for i in ids}
        del prog
        release()
        want = kind.reference_nlls(ctx, inputs, ids)
        out.append(("program", kind.checks(ctx, got, want), {}))
    if control_side:
        want = want or kind.reference_nlls(ctx, inputs, ids)
        got = kind.reference_nlls(ctx, inputs, ids, tf32=True)
        out.append(("control_tf32", kind.checks(ctx, got, want), {}))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch
    root = HERE.parent
    cell = manifest.resolve(manifest.load(root), root, args.workload)
    kind = manifest.kind(cell.traffic)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    fn = _train if kind.KIND == "train" else _score
    sink = open(args.out, "a") if args.out else None
    summary = {}
    for seed in dict.fromkeys(seeds + controls):
        t0 = time.perf_counter()
        ctx = run.context(cell, seed=seed, seconds=0, trace=False,
                          device=torch.device("cuda", 0), t0=t0)
        for side, checks, extra in fn(ctx, kind, seed in seeds,
                                      seed in controls):
            line = {"workload": args.workload, "seed": seed, "side": side,
                    "readings": {n: v for n, v, _ in checks},
                    "seconds": time.perf_counter() - t0, **extra}
            text = json.dumps(line)
            print(text, flush=True)
            if sink:
                sink.write(text + "\n")
            for n, v, _ in checks:
                s = summary.setdefault(side, {}).setdefault(n, [])
                s.append(v)
        release()
    line = {"workload": args.workload, "summary": {
        side: {n: {"max": max(v), "min": min(v), "n": len(v)}
               for n, v in d.items()} for side, d in summary.items()}}
    print(json.dumps(line), flush=True)
    if sink:
        sink.write(json.dumps(line) + "\n")
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
