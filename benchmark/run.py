"""The benchmark of exemplar_vae_tpu_torch, one cell per run.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout that holds the port. The cell, its
configuration, traffic and metrics come from BENCHMARK.json (see
portbench/manifest.py). The run makes its data and weights on the card from
the seed, warms up, measures for ``--seconds``, checks what the timed path
produced against the plain reference, and prints one JSON line last on
standard output; the numbers compared, each with its limit, are the last
lines on standard error and the last key of that line. ``--trace 1`` times
the same window, then profiles a short stretch and reports the per-layer
metrics instead of the end-to-end ones.

The run exits with a code other than 0, and prints no result, without a
CUDA card (or fewer than the cell asks for), without the port beside the
benchmark, or if JAX or the JAX package (exemplar_vae_tpu) is loaded when
it ends.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(ROOT))

from portbench import compare, manifest  # noqa: E402
from portbench.common import RunContext, banned_loaded  # noqa: E402

NO_CARD, NO_PROGRAM, BANNED = 2, 3, 4


def log(msg: str):
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def context(cell, *, seed, seconds, trace, device, t0=T0) -> RunContext:
    reference, flops = manifest.family(cell.config)
    readers = ({name: manifest.reader(name) for name, _ in cell.per_layer}
               if trace else {})
    return RunContext(workload=cell.name, config=cell.config,
                      traffic=cell.traffic, seed=seed, seconds=seconds,
                      trace=trace, device=device, t0=t0, reference=reference,
                      flops=flops, readers=readers, log=log)


def run_cell(cell, ctx) -> dict:
    """Drive the cell (everything but the look for a card) and return the
    result line as a dict."""
    import torch
    out = manifest.kind(cell.traffic).run(ctx)
    checks = out["checks"]
    correct = (compare.passed(checks) and out["failed"] == 0
               and out["attempted"] > 0)
    dev = ctx.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else dev.type),
              "count": cell.chips,
              "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"])}
    if ctx.trace:
        r = out["readings"]
        metrics = {}
        for name, unit in cell.per_layer:
            value = ctx.readers[name].read(r)
            if value is not None:
                metrics[name] = {"value": value, "unit": unit}
        result["metrics"] = metrics
        device.update(busy_s=r.trace.busy_s, window_s=r.trace.window_s)
        result["device"] = device
        result["breakdown"] = {"device_ops": r.trace.top_ops,
                               "idle_gaps": r.trace.idle_gaps}
    else:
        result["metrics"] = {name: {"value": out["e2e"][name], "unit": unit}
                             for name, unit in cell.end_to_end}
        result["device"] = device
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in checks}
    return result


def pin_threads(cores: int = 2):
    """Keep this process's threads (the host loop, autograd's device
    thread, the driver's) on the last ``cores`` CPUs it may use: the host
    loop of a host-bound cell then reads steadier than when the scheduler
    moves it between CPUs that other work shares."""
    try:
        cpus = sorted(os.sched_getaffinity(0))
        os.sched_setaffinity(0, cpus[-cores:])
    except OSError as e:
        log(f"threads not pinned: {e}")


def main(argv=None) -> int:
    pin_threads()
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    cell = manifest.resolve(manifest.load(ROOT), ROOT, args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"the cell needs {cell.chips} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return NO_CARD
    try:
        import exemplar_vae_tpu_torch  # noqa: F401
    except ImportError as e:
        log(f"the port exemplar_vae_tpu_torch is not beside the benchmark: {e}")
        return NO_PROGRAM
    torch.set_num_threads(1)
    ctx = context(cell, seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace), device=torch.device("cuda", 0))
    result = run_cell(cell, ctx)
    found = banned_loaded()
    if found:
        log(f"modules that the port must not load are loaded: {found}")
        return BANNED
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
