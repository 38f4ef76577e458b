"""Resolve a cell of BENCHMARK.json to its files, by name alone.

A workload names a configuration and a traffic mix. The configuration's
``file`` holds the sizes as they are run and names its model ``family``:
``portbench/reference/<family>.py`` (the plain reference) and
``portbench/flops/<family>.py`` (its FLOP counter). The traffic is
``traffic/<traffic>.json``, whose ``kind`` names its driver,
``portbench/kinds/<kind>.py``. Each per-layer metric is read by
``metrics/<name>.py``. A cell reports the end-to-end metrics that list it
(or that list no workloads), and the per-layer metrics that list it (or,
listing none, move an end-to-end metric that the cell reports)."""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list        # [(name, unit)]
    per_layer: list         # [(name, unit)]


def load(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def reports(metric: dict, cell: str, e2e_of_cell=None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_of_cell is None or metric.get("moves") in e2e_of_cell


def resolve(manifest: dict, root: Path, workload: str,
            bench_dir: Path = BENCH_DIR) -> Cell:
    w = _by_name(manifest["workloads"], workload, "workload")
    conf = _by_name(manifest["configs"], w["config"], "configuration")
    config = json.loads((Path(root) / conf["file"]).read_text())
    traffic = json.loads(
        (Path(bench_dir) / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [(m["name"], m["unit"]) for m in manifest["end_to_end"]
           if reports(m, workload)]
    names = {n for n, _ in e2e}
    per_layer = [(m["name"], m["unit"]) for m in manifest["per_layer"]
                 if reports(m, workload, names)]
    return Cell(workload, int(w["chips"]), config, traffic, e2e, per_layer)


def kind(traffic: dict):
    return importlib.import_module(f"portbench.kinds.{traffic['kind']}")


def family(config: dict):
    """(reference module, FLOP-counter module) of the config's family."""
    fam = config["family"]
    return (importlib.import_module(f"portbench.reference.{fam}"),
            importlib.import_module(f"portbench.flops.{fam}"))


def reader(metric: str, bench_dir: Path = BENCH_DIR):
    """The per-layer metric's reader module, ``metrics/<name>.py``."""
    path = Path(bench_dir) / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
