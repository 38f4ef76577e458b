"""BENCHMARK.json against the benchmark's contract, and the harness's
look-ups by name: every cell resolves to its files, and a cell added by
data files alone runs with no edit to the harness."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest
from conftest import BENCH, ROOT, cpu_context, tiny

from portbench import manifest
from portbench.common import banned_loaded

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
M = manifest.load(ROOT)


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_names():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["paths"] == ["benchmark"] and M["command"][1] == "benchmark/run.py"
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in M[k]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in M["workloads"]]:
        assert NAME.fullmatch(n), n
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in M["end_to_end"])
    for e in M["configs"] + M["workloads"]:
        assert _line(e["why"])
    assert len(json.dumps(M)) < 64 * 1024


def test_every_file_lies_under_paths_and_is_named_from_name_characters():
    for dirpath, _, files in os.walk(BENCH):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel
    for c in M["configs"]:
        assert c["file"].startswith("benchmark/")


def test_each_per_layer_metric_s_cells_report_what_it_moves():
    for m in M["per_layer"]:
        moves = next(e for e in M["end_to_end"] if e["name"] == m["moves"])
        for w in m["workloads"]:
            assert manifest.reports(moves, w), (m["name"], w)
    layers = {}
    for m in M["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert all(_line(layer) for layer in layers)


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer():
    for w in M["workloads"]:
        cell = manifest.resolve(M, ROOT, w["name"])
        e2e = {n for n, _ in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        assert w["chips"] == 1


def test_run_seconds_fits_the_check_with_24_cells():
    cells = 24
    assert 1 <= M["run_seconds"] <= 51
    total = ((2 + 14 * cells) * (M["run_seconds"] + 60) + cells * 2 * 90
             + 1200)
    assert total <= 43200


@pytest.mark.parametrize("workload", [w["name"] for w in M["workloads"]])
def test_every_cell_resolves_to_its_files(workload):
    cell = manifest.resolve(M, ROOT, workload)
    kind = manifest.kind(cell.traffic)
    reference, flops = manifest.family(cell.config)
    assert kind.KIND in ("train", "score")
    assert callable(reference.param_spec) and callable(flops.step_flops)
    for name, _ in cell.per_layer:
        assert callable(manifest.reader(name).read)
    assert cell.config["reduced"] == next(
        c for c in M["configs"] if c["name"] == cell.config["name"])["reduced"]


def test_a_cell_added_by_data_files_alone_runs(tmp_path):
    """A new traffic file, a new configuration file and their manifest
    entries, in a copy: resolved and run tiny with no code edited."""
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    (bench / "traffic" / "score-requests-7.json").write_text(json.dumps(
        {"kind": "score_requests", "points": 7, "warm_requests": 1,
         "checked_requests": 2, "profile_requests": 1}))
    conf = json.loads((bench / "configs" / "vae-exact-mnist.json").read_text())
    conf["name"] = "vae-exact-mnist-wide"
    conf["program"]["hidden_size"] = 24
    (bench / "configs" / "vae-exact-mnist-wide.json").write_text(
        json.dumps(conf))
    m = json.loads(json.dumps(M))
    m["configs"].append({"name": "vae-exact-mnist-wide", "source": "x",
                         "file": "benchmark/configs/vae-exact-mnist-wide.json",
                         "reduced": [], "why": "a test"})
    m["workloads"].append({"name": "extra", "config": "vae-exact-mnist-wide",
                           "traffic": "score-requests-7", "chips": 1,
                           "why": "a test"})
    for e in m["end_to_end"] + m["per_layer"]:
        if "vae-exact-score" in e.get("workloads", []):
            e["workloads"].append("extra")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    cell = manifest.resolve(manifest.load(tmp_path), tmp_path, "extra",
                            bench_dir=bench)
    assert cell.traffic["points"] == 7
    assert {n for n, _ in cell.end_to_end} == {
        "score_points_per_s", "score_p95_ms", "setup_s"}
    cell = tiny(cell)
    cell.traffic["points"] = 7
    import run
    result = run.run_cell(cell, cpu_context(cell))
    assert result["correct"], result
    assert set(result["metrics"]) == {n for n, _ in cell.end_to_end}


def test_the_module_check_compares_whole_top_level_names():
    assert banned_loaded({"exemplar_vae_tpu_torch",
                          "exemplar_vae_tpu_torch.ops.knn", "torch"}) == []
    assert banned_loaded({"exemplar_vae_tpu.ops", "torch"}) == [
        "exemplar_vae_tpu"]
    assert banned_loaded({"jax.numpy", "flax", "optax", "jaxlib"}) == [
        "flax", "jax", "jaxlib", "optax"]


def test_the_harness_and_the_port_load_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]; import run, calibrate; "
            "from portbench import manifest; import portbench.trace; "
            "from portbench.common import banned_loaded; "
            "m = manifest.load(run.ROOT); "
            "[manifest.family(manifest.resolve(m, run.ROOT, w['name']).config) "
            "for w in m['workloads']]; "
            "import exemplar_vae_tpu_torch.serve, "
            "exemplar_vae_tpu_torch.train.steps; "
            "print(banned_loaded())" % (str(BENCH), str(ROOT)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_or_without_the_port_no_result(tmp_path):
    """Here there is no card: the run exits with a code other than 0 and
    prints nothing on standard output; so it does in a directory that holds
    only BENCHMARK.json and the benchmark."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    import torch
    for cwd in (tmp_path,) if torch.cuda.is_available() else (ROOT, tmp_path):
        out = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload",
             "vae-exact-score", "--seed", str(2 ** 31 + 7), "--seconds", "1",
             "--trace", "0"], capture_output=True, text=True, timeout=300,
            cwd=cwd)
        assert out.returncode != 0 and out.stdout == "", out
