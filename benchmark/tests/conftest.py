"""Shared set-up of the benchmark's tests.

Run them from the root of the repo:

    python -m pytest benchmark/tests -q            # on the CPU
    python -m pytest benchmark/tests -q -m cuda    # the card's tests

The CPU tests drive the harness at tiny sizes through the port's CPU path;
the ``cuda`` tests (the controls at a reduced size) skip without a card.
"""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# tiny sizes of each family for the CPU (widths cut: tests only)
TINY = {
    "vae": dict(hidden_size=16, z1_size=4, z2_size=4, number_components=64,
                training_set_size=64, test_set_size=20, val_set_size=8,
                batch_size=8, S=8, MB=4, exact_reencode_chunk=16),
    "convhvae": dict(input_size=[3, 16, 16], hidden_size=16, z1_size=4,
                     z2_size=4, conv_enc_spec="4k3s1,4k3s2,8k3s1,8k3s2",
                     conv_dec_spec="t8k3s2,t4k3s2,c4k3s1",
                     conv_proj_channels=4, number_components=64,
                     approximate_k=3, training_set_size=64, test_set_size=20,
                     val_set_size=8, batch_size=8, S=8, MB=4,
                     exact_reencode_chunk=16),
}
TINY_TRAFFIC = {"train_epochs": dict(warm_steps=1, profile_steps=2),
                "score_requests": dict(points=5, warm_requests=1,
                                       checked_requests=2,
                                       profile_requests=1)}


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def tiny(cell):
    """A copy of ``cell`` at the tiny sizes of its family."""
    cell = copy.deepcopy(cell)
    cell.config["program"].update(TINY[cell.config["family"]])
    cell.config["reference_block"] = 16
    cell.traffic.update(TINY_TRAFFIC[cell.traffic["kind"]])
    return cell


# cells whose files are in the benchmark but not in BENCHMARK.json: Config
# 1's training, too host-bound to hold a bound on the chip's machine
# (PERF.md, Open questions); the tests still drive its path
EXTRA = {"vae-exact-train": ("vae-exact-mnist", "train-whole-epochs")}


def load_cell(workload, *, small=True):
    from portbench import manifest
    m = manifest.load(ROOT)
    if workload in EXTRA:
        config, traffic = EXTRA[workload]
        m["workloads"].append({"name": workload, "config": config,
                               "traffic": traffic, "chips": 1})
        for metric in m["end_to_end"] + m["per_layer"]:
            if "convhvae-knn-train" in metric.get("workloads", ()):
                metric["workloads"].append(workload)
    cell = manifest.resolve(m, ROOT, workload)
    return tiny(cell) if small else cell


def cpu_context(cell, *, seed=123, seconds=0.2, trace=False, device=None):
    import time

    import torch

    import run
    return run.context(cell, seed=seed, seconds=seconds, trace=trace,
                       device=device or torch.device("cpu"),
                       t0=time.perf_counter())


def read_metric(name, readings):
    """The per-layer metric ``name`` as its reader reads ``readings``."""
    from portbench import manifest
    return manifest.reader(name).read(readings)
