"""The benchmark's data-mesh kind (benchmark/portbench/kinds/train_mesh.py)
at a tiny ConvHVAE on 4 gloo ranks on the CPU: ranks 1-3 child processes
of the kind, rank 0 this process, as on the card with NCCL.

The kind's first steps (the port's data-parallel epoch function on every
rank, the bank and the kNN cache split by rows) against the benchmark's
plain reference (portbench/reference/convhvae.py) following the same steps
with the whole batch in one process, compared by the kind's own numbers:
the steps' losses, each leaf's first gradient and change over the steps
(norms, the worst leaf), and the ranks' params, bitwise. The planted mesh
fault, the gradient sum divided by 3 instead of 4, must fail them; a rank
that raises must stop the mesh with an error, its ranks gone, within the
test's own time limit. The children's CPUs come from the mask rank 0 may
use, outside its own, or the run fails.

Tolerances (fp32 on the CPU). The mesh sums each batch in four row blocks
and all-reduces the blocks, the reference in one pass, so values part by
float rounding only (measured over seeds 1-8: losses 0 to 9.2e-8
relative, the worst leaf's gradient 7.6e-7 to 3.3e-6, its change 1.2e-5 to
9.0e-5). Losses within LOSS_GAP: sums of 8 rows' terms of order 1e4.
Gradients within GRAD_GAP of the leaf's norm (or the median leaf's where
larger). Changes within CHANGE_GAP: AdamNormGrad divides each normalized
gradient by its running scale, so an element whose gradient is at
round-off level moves by up to the learning rate either way, and a small
leaf's change norm keeps up to ~1e-4 of that noise. The fault scales every gradient by 4/3: it reads 1/3 on the
gradients, 1e4 times GRAD_GAP (AdamNormGrad's update does not see a
gradient's scale, so the losses and changes do not read it)."""

import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

import run  # noqa: E402
from portbench import manifest  # noqa: E402
from portbench.kinds import train_mesh  # noqa: E402

LOSS_GAP, GRAD_GAP, CHANGE_GAP = 2e-6, 2.5e-5, 5e-4
FAULT_READS = 0.3
RAISE_LIMIT_S = 60.0
# Config 4's shape at 16x16 (tests/test_torch_data_parallel.py's
# SMALL_CONV): 3-channel uint8 images, a bank of 62 padded to 64 (16 a
# rank), batch 8 (2 rows a rank), K = 3
TINY = dict(input_size=[3, 16, 16], hidden_size=16, z1_size=4, z2_size=4,
            conv_enc_spec="4k3s1,4k3s2,8k3s1,8k3s2",
            conv_dec_spec="t8k3s2,t4k3s2,c4k3s1", conv_proj_channels=4,
            number_components=62, approximate_k=3, training_set_size=70,
            test_set_size=20, val_set_size=8, batch_size=8,
            exact_reencode_chunk=16)


def _context(seed):
    cell = manifest.resolve(manifest.load(run.ROOT), run.ROOT,
                            "convhvae-knn-train-dp4")
    assert cell.chips == 4 and cell.config["program"]["mesh_shape"] == [4]
    cell.config["program"].update(TINY)
    cell.config["reference_block"] = 16
    return run.context(cell, seed=seed, seconds=0, trace=False,
                       device=torch.device("cpu"), t0=time.perf_counter())


@pytest.fixture(scope="module")
def case():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # the children's count too
    try:
        ctx = _context(2 ** 31 + 5)
        inputs = train_mesh.make_inputs(ctx)
        yield ctx, inputs, train_mesh.reference_outputs(ctx, inputs)
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("plant", [None, "grads_over_w_minus_1"])
def test_the_mesh_follows_the_whole_batch_reference(case, plant):
    ctx, inputs, want = case
    prog = train_mesh.Program(ctx, inputs, plant=plant)
    assert prog.world == 4 and prog.rank.mesh.size == 4
    assert prog.rank.bank.images.shape[0] == 16      # 62 padded to 64
    got = train_mesh.first_steps(prog, inputs)
    procs = prog.ranks.procs
    del prog
    assert [p.returncode for p in procs] == [0, 0, 0]
    found = train_mesh.numbers(got, want)
    assert found["rank_params_gap"] == 0.0
    within = {"loss_gap": LOSS_GAP, "grad_gap": GRAD_GAP,
              "change_gap": CHANGE_GAP}
    if plant is None:
        for name, limit in within.items():
            assert found[name] <= limit, (name, found)
    else:
        assert found["grad_gap"] >= FAULT_READS, found
        assert found["grad_median_gap"] >= FAULT_READS, found


def test_a_rank_that_raises_stops_the_mesh(case):
    ctx, inputs, _ = case
    prog = train_mesh.Program(ctx, inputs, plant="rank_raises")
    procs = prog.ranks.procs
    t0 = time.monotonic()
    # ranks 1 and 2 may fail in turn (their collectives with rank 3) and be
    # named beside it
    with pytest.raises(RuntimeError, match="rank 3 exited with code 1"):
        train_mesh.first_steps(prog, inputs)
    assert time.monotonic() - t0 < RAISE_LIMIT_S
    assert all(p.poll() is not None for p in procs)
    assert procs[2].returncode == 1
    del prog


@pytest.mark.parametrize("own, allowed, want", [
    # run.py's pin: the last two of the allowed set; children below it
    ({30, 31}, set(range(32)), [[28, 29], [26, 27], [24, 25]]),
    # a cpuset of CPUs 8-15: nothing outside it is handed out
    ({14, 15}, set(range(8, 16)), [[12, 13], [10, 11], [8, 9]]),
    # rank 0 not narrowed: the children share its mask
    (set(range(8)), set(range(8)), [[], [], []]),
    # too few CPUs left
    ({6, 7}, set(range(8)) - {0}, None),
])
def test_the_children_take_cpus_of_their_own(own, allowed, want):
    if want is None:
        with pytest.raises(RuntimeError, match="need 2 CPUs each"):
            train_mesh._cpu_sets(3, own=own, allowed=allowed)
        return
    got = train_mesh._cpu_sets(3, own=own, allowed=allowed)
    assert got == want
    taken = [c for cpus in got for c in cpus]
    assert len(set(taken)) == len(taken) and not set(taken) & own
    assert set(taken) <= allowed


def test_a_child_that_cannot_take_its_cpus_fails():
    with pytest.raises(RuntimeError, match="not taken"):
        train_mesh._pin(str(10 ** 6))
