"""Each cell driven whole at a tiny size on the CPU (the look for a card
skipped), untraced and traced; and with the timed path broken underneath,
``correct`` comes out false."""

from __future__ import annotations

import pytest
import torch
from conftest import cpu_context, load_cell

import run

CELLS = ["vae-exact-train", "convhvae-knn-train", "vae-exact-score",
         "convhvae-knn-score"]
TRAIN = CELLS[:2]
SCORE = CELLS[2:]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", CELLS)
def test_a_cell_runs_and_is_correct(workload, trace):
    cell = load_cell(workload)
    result = run.run_cell(cell, cpu_context(cell, seed=2 ** 31 + 11,
                                            trace=trace))
    assert result["correct"] and result["failed"] == 0, result
    assert result["attempted"] > 0
    assert list(result)[-1] == "checks" and result["checks"]
    for c in result["checks"].values():
        assert c["value"] <= c["limit"]
    want = cell.per_layer if trace else cell.end_to_end
    # on the CPU no device operation runs: only the shares of the host's
    # clock (mfu) and the idle share (all of it) can be read
    got = set(result["metrics"])
    assert got <= {n for n, _ in want}
    if not trace:
        assert got == {n for n, _ in want}
        assert all(v["value"] > 0 for v in result["metrics"].values())
    else:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_the_same_seed_makes_the_same_first_steps():
    cell = load_cell("vae-exact-train")
    from portbench.kinds import train_epochs as k
    outs = []
    for _ in range(2):
        ctx = cpu_context(cell, seed=77)
        inputs = k.make_inputs(ctx)
        outs.append(k.first_steps(k.Program(ctx, inputs), inputs))
    assert outs[0] == outs[1]


def _step_returns_state_unchanged(monkeypatch):
    from exemplar_vae_tpu_torch.train import optimizer
    monkeypatch.setattr(optimizer.Adam, "step", lambda self, closure=None: None)


def _half_batch_left_out(monkeypatch):
    from exemplar_vae_tpu_torch.train import steps
    real = steps.batch_loss

    def half(model, x, beta, cfg, *, data_idx=None, eps=None, **kw):
        h = x.shape[0] // 2
        eps = tuple(e[:h] for e in eps) if isinstance(eps, tuple) \
            else eps[:h]
        return real(model, x[:h], beta, cfg, data_idx=data_idx[:h], eps=eps,
                    **kw)
    monkeypatch.setattr(steps, "batch_loss", half)


def _answer_altered(monkeypatch):
    from exemplar_vae_tpu_torch import serve
    real = serve.make_serving_fns

    def altered(*a, **kw):
        gen, ref, score = real(*a, **kw)

        def score_altered(*sa, **skw):
            out = score(*sa, **skw).clone()
            out[0] += 1e-3 * out[0].abs()
            return out
        return gen, ref, score_altered
    monkeypatch.setattr(serve, "make_serving_fns", altered)


@pytest.mark.parametrize("fault", [_step_returns_state_unchanged,
                                   _half_batch_left_out])
@pytest.mark.parametrize("workload", TRAIN)
def test_a_broken_train_step_is_not_correct(workload, fault, monkeypatch):
    cell = load_cell(workload)
    fault(monkeypatch)
    result = run.run_cell(cell, cpu_context(cell))
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("workload", SCORE)
def test_an_altered_answer_is_not_correct(workload, monkeypatch):
    cell = load_cell(workload)
    _answer_altered(monkeypatch)
    result = run.run_cell(cell, cpu_context(cell))
    assert not result["correct"], result["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct_on_the_card(workload, cuda_device):
    """The reference computed with TF32 on, in the program's place, at a
    reduced size on the card: one of the cell's numbers fails its limit."""
    from portbench import manifest
    cell = load_cell(workload, small=False)
    cfg = cell.config["program"]
    cfg.update(number_components=min(cfg["number_components"], 8192),
               training_set_size=min(cfg["training_set_size"], 8192),
               test_set_size=min(cfg["test_set_size"], 200), S=1000)
    ctx = cpu_context(cell, seed=2 ** 32 + 3, device=cuda_device)
    kind = manifest.kind(cell.traffic)
    inputs = kind.make_inputs(ctx)
    if kind.KIND == "train":
        want = kind.reference_outputs(ctx, inputs)
        got = kind.reference_outputs(ctx, inputs, tf32=True)
    else:
        ids = [0, 1]
        want = kind.reference_nlls(ctx, inputs, ids)
        got = kind.reference_nlls(ctx, inputs, ids, tf32=True)
    checks = kind.checks(ctx, got, want)
    assert any(v > lim for _, v, lim in checks), checks
    assert torch.backends.cuda.matmul.allow_tf32 is False
