"""The yardstick's counters, readers, trace reduction, weights and data,
at tiny sizes on the CPU."""

from __future__ import annotations

import math
import sys

import pytest
import torch
from conftest import ROOT, load_cell, read_metric
from torch.utils.flop_counter import FlopCounterMode

from portbench import data, weights
from portbench.common import PEAK_FLOPS, PEAK_HBM_BYTES_PER_S, Readings
from portbench.flops import pairwise_lse
from portbench.trace import TraceSummary, _innermost, _union, profile_stretch


def _reference(workload, seed=5):
    cell = load_cell(workload)
    from portbench import manifest
    ref_mod, flops = manifest.family(cell.config)
    cfg = cell.config["program"]
    w = weights.make_weights(ref_mod.param_spec(cfg), seed=seed,
                             device=torch.device("cpu"))
    return cell, cfg, ref_mod, flops, w


def _expected(ops):
    """What torch computes for the reference: its transposed convs run as
    stride-1 convs over the zero-dilated input, t_stride^2 times the
    algorithm's work, forward and backward."""
    return sum(op.flops * op.t_stride ** 2 for op in ops)


@pytest.mark.parametrize("workload", ["vae-exact-train",
                                      "convhvae-knn-train"])
def test_step_flops_match_flop_counter_mode_on_the_reference(workload):
    cell, cfg, ref_mod, flops, w = _reference(workload)
    ref = ref_mod.Reference(cfg, weights.reference_params(w))
    c, h, wd = cfg["input_size"]
    n, b = cfg["number_components"], cfg["batch_size"]
    pixels = torch.uint8 if cell.config["data"]["pixels"] == "uint8" \
        else torch.float32
    images = data.blob_images(n, h, wd, c, seed=1, tag="t", device="cpu",
                              out_dtype=pixels)
    bank = {"images": images, "idx": torch.arange(n), "n": n}
    if cfg["approximate_prior"]:
        ref.refresh_cache(images, 16)
    rows = torch.arange(b)
    u = torch.rand((b, h, wd, c))
    eps = tuple(torch.randn(b, k) for k in ref_mod.eps_widths(cfg))
    with FlopCounterMode(display=False) as fcm:
        loss = ref.batch_loss(images[rows], u, eps, rows, bank, 1.0)
        loss.backward()
    assert fcm.get_total_flops() == _expected(flops.step_ops(cfg))
    assert flops.step_flops(cfg) == sum(op.flops for op in flops.step_ops(cfg))


@pytest.mark.parametrize("workload", ["vae-exact-score",
                                      "convhvae-knn-score"])
def test_request_flops_match_flop_counter_mode_on_the_reference(workload):
    cell, cfg, ref_mod, flops, w = _reference(workload)
    ref = ref_mod.Reference(cfg, weights.reference_params(w))
    t = 3
    c, h, wd = cfg["input_size"]
    n = cfg["number_components"]
    pixels = torch.uint8 if cell.config["data"]["pixels"] == "uint8" \
        else torch.float32
    images = data.blob_images(n + t, h, wd, c, seed=1, tag="t", device="cpu",
                              out_dtype=pixels)
    means = ref.bank_means(images[:n], 16)
    rounds = flops.rounds(cfg)
    eps = tuple(torch.randn(rounds, t * cfg["MB"], k)
                for k in ref_mod.eps_widths(cfg))
    with FlopCounterMode(display=False) as fcm:
        ref.iwae_nll(images[n:], eps, means, n, 1 << 20)
    assert fcm.get_total_flops() == _expected(flops.request_ops(cfg, t))
    calls = flops.lse_calls_request(cfg, t)
    assert len(calls) == rounds and calls[0][:2] == (t * cfg["MB"], n)


def test_full_size_counts_are_the_issue_s():
    """~157 GFLOP a Config 1 step, ~2.44 TFLOP a Config 1 request."""
    cell = load_cell("vae-exact-train", small=False)
    from portbench.flops import vae
    cfg = cell.config["program"]
    assert 1.50e11 < vae.step_flops(cfg) < 1.60e11
    assert 2.40e12 < vae.request_flops(cfg, 100) < 2.50e12
    assert vae.lse_calls_step(cfg) == [(100, 50_000, 40, True)]


def test_the_bound_keeps_lse_bound_ms_s_bytes():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    # byte-bound (the train shape): the two agree
    ms, kind, _ = chip_smoke.lse_bound_ms(100, 50_000, 40, "float32", True,
                                          132, 1.98e9)
    assert kind == "bytes"
    assert math.isclose(pairwise_lse.bound_s(100, 50_000, 40, True) * 1e3, ms,
                        rel_tol=1e-12)
    assert math.isclose(pairwise_lse.call_bytes(100, 50_000, 40, True),
                        ms * 1e-3 * PEAK_HBM_BYTES_PER_S, rel_tol=1e-12)
    # the serving shape: 2 B N D at the TF32 peak, no 3x split, no SFU term
    assert math.isclose(pairwise_lse.bound_s(50_000, 50_000, 40, False),
                        2 * 50_000 * 50_000 * 40 / PEAK_FLOPS)
    assert pairwise_lse.is_kernel("void lse_partial_kernel<false>(...)")
    assert pairwise_lse.is_kernel("lse_merge_kernel(float const*)")
    assert not pairwise_lse.is_kernel("void at::native::false_kernel<>()")


def _readings(kind="train", events=(), launches=0, calls=((100, 50_000, 40,
                                                           True),)):
    tr = TraceSummary(window_s=0.5, busy_s=0.2, device_events=list(events))
    return Readings(kind=kind, units=4, trace=tr, window_s=10.0,
                    window_units=1000, flops_per_unit=1.5e11,
                    lse_calls_per_unit=list(calls), lse_launches=launches)


def test_readers():
    events = [("void lse_partial_kernel<false>()", 0.0, 30.0),
              ("void lse_merge_kernel()", 30.0, 40.0),
              ("sgemm", 40.0, 100.0)]
    r = _readings(events=events, launches=4)
    assert read_metric("device_idle_pct.train", r) == pytest.approx(60.0)
    assert read_metric("device_idle_pct.score", r) is None
    assert read_metric("launches_per_step.train", r) == pytest.approx(0.75)
    assert read_metric("mfu.train", r) == pytest.approx(
        100 * 1.5e11 * 1000 / 10.0 / PEAK_FLOPS)
    assert read_metric("mfu.score", r) is None
    assert read_metric("pairwise_lse_roofline.score", r) is None
    calls = ((5000, 162_770, 40, False),) * 10
    s = _readings("score", events=events, launches=40, calls=calls)
    bound = 40 * pairwise_lse.bound_s(5000, 162_770, 40, False)
    assert read_metric("pairwise_lse_roofline.score", s) == pytest.approx(
        100 * bound / 40e-6)
    # the kernel absent from the trace: nothing; counted launches that are
    # not the calls the cell makes: an error
    assert read_metric("pairwise_lse_roofline.score", _readings(
        "score", events=events[2:], calls=calls)) is None
    with pytest.raises(RuntimeError):
        read_metric("pairwise_lse_roofline.score", _readings(
            "score", events=events, launches=39, calls=calls))


def test_trace_reduction_pieces():
    assert _union([(5, 7), (0, 2), (1, 3), (7, 8)]) == [[0, 3], [5, 8]]
    host = [(0, 10, "outer"), (1, 4, "a"), (2, 3, "a.inner"), (5, 9, "b")]
    got = _innermost(host, [0.5, 2.5, 3.5, 4.5, 6, 11])
    assert [g and g[2] for g in got] == [
        "outer", "a.inner", "a", "outer", "b", None]


def test_a_profiled_stretch_on_the_cpu_has_no_device_time():
    out, s = profile_stretch(lambda: torch.ones(64, 64) @ torch.ones(64, 64),
                             torch.device("cpu"))
    assert out.shape == (64, 64) and s.window_s > 0
    assert s.busy_s == 0 and s.device_events == [] and s.idle_pct == 100.0
    assert s.idle_gaps and len(s.idle_gaps) <= 10


@pytest.mark.parametrize("family", ["vae", "convhvae"])
def test_the_seeded_weights_load_into_the_port_by_name(family):
    from portbench import manifest, program
    workload = {"vae": "vae-exact-train",
                "convhvae": "convhvae-knn-train"}[family]
    cell = load_cell(workload)
    cfg = cell.config["program"]
    ref_mod, _ = manifest.family(cell.config)
    w = weights.make_weights(ref_mod.param_spec(cfg), seed=9, device="cpu")
    model = program.build_model(program.config(cfg), w, torch.device("cpu"))
    state = model.state_dict()
    assert set(state) == set(weights.program_state(w))
    for k, v in weights.program_state(w).items():
        assert torch.equal(state[k], v)
    # the same seed makes the same weights; another seed others
    again = weights.make_weights(ref_mod.param_spec(cfg), seed=9,
                                 device="cpu")
    other = weights.make_weights(ref_mod.param_spec(cfg), seed=10,
                                 device="cpu")
    assert all(torch.equal(w[k], again[k]) for k in w)
    assert any(not torch.equal(w[k], other[k]) for k in w if w[k].numel() > 1)
    assert float(w["prior_log_var"]) == 0.0


def test_seeded_images():
    a = data.blob_images(40, 8, 8, 3, seed=2 ** 33 + 1, tag="x", device="cpu",
                         out_dtype=torch.uint8)
    b = data.blob_images(40, 8, 8, 3, seed=2 ** 33 + 1, tag="x", device="cpu",
                         out_dtype=torch.uint8)
    c = data.blob_images(40, 8, 8, 3, seed=2 ** 33 + 2, tag="x", device="cpu",
                         out_dtype=torch.uint8)
    assert a.dtype == torch.uint8 and a.shape == (40, 8, 8, 3)
    assert torch.equal(a, b) and not torch.equal(a, c)
    g = data.blob_images(40, 28, 28, 1, seed=3, tag="x", device="cpu")
    assert g.dtype == torch.float32 and 0.0 <= float(g.min()) <= float(
        g.max()) <= 1.0
    bits = data.binarize(g, seed=3, tag="t")
    assert set(torch.unique(bits).tolist()) <= {0.0, 1.0}
