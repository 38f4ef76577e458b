"""The PixelHVAE's cell at a tiny size on the CPU: driven whole, untraced
and traced, it comes out correct; with a 'B' mask that lets in the next
pixel it does not; the faults planted in the reference to calibrate its
limit fail it; and its FLOP counter agrees with torch's on the reference
once the masked taps are taken out."""

from __future__ import annotations

import copy
import math

import pytest
import torch
from conftest import ROOT, cpu_context

import run
from portbench import manifest

WORKLOAD = "pixelhvae-exact-score"
# 1x8x8 binary images, hidden 16, z 4 + 4, 4 features, 2 'B' layers, N 64
TINY = dict(input_size=[1, 8, 8], hidden_size=16, z1_size=4, z2_size=4,
            pixelcnn_features=4, pixelcnn_layers=2, number_components=64,
            training_set_size=64, test_set_size=20, val_set_size=8,
            batch_size=8, S=8, MB=4, exact_reencode_chunk=16)
TINY_TRAFFIC = dict(points=5, warm_requests=1, checked_requests=2,
                    profile_requests=1)


def tiny_cell():
    cell = copy.deepcopy(manifest.resolve(manifest.load(ROOT), ROOT,
                                          WORKLOAD))
    cell.config["program"].update(TINY)
    cell.config["reference_block"] = 16
    cell.traffic.update(TINY_TRAFFIC)
    return cell


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_runs_and_is_correct(trace):
    cell = tiny_cell()
    result = run.run_cell(cell, cpu_context(cell, seed=2 ** 31 + 17,
                                            trace=trace))
    assert result["correct"] and result["failed"] == 0, result
    assert result["attempted"] > 0
    for c in result["checks"].values():
        assert c["value"] <= c["limit"]
    names = {n for n, _ in (cell.per_layer if trace else cell.end_to_end)}
    if trace:
        # no device operation on the CPU: of the per-layer metrics only the
        # host clock's share and the idle share can be read
        assert set(result["metrics"]) <= names
        assert "mfu.score" in result["metrics"]
    else:
        assert set(result["metrics"]) == names == {"score_points_per_s",
                                                  "setup_s"}


def _b_mask_sees_the_next_pixel(monkeypatch):
    """The port's 'B' layers let in the pixel after the centre."""
    from exemplar_vae_tpu_torch.models import layers
    real = layers.MaskedConv2d.__init__

    def init(self, c_in, features, kernel_size=(3, 3), mask_type="B", **kw):
        real(self, c_in, features, kernel_size, mask_type, **kw)
        if mask_type == "B":
            kh, kw_ = kernel_size
            self.mask[kh // 2, kw_ // 2 + 1] = 1.0
    monkeypatch.setattr(layers.MaskedConv2d, "__init__", init)


def _b_masks_drop_the_centre(monkeypatch):
    """Planted in the reference: every 'B' mask is an 'A' mask."""
    from portbench.reference import pixelhvae
    real = pixelhvae.causal_mask
    monkeypatch.setattr(pixelhvae, "causal_mask",
                        lambda k, kind: real(k, "A"))


def _context_left_out_of_the_last_layer(monkeypatch):
    """Planted in the reference: the last masked layer adds no context."""
    from portbench.reference import pixelhvae
    real = pixelhvae.Reference.masked_layer

    def layer(self, h, ctx, name, kind):
        last = f"pix_layers_{self.cfg['pixelcnn_layers'] - 1}"
        if name == last:
            return self.masked_conv(h, name, kind)
        return real(self, h, ctx, name, kind)
    monkeypatch.setattr(pixelhvae.Reference, "masked_layer", layer)


@pytest.mark.parametrize("fault", [_b_mask_sees_the_next_pixel,
                                   _b_masks_drop_the_centre,
                                   _context_left_out_of_the_last_layer])
def test_a_fault_in_the_stack_is_not_correct(fault, monkeypatch):
    cell = tiny_cell()
    fault(monkeypatch)
    result = run.run_cell(cell, cpu_context(cell))
    assert not result["correct"], result["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("plant", [None, _b_masks_drop_the_centre,
                                   _context_left_out_of_the_last_layer])
def test_the_control_and_the_faults_are_not_correct_on_the_card(
        plant, cuda_device, monkeypatch):
    """The reference computed with TF32 on (``plant`` None), or with a
    fault planted, in the program's place, at the cell's widths and a
    reduced bank, test set and S on the card: the cell's limit fails."""
    cell = copy.deepcopy(manifest.resolve(manifest.load(ROOT), ROOT,
                                          WORKLOAD))
    cell.config["program"].update(number_components=8192,
                                  training_set_size=8192, test_set_size=200,
                                  S=1000)
    ctx = cpu_context(cell, seed=2 ** 32 + 3, device=cuda_device)
    kind = manifest.kind(cell.traffic)
    inputs = kind.make_inputs(ctx)
    ids = [0, 1]
    want = kind.reference_nlls(ctx, inputs, ids)
    if plant is None:
        got = kind.reference_nlls(ctx, inputs, ids, tf32=True)
    else:
        plant(monkeypatch)
        got = kind.reference_nlls(ctx, inputs, ids)
    checks = kind.checks(ctx, got, want)
    assert any(v > lim for _, v, lim in checks), checks
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_the_flop_counter_agrees_with_torch_on_the_reference():
    """torch's FlopCounterMode over one reference round of one point (its
    encode once, the per-sample nets, the stack at the masks' full kernels,
    and the exact prior in one block), against the counter with the masked
    taps put back in and the reference's elementwise work left out."""
    from torch.utils.flop_counter import FlopCounterMode

    from portbench import weights
    from portbench.flops import pixelhvae as flops
    from portbench.reference import pixelhvae as ref
    cfg = dict(tiny_cell().config["program"], S=4, MB=4)
    model = ref.Reference(cfg, weights.reference_params(weights.make_weights(
        ref.param_spec(cfg), seed=5, device=torch.device("cpu"))))
    c, h, w = cfg["input_size"]
    g = torch.Generator().manual_seed(0)
    x2d = (torch.rand((1, c * h * w), generator=g) < 0.5).float()
    bank = torch.randn((cfg["number_components"], cfg["z2_size"]),
                       generator=g)
    eps = tuple(torch.randn((cfg["MB"], k), generator=g)
                for k in ref.eps_widths(cfg))
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        enc = model.encode_once(x2d)
        model.iwae_log_weights(x2d, enc, eps, 0, cfg["MB"], bank,
                               math.log(cfg["number_components"]),
                               cfg["MB"])
    want = fc.get_total_flops()

    ops = flops.request_ops(cfg, 1)
    full = {name: k * k for name, _, k in ref.masked_layers(cfg)}
    kept = {name: flops.kept_taps(k, kind)
            for name, kind, k in ref.masked_layers(cfg)}
    got = sum(op.flops * full.get(op.name, 1) / kept.get(op.name, 1)
              for op in ops)
    assert got == pytest.approx(want, rel=1e-12)
    # the masked taps are what the counter leaves out
    masked = sum(op.flops for op in ops if op.name in kept)
    assert masked < sum(op.flops * full[op.name] / kept[op.name]
                        for op in ops if op.name in kept)


def test_the_stack_bound_counts_bytes_and_kept_taps():
    from portbench.common import PEAK_FLOPS, PEAK_HBM_BYTES_PER_S
    from portbench.flops import pixelhvae as flops
    cfg = manifest.resolve(manifest.load(ROOT), ROOT,
                           WORKLOAD).config["program"]
    rows = 100 * cfg["S"]
    hw, pf = 28 * 28, cfg["pixelcnn_features"]
    b_layer = max(2.0 * rows * hw * pf * pf * 5 / PEAK_FLOPS,
                  rows * hw * 3 * pf * 4 / PEAK_HBM_BYTES_PER_S)
    a_layer = max(2.0 * rows * hw * pf * 12 / PEAK_FLOPS,
                  rows * hw * (1 + 2 * pf) * 4 / PEAK_HBM_BYTES_PER_S)
    head = max(2.0 * rows * hw * pf / PEAK_FLOPS,
               rows * hw * (pf + 1) * 4 / PEAK_HBM_BYTES_PER_S)
    want = a_layer + cfg["pixelcnn_layers"] * b_layer + head
    assert flops.masked_stack_bound_s(rows, cfg) == pytest.approx(want,
                                                                  rel=1e-12)
    assert [flops.kept_taps(5, "A"), flops.kept_taps(3, "B")] == [12, 5]


def test_the_stack_readers_read_the_port_s_spans_and_counter(monkeypatch):
    """The two readers over a request profiled on the CPU (the port keeps
    its stack calls) and a span summary that puts 0.5 s of device time
    under the stack: the ms a request, and the bound over that time; no
    reading where the counter's rows are not the cell's, or where the port
    has no counter."""
    import dataclasses

    from conftest import read_metric
    from torch.profiler import ProfilerActivity, profile

    from exemplar_vae_tpu_torch.models import pixel_hvae
    from portbench import spans
    from portbench.common import Readings
    from portbench.flops import pixelhvae as flops
    from portbench.trace import TraceSummary
    cell = tiny_cell()
    cfg, points = cell.config["program"], cell.traffic["points"]
    ctx = cpu_context(cell)
    kind = manifest.kind(cell.traffic)
    inputs = kind.make_inputs(ctx)
    prog = kind.Program(ctx, inputs)
    with profile(activities=[ProfilerActivity.CPU]):
        kind.serve(ctx, prog, inputs, 0)
    stack = "evae.pixelcnn.stack"
    calls = flops.rounds(cfg)
    summary = spans.SpanSummary(
        ops=[(0.5, frozenset({stack, "evae.iwae.chunk"}), frozenset()),
             (0.25, frozenset({"evae.iwae.chunk"}), frozenset())],
        counts={stack: calls})
    trace = TraceSummary(window_s=1.0, busy_s=0.75)
    trace.spans = summary
    r = Readings(kind="score", units=1, trace=trace, window_s=1.0,
                 window_units=1, flops_per_unit=1.0,
                 lse_calls_per_unit=flops.lse_calls_request(cfg, points),
                 lse_launches=calls)
    assert read_metric("pixelcnn_stack_ms_per_request.score", r) == 500.0
    bound = flops.masked_stack_bound_s(points * cfg["S"], cfg)
    assert read_metric("masked_stack_roofline.score", r) == pytest.approx(
        100.0 * bound / 0.5, rel=1e-12)
    assert read_metric("masked_stack_roofline.score",
                       dataclasses.replace(r, units=2)) is None
    monkeypatch.delattr(pixel_hvae, "masked_stack")
    assert read_metric("masked_stack_roofline.score", r) is None
