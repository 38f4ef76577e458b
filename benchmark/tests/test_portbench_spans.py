"""The span reduction (portbench/spans.py) and the six readers that use it,
on synthetic event lists in the profiler's form, and one traced run of a
train and a score cell at tiny sizes on the CPU."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch
from conftest import cpu_context, load_cell, read_metric

from portbench import spans, trace
from portbench.common import Readings
from portbench.trace import TraceSummary

CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA
TRAIN = ("reencode_ms_per_step.train", "knn_ms_per_step.train",
         "host_syncs_per_step.train", "reencode_rows_per_distinct.train")
SCORE = ("iwae_decode_ms_per_request.score",
         "iwae_prior_ms_per_request.score")


def ev(name, start, end, *, device=False, thread=1, id=0, seq=-1,
       fwd_thread=0):
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end),
        device_type=CUDA if device else CPU, thread=thread, id=id,
        sequence_nr=seq, fwd_thread=fwd_thread, is_user_annotation=False)


def train_events():
    """One step: a conv inside the re-encode (its kernel 300-320 us), its
    backward on the autograd thread (330-370), an add in the forward
    outside the re-encode (380-390), a kernel whose launch the trace lacks
    (400-410), a blocking read in the backward span and a sync after the
    step."""
    return [
        ev(trace.SPAN, 0, 1000),
        ev("evae.step", 10, 500),
        ev("evae.step.forward", 20, 200),
        ev("evae.prior.reencode", 30, 100),
        ev("aten::conv2d", 38, 62, seq=7),
        ev("aten::convolution", 40, 60, seq=7),
        ev("cudaLaunchKernel", 45, 50, id=101),
        ev("aten::add", 120, 130, seq=8),
        ev("cudaLaunchKernel", 125, 128, id=103),
        ev("evae.step.backward", 210, 490),
        ev("autograd::engine::evaluate_function: ConvolutionBackward0",
           220, 260, thread=2, seq=7, fwd_thread=1),
        ev("ConvolutionBackward0", 221, 259, thread=2, seq=7, fwd_thread=1),
        ev("cudaLaunchKernel", 230, 235, thread=2, id=102),
        ev("aten::item", 448, 472),
        ev("aten::_local_scalar_dense", 450, 470),
        ev("cudaStreamSynchronize", 455, 465, id=105),
        ev("cudaStreamSynchronize", 600, 610, id=106),
        ev("conv_kernel", 300, 320, device=True, id=101),
        ev("conv_dgrad_kernel", 330, 370, device=True, id=102),
        ev("add_kernel", 380, 390, device=True, id=103),
        ev("mystery_kernel", 400, 410, device=True, id=104),
    ]


def readings(kind, events, *, units=1, rows=None):
    tr = trace.summarize(events, 1e-3)
    tr.spans = spans.reduce(events)
    tr.reencode_rows = rows
    return Readings(kind=kind, units=units, trace=tr, window_s=1.0,
                    window_units=10, flops_per_unit=1.0,
                    lse_calls_per_unit=[], lse_launches=0)


def test_a_device_operation_goes_to_every_span_open_at_its_launch():
    s = spans.reduce(train_events())
    assert s.counts["evae.step"] == 1 and s.counts["evae.prior.reencode"] == 1
    us = 1e-6
    # [ms launched inside, ms of its forward operators' backward]: the conv
    # in the re-encode, the add in the forward; the backward's kernel,
    # launched on a thread with no spans, falls under the span open then on
    # the thread that has them
    table = s.table(1)
    assert table["evae.prior.reencode"] == [pytest.approx(0.02),
                                            pytest.approx(0.04)]
    assert table["evae.step.forward"] == [pytest.approx(0.03),
                                          pytest.approx(0.04)]
    assert table["evae.step.backward"] == [pytest.approx(0.04), 0.0]
    assert table["evae.step"] == [pytest.approx(0.07), 0.0]
    assert s.unlinked == 1
    assert s.busy_s == pytest.approx(80 * us)
    assert s.covered_s == pytest.approx(70 * us)


def test_a_backward_function_goes_to_its_forward_span_by_sequence_number():
    s = spans.reduce(train_events())
    us = 1e-6
    assert s.device_s("evae.prior.reencode") == pytest.approx(60 * us)
    assert s.device_s("evae.step.forward") == pytest.approx(70 * us)
    assert s.device_s("evae.step.forward", without="evae.prior.reencode") \
        == pytest.approx(10 * us)
    assert s.device_s("evae.step.backward", within="evae.prior.reencode") \
        == pytest.approx(40 * us)
    # a sequence number that no forward operator inside a span holds links
    # nowhere
    events = train_events()
    for e in events:
        if e.name == "aten::convolution" or e.name == "aten::conv2d":
            e.sequence_nr = 9
    assert spans.reduce(events).device_s("evae.prior.reencode") == \
        pytest.approx(20 * us)


def test_host_syncs_are_counted_once_a_nest_inside_evae_step():
    s = spans.reduce(train_events())
    assert s.step_syncs == 1
    assert s.sync_sites == {
        "evae.step.backward > aten::item > aten::_local_scalar_dense": 1,
        "(no span) > cudaStreamSynchronize": 1}
    two = train_events() + [ev("evae.step", 700, 900),
                            ev("cudaDeviceSynchronize", 710, 720)]
    t = spans.reduce(two)
    assert t.step_syncs == 2 and t.count("evae.step") == 2


def test_idle_gaps_go_to_the_innermost_span():
    s = spans.reduce(train_events())
    # gaps 0-300 (mid 150: the forward), 320-330 (325: the backward) ...
    assert s.idle_by_span["evae.step.forward"] == pytest.approx(300e-6)
    assert s.idle_by_span["(no span)"] == pytest.approx(590e-6)
    # trace.py's (no host operator): the spans are host ranges there too,
    # so only the tail after the step (410-1000 us) is left unnamed
    assert s.no_host_op_s == pytest.approx(590e-6)


def test_the_train_readers():
    r = readings("train", train_events(), units=1, rows=(30, 20))
    assert read_metric("reencode_ms_per_step.train", r) == pytest.approx(0.06)
    assert read_metric("knn_ms_per_step.train", r) is None   # no such span
    assert read_metric("host_syncs_per_step.train", r) == pytest.approx(1.0)
    assert read_metric("reencode_rows_per_distinct.train", r) == \
        pytest.approx(1.5)
    for name in SCORE:
        assert read_metric(name, r) is None
    events = train_events() + [ev("evae.prior.knn", 22, 28),
                               ev("cudaLaunchKernel", 23, 24, id=107),
                               ev("topk", 290, 296, device=True, id=107)]
    r = readings("train", events, units=2)
    assert read_metric("knn_ms_per_step.train", r) == pytest.approx(0.003)
    assert read_metric("reencode_rows_per_distinct.train", r) is None


def test_the_score_readers():
    events = [
        ev(trace.SPAN, 0, 1000),
        ev("evae.iwae.chunk", 10, 900),
        ev("evae.iwae.encode", 20, 50),
        ev("cudaLaunchKernel", 30, 31, id=1),
        ev("evae.iwae.round", 60, 400),
        ev("evae.iwae.decode", 70, 200),
        ev("cudaLaunchKernel", 80, 81, id=2),
        ev("evae.prior.lse", 210, 300),
        ev("cudaLaunchKernel", 220, 221, id=3),
        ev("cudaLaunchKernel", 350, 351, id=4),
        ev("enc", 100, 110, device=True, id=1),
        ev("dec", 110, 150, device=True, id=2),
        ev("lse_partial_kernel", 250, 330, device=True, id=3),
        ev("lse_update", 400, 405, device=True, id=4),
    ]
    r = readings("score", events, units=1)
    assert read_metric("iwae_decode_ms_per_request.score", r) == \
        pytest.approx(0.04)
    assert read_metric("iwae_prior_ms_per_request.score", r) == \
        pytest.approx(0.08)
    for name in TRAIN:
        assert read_metric(name, r) is None
    assert r.trace.spans.covered_s == r.trace.spans.busy_s


@pytest.mark.parametrize("name", TRAIN + SCORE)
def test_no_spans_read_nothing_never_0(name):
    kind = "train" if name.endswith(".train") else "score"
    plain = [ev(trace.SPAN, 0, 100), ev("aten::mm", 10, 20),
             ev("cudaLaunchKernel", 12, 13, id=1),
             ev("gemm", 30, 60, device=True, id=1)]
    r = readings(kind, plain)
    assert read_metric(name, r) is None
    # a trace reduced without the spans (the hook not installed)
    tr = TraceSummary(window_s=1.0, busy_s=0.5, device_events=[])
    bare = Readings(kind=kind, units=1, trace=tr, window_s=1.0,
                    window_units=1, flops_per_unit=1.0,
                    lse_calls_per_unit=[], lse_launches=0)
    assert read_metric(name, bare) is None


def test_install_wraps_the_trace_reduction_once():
    spans.install()
    wrapped = trace.summarize
    spans.install()
    assert trace.summarize is wrapped and wrapped._with_spans
    s = trace.summarize(train_events(), 1e-3)
    assert s.spans.count("evae.step") == 1 and s.reencode_rows is None


def test_the_reencode_rows_are_the_counter_s_change_over_the_kept_calls(
        monkeypatch):
    from exemplar_vae_tpu_torch.train.loss import approx_log_p_top
    monkeypatch.setattr(approx_log_p_top, "rows", 100)
    approx_log_p_top.kept.clear()
    approx_log_p_top.kept.extend([(40, torch.tensor([[1, 1, 2]])),
                                  (70, torch.tensor([[3, 3, 3]]))])
    assert spans.reencode_rows() == (60, 3)
    assert not approx_log_p_top.kept and spans.reencode_rows() is None


def test_a_reduction_that_fails_fails_the_traced_run(monkeypatch):
    spans.install()

    def broken(events):
        raise RuntimeError("broken")

    monkeypatch.setattr(spans, "reduce", broken)
    with pytest.raises(RuntimeError, match="broken"):
        trace.summarize(train_events(), 1e-3)


@pytest.mark.parametrize("workload", ["convhvae-knn-train", "vae-exact-score"])
def test_a_traced_cell_on_the_cpu_reports_its_span_metrics(workload):
    """On the CPU no operation runs on a card: the device-time readers read
    nothing, the syncs and the re-encode's rows read the host's events and
    the port's kept selections."""
    import run
    cell = load_cell(workload)
    result = run.run_cell(cell, cpu_context(cell, trace=True))
    assert result["correct"], result
    metrics = result["metrics"]
    if workload == "convhvae-knn-train":
        assert metrics["host_syncs_per_step.train"]["value"] == 0.0
        assert metrics["reencode_rows_per_distinct.train"]["value"] >= 1.0
        assert "reencode_ms_per_step.train" not in metrics
    else:
        assert not set(SCORE) & set(metrics)
