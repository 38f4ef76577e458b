"""host_syncs_per_step.train: host events that wait for the card (a
blocking read, aten::_local_scalar_dense, and the runtime's stream, device
and event synchronizations and blocking copies; a nest counts once) inside
the port's ``evae.step`` spans, per step, over the profiled stretch of the
train cells (portbench/spans.py). Nothing without the span."""

from portbench import spans

spans.install()


def read(r):
    s = spans.spans_of(r, "train", device=False)
    if s is None or not s.count(spans.STEP):
        return None
    return s.step_syncs / s.count(spans.STEP)
