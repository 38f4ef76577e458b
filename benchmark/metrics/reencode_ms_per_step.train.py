"""reencode_ms_per_step.train: device ms a train step under the port's
``evae.prior.reencode`` span (the neighbours' gather, preprocessing and
encode, with gradients), its backward included (portbench/spans.py), over
the profiled stretch of the train cells. Nothing without the span."""

from portbench import spans

spans.install()


def read(r):
    s = spans.spans_of(r, "train")
    if s is None or not s.count("evae.prior.reencode"):
        return None
    return 1e3 * s.device_s("evae.prior.reencode") / r.units
