"""knn_ms_per_step.train: device ms a train step under the port's
``evae.prior.knn`` span (the distances to the cache and the top-K), over the
profiled stretch of the train cells (portbench/spans.py). Nothing without
the span."""

from portbench import spans

spans.install()


def read(r):
    s = spans.spans_of(r, "train")
    if s is None or not s.count("evae.prior.knn"):
        return None
    return 1e3 * s.device_s("evae.prior.knn") / r.units
