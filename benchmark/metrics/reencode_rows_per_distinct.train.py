"""reencode_rows_per_distinct.train: the bank rows the approximate prior
re-encoded with gradients in the profiled stretch of the train cells (B*K
a step: the change of the port's counter ``approx_log_p_top.rows``) over
the distinct rows of each step's selection, summed over the steps (the
selections the port keeps while a profiler runs, portbench/spans.py). 1
means that no row was re-encoded twice in a step. Nothing where the port
keeps none."""

from portbench import spans

spans.install()


def read(r):
    if r.kind != "train" or r.trace is None:
        return None
    got = getattr(r.trace, "reencode_rows", None)
    if not got or not got[1]:
        return None
    rows, distinct = got
    return rows / distinct
