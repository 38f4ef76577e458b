"""launches_per_step.train: device operations (kernels, copies, fills) in
the profiled stretch of a train cell, per train step."""

from portbench.readers import launches_per_step


def read(r):
    return launches_per_step(r, "train")
