"""device_idle_pct.train: the share of the profiled stretch of the train cells
in which no operation ran on the card (one minus the union of the device
operations' intervals over the stretch's host-clock length). The
profiler's own host cost lengthens host-bound stretches, so this reads
high there: an upper estimate."""

from portbench.readers import idle_pct


def read(r):
    return idle_pct(r, "train")
