"""mfu.score: the model FLOPs of the window's requests (the configuration's
counter, portbench/flops/<family>.py) over the window's host-clock time,
as a share of the card's dense TF32 peak (portbench/common.py)."""

from portbench.readers import mfu


def read(r):
    return mfu(r, "score")
