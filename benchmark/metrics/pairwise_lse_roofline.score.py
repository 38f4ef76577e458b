"""pairwise_lse_roofline.score: the pairwise log-sum-exp kernel's calls in the
profiled stretch of the score cells, their summed least time
(portbench/flops/pairwise_lse.py) over the kernel's summed device time,
read from the trace by its kernel names. Nothing when the kernel did not
run; the port's launch counter must equal the calls the cell makes."""

from portbench.readers import lse_roofline


def read(r):
    return lse_roofline(r, "score")
