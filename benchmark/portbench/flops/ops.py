"""Operation records that the families' FLOP counters list.

A FLOP is half a multiply-add. Each record is one matrix product or
convolution of the algorithm: ``rows`` inputs of ``macs`` multiply-adds
each. In training the backward adds the weight gradient (as many again)
and, where the input needs a gradient (``dx``), the input gradient (as many
again); an input that is data needs none. Recomputation in the backward is
not counted: it is work of the implementation, not of the algorithm.
"""

from __future__ import annotations

from typing import NamedTuple


class Op(NamedTuple):
    name: str
    rows: int
    macs: int            # multiply-adds per row
    backward: bool       # weights (and the input, if dx) get gradients
    dx: bool = True      # the input needs a gradient
    t_stride: int = 1    # a transposed conv's stride (1: not transposed)

    @property
    def flops(self) -> float:
        passes = 1 + (1 + self.dx if self.backward else 0)
        return 2.0 * self.rows * self.macs * passes


def dense(name, rows, d_in, d_out, *, backward=False, dx=True) -> Op:
    return Op(name, rows, d_in * d_out, backward, dx)


def gated(name, rows, d_in, d_out, **kw) -> Op:
    """A gated dense layer: one product of width 2 * d_out."""
    return dense(name, rows, d_in, 2 * d_out, **kw)


def conv(name, rows, hw_out, c_in, c_out, k, *, backward=False, dx=True):
    return Op(name, rows, hw_out[0] * hw_out[1] * c_in * c_out * k * k,
              backward, dx)


def conv_t(name, rows, hw_in, c_in, c_out, k, stride, *, backward=False):
    """A transposed conv: every input pixel meets the whole kernel."""
    return Op(name, rows, hw_in[0] * hw_in[1] * c_in * c_out * k * k,
              backward, True, stride)


def total(ops) -> float:
    return float(sum(op.flops for op in ops))
