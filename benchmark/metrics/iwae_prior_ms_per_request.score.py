"""iwae_prior_ms_per_request.score: device ms a request under the port's
``evae.prior.lse`` spans inside ``evae.iwae.chunk`` (the exemplar prior of
each IWAE round: the pairwise-LSE kernel or the scan, and its glue), over
the profiled stretch of the score cells (portbench/spans.py). Nothing
without the span."""

from portbench import spans

spans.install()


def read(r):
    s = spans.spans_of(r, "score")
    if s is None or not s.count("evae.prior.lse"):
        return None
    return 1e3 * s.device_s("evae.prior.lse",
                            within="evae.iwae.chunk") / r.units
