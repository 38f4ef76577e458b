"""iwae_decode_ms_per_request.score: device ms a request under the port's
``evae.iwae.decode`` spans (each IWAE round's reparameterization, z1 nets,
decoder and reconstruction log-likelihood) and not under
``evae.prior.lse``, over the profiled stretch of the score cells
(portbench/spans.py). Nothing without the span."""

from portbench import spans

spans.install()


def read(r):
    s = spans.spans_of(r, "score")
    if s is None or not s.count("evae.iwae.decode"):
        return None
    return 1e3 * s.device_s("evae.iwae.decode",
                            without="evae.prior.lse") / r.units
