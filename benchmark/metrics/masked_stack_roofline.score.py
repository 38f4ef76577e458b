"""masked_stack_roofline.score: the least time of the PixelHVAE's masked
stack over the rows that the port's counter ``masked_stack.rows`` counted
in the profiled stretch of the score cells (portbench/flops/pixelhvae.py,
``masked_stack_bound_s``), over the device time under its
``evae.pixelcnn.stack`` spans (portbench/spans.py), in %.

The rows are the counter's change from the first of the stretch's stack
calls (the count before each call and the model's Config, which the port
keeps while a profiler runs; one call a span). Nothing without the span or
the counter, and nothing unless those rows are the rows the cell decodes:
one for each z row that its requests' pairwise-LSE calls score (points x
S a request)."""

from portbench import spans
from portbench.flops.pixelhvae import masked_stack_bound_s

spans.install()

STACK = "evae.pixelcnn.stack"
SHAPE = ("input_size", "pixelcnn_features", "pixelcnn_layers")


def stack_rows(calls: int):
    """(rows, the stack's shape as a dict) of the port's last ``calls``
    counted stack calls, or None where the port keeps no such count."""
    try:
        from exemplar_vae_tpu_torch.models import pixel_hvae
    except ImportError:
        return None
    counter = getattr(pixel_hvae, "masked_stack", None)
    kept = getattr(counter, "kept", None)
    if kept is None or not hasattr(counter, "rows") or len(kept) < calls:
        return None
    before, cfg = list(kept)[-calls]
    return counter.rows - before, {k: getattr(cfg, k) for k in SHAPE}


def read(r):
    s = spans.spans_of(r, "score")
    if s is None or not s.count(STACK):
        return None
    got = stack_rows(s.count(STACK))
    if got is None:
        return None
    rows, shape = got
    seconds = s.device_s(STACK)
    if (not seconds or rows != r.units * sum(
            call[0] for call in r.lse_calls_per_unit)):
        return None
    return 100.0 * masked_stack_bound_s(rows, shape) / seconds
