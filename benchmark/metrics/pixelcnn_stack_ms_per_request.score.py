"""pixelcnn_stack_ms_per_request.score: device ms a request under the port's
``evae.pixelcnn.stack`` spans (the PixelHVAE's teacher-forced masked stack
and 1x1 head, one a round), over the profiled stretch of the score cells
(portbench/spans.py). Nothing without the span."""

from portbench import spans

spans.install()

STACK = "evae.pixelcnn.stack"


def read(r):
    s = spans.spans_of(r, "score")
    if s is None or not s.count(STACK):
        return None
    return 1e3 * s.device_s(STACK) / r.units
