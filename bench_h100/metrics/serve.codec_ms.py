"""Median milliseconds of a request's host codec work: its
``serve.decode`` (JSON parse and the views' decode) plus its
``serve.encode`` (the PNG and base64 encode of the reply, not its send),
over the requests of the batches that ended before the profiled stretch
began.  The spans time wall clock on the handler thread, so the reading
includes the handler's waits for the GIL, which the sampler loop holds:
a change to the loop can move it where the codec does not change."""

from bench_h100.metrics import _spans
from bench_h100.metrics._common import median


def read(record):
    n = _spans.unprofiled_batches(record)
    if n is None:
        return None
    spans = _spans.program_spans()
    ids = {s.key for s in _spans.unprofiled_queue_waits(spans, n)}
    codec = {}
    for s in spans:
        if s.name in ("serve.decode", "serve.encode") and s.key in ids:
            codec.setdefault(s.key, {})[s.name] = _spans.ms(s)
    return median([sum(v.values()) for v in codec.values()
                   if len(v) == 2])
