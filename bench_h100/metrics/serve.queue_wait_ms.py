"""95th percentile (nearest rank) of the milliseconds a request waited in
the server's queue (the program's ``serve.queue`` span: from its enqueue
in ``submit`` until the worker took it into a batch), over the requests
of the batches that ended before the profiled stretch began."""

from bench_h100.harness import percentile
from bench_h100.metrics import _spans


def read(record):
    n = _spans.unprofiled_batches(record)
    if n is None:
        return None
    waits = _spans.unprofiled_queue_waits(_spans.program_spans(), n)
    return percentile([_spans.ms(s) for s in waits], 95) if waits else None
