"""Median host milliseconds of a sampler step outside its UNet forward
(a ``sampler.step`` span less its ``unet.forward``: the step's own
arithmetic and draws), in the batches that ended before the profiled
stretch began."""

from bench_h100.metrics import _spans
from bench_h100.metrics._common import median


def read(record):
    n = _spans.unprofiled_batches(record)
    if n is None:
        return None
    return median(_spans.self_ms(_spans.program_spans(),
                                        "sampler.step", "unet.forward", n))
