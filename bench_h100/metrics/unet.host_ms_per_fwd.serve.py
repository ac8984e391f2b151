"""Median host milliseconds to issue one UNet forward (the program's
``unet.forward`` span, one per sampler step), in the batches that ended
before the profiled stretch began; beside the device milliseconds of a
forward (``unet.device_ms_per_fwd.serve``)."""

from bench_h100.metrics import _spans
from bench_h100.metrics._common import median


def read(record):
    n = _spans.unprofiled_batches(record)
    if n is None:
        return None
    return median([_spans.ms(s) for s in _spans.in_batches(
        _spans.program_spans(), "unet.forward", n)])
