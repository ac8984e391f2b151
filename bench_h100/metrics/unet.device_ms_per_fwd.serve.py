"""Device-busy milliseconds per UNet forward: the union of the device
intervals of the batches served wholly inside the profiled stretch, over
their forwards (those batches x the chain's steps)."""

from bench_h100.metrics import _serve


def read(record):
    busy = _serve.busy_per_forward_s(record)
    return None if busy is None else busy * 1e3
