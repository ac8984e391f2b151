"""Median host milliseconds per device batch (all steps of the chain,
ending in the copy of the images to the host), over the batches that
ended before the profiled stretch began."""

from bench_h100.metrics._common import median


def read(record):
    if record.get("kind") != "serve":
        return None
    m = median(record.get("unprofiled_batch_s", []))
    return None if m is None else m * 1e3
