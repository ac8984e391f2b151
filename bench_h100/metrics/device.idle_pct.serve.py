"""The device's idle share inside a served batch: 1 - (device-busy time
per forward, over the batches served wholly inside the profiled stretch)
/ (wall time per forward, the median unprofiled batch over its steps).
The profiler slows this host-bound code, so its own wall clock would
overstate the idle time."""

from bench_h100.metrics import _serve
from bench_h100.metrics._common import median


def read(record):
    busy = _serve.busy_per_forward_s(record)
    wall = median(record.get("unprofiled_batch_s", []))
    if busy is None or not wall:
        return None
    return 100.0 * (1.0 - busy / (wall / record["steps"]))
