"""The device's idle share of a training step: 1 - (device-busy time per
step, profiled) / (wall time per step of the unprofiled window).  The
profiler slows the host's launches, so its own wall clock would
overstate the idle time."""

from bench_h100.metrics._common import traced


def read(record):
    if record.get("kind") != "train" or not traced(record):
        return None
    steps = record.get("window_steps", 0)
    if steps <= 0:
        return None
    wall = record["window_elapsed_s"] / steps
    busy = record["busy_s"] / record["profile_steps"]
    return 100.0 * (1.0 - busy / wall)
