"""Device-busy milliseconds per training step: the union of device
intervals over the steps profiled after the window."""

from bench_h100.metrics._common import traced


def read(record):
    if record.get("kind") != "train" or not traced(record):
        return None
    return record["busy_s"] / record["profile_steps"] * 1e3
