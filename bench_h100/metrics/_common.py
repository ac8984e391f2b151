"""Helpers of the per-layer readers.  A reader is ``metrics/<name>.py``
with ``read(record) -> float | None``; it returns None where the run's
record has nothing for it to read."""

from __future__ import annotations

import statistics
from pathlib import Path

from bench_h100 import harness
from bench_h100.trace import kernel_s
from bench_h100.work import h100


def traced(record) -> bool:
    return "device_ops" in record and record.get("busy_s", 0) > 0


def roofline_pct(record, names, bound_s) -> float | None:
    """100 x ``bound_s``, the bound time of the work the profiled stretch
    needs of the kernels ``names``, over their traced time."""
    if not traced(record):
        return None
    seconds, count = kernel_s(record["device_ops"], names)
    if not count or seconds <= 0:
        return None
    return 100.0 * bound_s / seconds


def work(record, reader: str):
    """The work module of the record's model family,
    ``work/<denoiser>.py`` in the benchmark folder that holds the reader
    (``reader`` is the reader's ``__file__``)."""
    return harness.family_module("work", record["denoiser"],
                                 Path(reader).resolve().parents[1])


def median(values):
    return statistics.median(values) if values else None


PEAK_BF16 = h100.PEAK_FLOPS["bfloat16"]
