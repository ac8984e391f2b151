"""Median milliseconds of a training step's copies to the device (the
program's ``train.h2d`` spans, ``Trainer._put``), over the steps of the
timed window (the window's steps, before the steps profiled after it)."""

from bench_h100.metrics import _spans
from bench_h100.metrics._common import median


def read(record):
    spans = _spans.program_spans()
    steps = _spans.window_steps(record, spans)
    return median(_spans.h2d_ms_by_step(spans, steps))
