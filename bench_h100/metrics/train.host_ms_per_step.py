"""Median host milliseconds to issue one training step outside its
copies to the device (a ``train.step`` span less its ``train.h2d``),
over the steps of the timed window; beside the device milliseconds of a
step (``train.device_ms_per_step``)."""

from bench_h100.metrics import _spans
from bench_h100.metrics._common import median


def read(record):
    spans = _spans.program_spans()
    steps = _spans.window_steps(record, spans)
    return median([_spans.ms(s) - h for s, h in zip(
        steps, _spans.h2d_ms_by_step(spans, steps))])
