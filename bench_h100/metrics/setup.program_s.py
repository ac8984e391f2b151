"""Seconds of the run's set-up the program spends in its own set-up
stages: the union of its ``setup.library`` (the kernel library's build
or load), ``setup.model`` (the model's construction and weights) and
``setup.warmup`` spans, which may nest."""

from bench_h100.metrics import _spans
from bench_h100.trace import busy_s


def read(record):
    if record.get("kind") not in ("serve", "train"):
        return None
    stages = [(s.name, s.start / 1e9, s.end / 1e9)
              for s in _spans.program_spans() if s.name.startswith("setup.")]
    return busy_s(stages) if stages else None
