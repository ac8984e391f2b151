"""The reader of the share of UNet forwards replayed as a CUDA graph
(``metrics/unet.graph_hit_pct.serve.py``), fed planted spans: it counts
the ``unet.forward`` spans of the batches that ended before the profiler
by their ``graphed`` attribute, and reads None where the forwards carry
no such attribute (a program without the graph runner) or no batch
ended before the profiler."""

import importlib.util
from pathlib import Path

import pytest

from bench_h100.metrics import _spans

READER = (Path(__file__).resolve().parent.parent / "metrics"
          / "unet.graph_hit_pct.serve.py")
MS = 1_000_000


def _read(record):
    spec = importlib.util.spec_from_file_location("graph_hit_reader", READER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(record)


def _spans_of(flags_by_batch):
    """Per batch (ids from 1), a ``sampler.step`` > ``unet.forward`` pair
    for each flag (None: no ``graphed`` attribute)."""
    out = []

    def add(name, t, key, parent, **attrs):
        s = type("Span", (), {})()
        s.name, s.id, s.key, s.attrs = name, len(out) + 1, key, attrs
        s.parent = None if parent is None else parent.id
        s.start, s.end = round(t * MS), round((t + 1) * MS)
        out.append(s)
        return s

    for bid, flags in enumerate(flags_by_batch, start=1):
        b = add("serve.batch", 100 * bid, bid, None)
        for i, flag in enumerate(flags):
            st = add("sampler.step", 100 * bid + i, bid, b)
            add("unet.forward", 100 * bid + i, bid, st,
                **({} if flag is None else {"graphed": flag, "rows": 48}))
    return out


RECORD = {"kind": "serve", "denoiser": "unet", "unprofiled_batches": 2}


@pytest.mark.parametrize("flags, want", [
    ([[True] * 4, [True] * 4, [False] * 4], 100.0),  # batch 3: profiled
    ([[False, False, True, True], [True] * 4], 75.0),
    ([[False] * 3, [False] * 3], 0.0),
    ([[None] * 4, [None] * 4], None),                # no graph runner
])
def test_share_of_graphed_forwards(monkeypatch, flags, want):
    monkeypatch.setattr(_spans, "program_spans", lambda: _spans_of(flags))
    got = _read(RECORD)
    assert got == (None if want is None else pytest.approx(want))


@pytest.mark.parametrize("record", [
    {"kind": "serve", "denoiser": "unet", "unprofiled_batches": 0},
    {"kind": "serve", "denoiser": "dit"},
    {"kind": "train"}, {}])
def test_none_without_batches(monkeypatch, record):
    monkeypatch.setattr(_spans, "program_spans",
                        lambda: _spans_of([[True] * 4, [True] * 4]))
    assert _read(record) is None


def test_none_without_spans(monkeypatch):
    monkeypatch.setattr(_spans, "program_spans", lambda: [])
    assert _read(RECORD) is None
