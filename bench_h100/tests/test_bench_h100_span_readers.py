"""The readers of the program's own spans, fed a planted record and
planted spans: the serving readers take the batches that ended before
the profiler and the requests served in them; the idle-in-UNet share
pairs the trace's copies to the host with the copy-back spans and puts
the spans on the trace's clock under a planted clock offset; the training readers take the window's steps before the
profiled ones; set-up is the union of the set-up stages.  Each reads
None where the program recorded no spans."""

import importlib.util
import sys
from pathlib import Path

import pytest

from bench_h100.metrics import _spans

METRICS = Path(__file__).resolve().parent.parent / "metrics"
MS = 1_000_000                 # nanoseconds a millisecond
OFFSET_S = 0.25                # the program's clock less the trace's


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "span_reader_" + name.replace(".", "_"), METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Planted:
    """Spans as the tracer keeps them, ids given in order."""

    def __init__(self):
        self.spans = []

    def add(self, name, start_ms, end_ms, key=None, parent=None, **attrs):
        s = type("Span", (), {})()
        s.name, s.id, s.key, s.attrs = name, len(self.spans) + 1, key, attrs
        s.parent = None if parent is None else parent.id
        s.start, s.end = round(start_ms * MS), round(end_ms * MS)
        self.spans.append(s)
        return s


def _batch(p, bid, t0, fwd_ms, step_ms, views, ids):
    """A served batch of 2 steps from ``t0`` ms: h2d, 2 x (step >
    forward), 1 ms of the host's own work, copy back; each step
    ``step_ms`` with a ``fwd_ms`` forward."""
    b = p.add("serve.batch", t0, t0 + 1 + 2 * step_ms + 2, key=bid,
              requests=len(ids), views=views, rows=48, request_ids=ids)
    p.add("serve.h2d", t0, t0 + 0.5, key=bid, parent=b)
    for i in range(2):
        a = t0 + 1 + i * step_ms
        st = p.add("sampler.step", a, a + step_ms, key=bid, parent=b)
        p.add("unet.forward", a, a + fwd_ms, key=bid, parent=st)
    end = t0 + 1 + 2 * step_ms
    p.add("serve.copy_back", end + 1, end + 2, key=bid, parent=b)
    return b


def _request(p, rid, bid, t0, wait_ms, decode_ms, encode_ms):
    r = p.add("serve.request", t0, t0 + 100, key=rid)
    p.add("serve.decode", t0, t0 + decode_ms, key=rid, parent=r)
    p.add("serve.queue", t0 + decode_ms, t0 + decode_ms + wait_ms, key=rid,
          parent=r, batch=bid)
    p.add("serve.encode", t0 + 90, t0 + 90 + encode_ms, key=rid, parent=r)


def _trace_s(ms):
    """A program-clock reading in ms on the trace's clock, in s."""
    return ms / 1e3 - OFFSET_S


def _served():
    p = Planted()
    _request(p, 1, 1, 0, 10, 1, 2)
    _request(p, 2, 1, 0, 20, 2, 2)
    _request(p, 3, 2, 100, 30, 5, 1)
    _request(p, 4, 3, 200, 40, 9, 9)     # served under the profiler
    _batch(p, 1, 1000, 2, 3, 3, (1, 2))
    _batch(p, 2, 2000, 3, 4, 5, (3,))
    _batch(p, 3, 3000, 2, 3, 40, (4,))
    # the profiled stretch on the trace's clock: the end of batch 2
    # (its copy back 2010-2011 holds its copy to the host at
    # 2010.2-2010.4, so it allows offsets from 0.2 ms below the planted
    # one to 0.6 ms above), then all of batch 3: steps at 3001-3004 and
    # 3004-3007 (forwards 3001-3003, 3004-3006), its copy to the host
    # filling its copy back at 3008-3009 (the planted offset exactly)
    ops = [("k", 2006.0, 2007.0), ("Memcpy DtoH", 2010.2, 2010.4),
           ("k", 3001.5, 3002.0), ("k", 3002.5, 3003.5),   # gap: forward
           ("k", 3004.1, 3005.0),                           # gap: step
           ("k", 3006.2, 3006.5),                           # gap: forward
           ("Memcpy DtoH", 3008.0, 3009.0)]                 # gap: batch
    record = {"kind": "serve", "denoiser": "unet", "steps": 2,
              "unprofiled_batches": 2,
              "device_ops": [(n, _trace_s(a), _trace_s(b))
                             for n, a, b in ops]}
    return record, p.spans


@pytest.fixture
def served(monkeypatch):
    record, spans = _served()
    monkeypatch.setattr(_spans, "program_spans", lambda: spans)
    return record


@pytest.mark.parametrize("name, want", [
    ("serve.queue_wait_ms", 30.0),         # nearest-rank p95 of 10, 20, 30
    ("serve.codec_ms", 4.0),               # median of 3, 4, 6
    ("serve.padded_rows_pct", 100.0 * (96 - 8) / 96),
    ("unet.host_ms_per_fwd.serve", 2.5),   # 2, 2, 3, 3
    ("sampler.self_ms_per_step.serve", 1.0),
    ("device.idle_in_unet_pct.serve", 100.0 * 1.7 / 3.8),
])
def test_serving_readers(served, name, want):
    assert _reader(name)(served) == pytest.approx(want, rel=1e-9)


def test_copy_back_alignment_reads_the_planted_offset(served):
    offset, half, brackets, batches = _spans.served_batches(
        served, _spans.program_spans())
    assert brackets == [
        (pytest.approx(OFFSET_S - 2e-4, abs=1e-9),
         pytest.approx(OFFSET_S + 6e-4, abs=1e-9)),
        (pytest.approx(OFFSET_S, abs=1e-9),) * 2]
    assert offset == pytest.approx(OFFSET_S, abs=1e-9)
    assert half == pytest.approx(0.0, abs=1e-9)
    # batch 2 began before the stretch: only batch 3 is read
    assert [span.key for _, span, _ in batches] == [3]
    assert len(batches[0][0]) == 5
    by, total, _ = _spans.served_idle_by_span(served, _spans.program_spans())
    assert total == pytest.approx(3.8e-3)
    assert by["unet.forward"] == pytest.approx(1.7e-3)
    assert by["sampler.step"] == pytest.approx(0.6e-3)
    assert by["serve.batch"] == pytest.approx(1.5e-3)


def test_copies_pair_by_their_spacing(monkeypatch):
    """A run of copy-back spans whose spacing matches the copies' wins,
    wherever the copies fall in the run."""
    p = Planted()
    starts = [1000, 1900, 3150, 4000, 5200]           # 900, 1250, 850, 1200
    spans = [p.add("serve.copy_back", s, s + 1) for s in starts]
    copies = [(_trace_s(s + 0.5), _trace_s(s + 0.6)) for s in starts[2:4]]
    got = _spans.pair_copies(spans, copies)
    assert [s.start // MS for s, _ in got] == [3150, 4000]
    assert _spans.pair_copies(spans[:1], copies) == []


@pytest.mark.parametrize("brackets, want", [
    # each batch allows a range; together they allow 0.7..1.2
    ([(0.0, 1.2), (0.7, 2.0), (0.5, 1.5)], (0.95, 0.25)),
    # a copy back that returns late widens its own bracket only
    ([(1.0, 1.0), (0.2, 3.0)], (1.0, 0.0)),
    # brackets that do not meet: the half-width says so
    ([(0.0, 1.0), (2.0, 3.0)], (1.5, -0.5)),
])
def test_clock_offset_is_the_middle_of_what_every_batch_allows(
        brackets, want):
    got = _spans.clock_offset(brackets)
    assert got == (pytest.approx(want[0]), pytest.approx(want[1]))


def test_no_alignment_without_the_copies_or_the_spans(monkeypatch):
    record, spans = _served()
    del record["device_ops"]                       # an untraced run
    monkeypatch.setattr(_spans, "program_spans", lambda: spans)
    assert _reader("device.idle_in_unet_pct.serve")(record) is None
    record, spans = _served()
    spans = [s for s in spans if s.name != "serve.copy_back"]
    monkeypatch.setattr(_spans, "program_spans", lambda: spans)
    assert _reader("device.idle_in_unet_pct.serve")(record) is None


def test_idle_by_innermost_span():
    ops = [("a", 0.0, 1.0), ("b", 2.0, 3.0), ("c", 5.0, 6.0),
           ("d", 6.0, 7.0), ("e", 9.0, 9.5)]
    ranges = [("outer", 0.0, 7.5), ("inner", 1.2, 1.8), ("late", 3.5, 4.5)]
    by, total = _spans.idle_by_span(ops, ranges)
    assert total == pytest.approx(1.0 + 2.0 + 2.0)
    assert by == {"inner": 1.0, "late": 2.0, "no span": 2.0}


def _trained():
    p = Planted()
    for i in range(7):      # 2 checked, 3 in the window, 2 profiled
        st = p.add("train.step", 100 * i, 100 * i + 10, key=i)
        p.add("train.h2d", 100 * i, 100 * i + i, key=i, parent=st)
        p.add("train.forward", 100 * i + i, 100 * i + 8, key=i, parent=st)
    return {"kind": "train", "window_steps": 3, "profile_steps": 2}, p.spans


@pytest.mark.parametrize("name, want", [("train.h2d_ms", 3.0),
                                        ("train.host_ms_per_step", 7.0)])
def test_training_readers_take_the_window(monkeypatch, name, want):
    record, spans = _trained()
    monkeypatch.setattr(_spans, "program_spans", lambda: spans)
    assert _reader(name)(record) == pytest.approx(want)
    del record["profile_steps"]        # an untraced run
    assert _reader(name)(record) is None


def test_setup_is_the_union_of_the_stages(monkeypatch):
    p = Planted()
    p.add("setup.model", 0, 1000)
    w = p.add("setup.warmup", 1500, 3000)
    p.add("setup.library", 2000, 2500, parent=w)
    p.add("sampler.step", 2600, 2700, parent=w)
    monkeypatch.setattr(_spans, "program_spans", lambda: p.spans)
    read = _reader("setup.program_s")
    for kind in ("serve", "train"):
        assert read({"kind": kind}) == pytest.approx(2.5)


NAMES = ["serve.queue_wait_ms", "serve.codec_ms", "serve.padded_rows_pct",
         "unet.host_ms_per_fwd.serve", "sampler.self_ms_per_step.serve",
         "device.idle_in_unet_pct.serve", "train.h2d_ms",
         "train.host_ms_per_step", "setup.program_s"]


@pytest.mark.parametrize("name", NAMES)
def test_none_without_spans(monkeypatch, name):
    """A program that records no spans (one without the tracer, or with
    it off) leaves every span metric out of the line."""
    for record in (_served()[0], _trained()[0], {"kind": "serve"}, {}):
        monkeypatch.setattr(_spans, "program_spans", lambda: [])
        assert _reader(name)(record) is None


def test_program_without_a_tracer_gives_no_spans(monkeypatch):
    import viewfusion_tpu_torch

    monkeypatch.delattr(viewfusion_tpu_torch, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "viewfusion_tpu_torch.tracing", None)
    assert _spans.program_spans() == []


def test_program_spans_are_the_tracers():
    from viewfusion_tpu_torch import tracing

    mark = tracing.mark()
    with tracing.span("setup.model"):
        pass
    got = [s for s in _spans.program_spans() if s.id > mark]
    assert [s.name for s in got] == ["setup.model"]
