"""What the span readers share: the program's own spans
(``viewfusion_tpu_torch.tracing``), read in the process that ran the
cell once the driver has returned, and picked by what the run's record
says; and the alignment of a served batch's spans with the device trace.

A span has ``name``, ``id``, ``parent``, ``key``, ``start`` and ``end``
(``time.perf_counter_ns``) and ``attrs``.  In a served batch every span
of the worker thread is keyed by the batch id, which counts the served
batches from 1; a request's spans are keyed by its id.  Every helper
gives [] or None where the program recorded no spans (a program without
the tracer, or with it off)."""

from __future__ import annotations

import bisect
from collections import Counter

from bench_h100.trace import busy_intervals


def program_spans():
    """The program's finished spans in this process, in the order they
    ended; [] where the program has no tracer."""
    try:
        from viewfusion_tpu_torch import tracing
    except ImportError:
        return []
    return tracing.spans()


def ms(span) -> float:
    return (span.end - span.start) / 1e6


def children(spans):
    """{parent id: [child spans]}."""
    out = {}
    for s in spans:
        if s.parent is not None:
            out.setdefault(s.parent, []).append(s)
    return out


def descendants(spans, root) -> list:
    """``root``'s spans below it, at every depth."""
    kids, out, todo = children(spans), [], [root.id]
    while todo:
        for s in kids.get(todo.pop(), []):
            out.append(s)
            todo.append(s.id)
    return out


# ---------------------------------------------------------------------
# serving


def unprofiled_batches(record):
    """How many batches ended before the profiler started, in a traced
    serving run (ids 1..n: those the profiler did not slow), else
    None."""
    if record.get("kind") != "serve":
        return None
    return record.get("unprofiled_batches") or None


def in_batches(spans, name, n):
    """The spans ``name`` of the worker thread in batches 1..n."""
    return [s for s in spans if s.name == name and s.key is not None
            and 1 <= s.key <= n]


def unprofiled_queue_waits(spans, n):
    """The ``serve.queue`` spans of the requests served in batches
    1..n."""
    return [s for s in spans if s.name == "serve.queue"
            and 1 <= s.attrs.get("batch", 0) <= n]


def self_ms(spans, name, child, n) -> list:
    """Each span ``name`` of batches 1..n less its ``child`` spans."""
    kids = children(spans)
    return [ms(s) - sum(ms(c) for c in kids.get(s.id, [])
                        if c.name == child)
            for s in in_batches(spans, name, n)]


def bracket(span, copy):
    """The (lowest, highest) offset, s, of the program's clock from the
    trace's that one ``serve.copy_back`` span and the copy to the host
    it waited for ((start, end) on the trace's clock) allow: the copy
    cannot start before the span began nor end after it returned."""
    return span.start / 1e9 - copy[0], span.end / 1e9 - copy[1]


def clock_offset(brackets):
    """(offset, half-width), s: the middle of the offsets that every
    bracket allows (their intersection) and how far the true offset may
    lie from it; the half-width is negative where they do not meet."""
    lo = max(a for a, _ in brackets)
    hi = min(b for _, b in brackets)
    return (lo + hi) / 2, (hi - lo) / 2


def pair_copies(copy_backs, copies):
    """Pair the device's copies to the host ((start, end), in order) with
    the program's ``serve.copy_back`` spans (in order), one batch each:
    of every run of consecutive spans as long as the copies, the one
    whose brackets agree best (the least gap between the highest lowest
    and the lowest highest offset).  Batches are seconds apart and their
    brackets a millisecond wide, so only the true pairing agrees.  []
    where there are more copies than spans."""
    m = len(copies)
    if m == 0 or m > len(copy_backs):
        return []
    best = None
    for shift in range(len(copy_backs) - m + 1):
        pairs = list(zip(copy_backs[shift:shift + m], copies))
        _, half = clock_offset([bracket(s, c) for s, c in pairs])
        if best is None or half > best[0]:
            best = (half, pairs)
    return best[1]


def served_batches(record, spans):
    """The profiled stretch of a traced serving run on the program's
    clock: (offset, half-width, brackets, batches).  Each copy to the
    host in the trace (``record["device_ops"]``) is paired with the
    ``serve.copy_back`` that waited for it (:func:`pair_copies`), and
    the pairs' brackets give the offset (:func:`clock_offset`).  A
    batch is (its device ops, its ``serve.batch`` span, the spans below
    it) for each paired batch that began inside the stretch: its ops
    are those from its span's start to the end of its copy.  None where
    nothing pairs."""
    if record.get("kind") != "serve" or not record.get("device_ops"):
        return None
    ops = record["device_ops"]
    copies = [(a, b) for n, a, b in ops if "DtoH" in n]
    batch_of = {s.id: s for s in spans if s.name == "serve.batch"}
    copy_backs = sorted((s for s in spans if s.name == "serve.copy_back"
                         and s.parent in batch_of), key=lambda s: s.start)
    pairs = pair_copies(copy_backs, copies)
    if not pairs:
        return None
    brackets = [bracket(s, c) for s, c in pairs]
    offset, half = clock_offset(brackets)
    batches = []
    for cb, (_, end) in pairs:
        span = batch_of[cb.parent]
        begin = span.start / 1e9 - offset
        if begin >= ops[0][1]:
            batches.append(([o for o in ops if begin <= o[1] <= end],
                            span, descendants(spans, span)))
    return offset, half, brackets, batches


def on_trace(spans, offset_s):
    """(name, start, end) of ``spans`` on the trace's clock."""
    return [(s.name, s.start / 1e9 - offset_s, s.end / 1e9 - offset_s)
            for s in spans]


def served_idle_by_span(record, spans, offset=None):
    """(Counter of idle seconds by the innermost span over each gap's
    midpoint, idle seconds in all, the brackets) over the batches of
    :func:`served_batches`, the spans put on the trace's clock by its
    offset (or by ``offset``); None where nothing pairs."""
    got = served_batches(record, spans)
    if got is None or not got[3]:
        return None
    own, _, brackets, batches = got
    offset = own if offset is None else offset
    by, total = Counter(), 0.0
    for ops, span, below in batches:
        b, t = idle_by_span(ops, on_trace([span] + below, offset))
        by.update(b)
        total += t
    return by, total, brackets


# ---------------------------------------------------------------------
# the device's idle time, by span


def idle_by_span(ops, ranges):
    """(Counter, total): the idle gaps between the device intervals of
    ``ops`` ((name, start, end), seconds), summed by the innermost of
    ``ranges`` ((name, start, end) on the same clock, nested or apart)
    that covers each gap's midpoint (the one begun last), or "no span";
    and the idle seconds in all."""
    merged = busy_intervals(ops)
    ranges = sorted(ranges, key=lambda r: r[1])
    starts = [r[1] for r in ranges]
    by, total = Counter(), 0.0
    for (_, a), (b, _) in zip(merged, merged[1:]):
        gap = b - a
        if gap <= 0:
            continue
        mid = (a + b) / 2
        label = "no span"
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if ranges[i][2] >= mid:
                label = ranges[i][0]
                break
        by[label] += gap
        total += gap
    return by, total


# ---------------------------------------------------------------------
# training


def window_steps(record, spans):
    """The ``train.step`` spans of the timed window: the record's
    ``window_steps`` steps before its last ``profile_steps`` (the steps
    profiled after the window), in a traced one-card training run; []
    otherwise."""
    if record.get("kind") != "train" or "profile_steps" not in record:
        return []
    steps = sorted((s for s in spans if s.name == "train.step"),
                   key=lambda s: s.start)
    n, p = record.get("window_steps", 0), record["profile_steps"]
    if n <= 0 or len(steps) < n + p:
        return []
    return steps[len(steps) - p - n:len(steps) - p]


def h2d_ms_by_step(spans, steps) -> list:
    """Each step's ``train.h2d`` milliseconds (all its microbatches)."""
    kids = children(spans)
    return [sum(ms(c) for c in kids.get(s.id, []) if c.name == "train.h2d")
            for s in steps]
