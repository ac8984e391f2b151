"""Spans and counters of the port, kept in memory.

A span is one stretch of a layer's work: its name, its start and end on
``time.perf_counter_ns()``, its id, the id of its parent (the span open
on the same thread when it began), a key (a request, batch or step id,
inherited from the parent when not given) and a few integer attributes.
Finished spans go to one bounded ring (``RING`` of them, the newest
kept); nothing is written to disk.  Open one as a context manager::

    with tracing.span("train.step", key=step):
        ...

or, for the one span that crosses threads (a request's wait in the
server's queue), as an explicit pair: ``begin(name, stack=False)`` on
one thread and ``end(span)`` on another.

The granularity is fixed and coarse: a fixed number of spans per
request, batch, sampler step, UNet forward, train phase and set-up
stage, never one per kernel launch or module, so recording stays on by
default (a few microseconds a span); ``enable(False)`` turns it off for
the process.  While ``torch.profiler`` runs, a span on a thread's stack
also opens a profiler range of its name, so the program's layers appear
in the profiler's trace (the ranges of the thread that runs the
profiler) on its clock.  The range is the fast function-scope one
(``torch._C._profiler._RecordFunctionFast``), not
``torch.profiler.record_function``: a user-scope range also gets a
device-side copy over the kernels it launched, which a reduction of the
trace to device busy time would count as busy.

A counter is a name and an integer.  :func:`counters` returns one
snapshot of them and of the attributes registered with :func:`watch`
(the kernel wrappers' ``launches``, ``grad_copies`` and
``input_copies``), read where they are kept.

The names the port records (``PERF.md`` lists the readers of each):

  * serving: ``serve.request`` (key: request id) with ``serve.decode``,
    ``serve.queue`` (attribute ``batch``) and ``serve.encode``;
    ``serve.assemble`` and ``serve.batch`` (key: batch id; attributes
    ``request_ids``, ``requests``, ``views``, ``rows``) with
    ``serve.h2d``, the sampler's steps and ``serve.copy_back``; counters
    ``serve.refused``, ``serve.timed_out``, ``serve.abandoned``;
  * the samplers: ``sampler.step``, each with its ``unet.forward`` (one
    per denoiser call, in training too; attributes ``graphed``, whether
    a CUDA graph was replayed, and ``rows``, the denoiser's batch);
    counters ``unet.graph_captures``, ``unet.graph_replays`` and
    ``unet.graph_bypassed`` (``models/graphed.py``);
  * training: ``train.step`` (key: updates made before it) with
    ``train.h2d``, ``train.forward``, ``train.backward``,
    ``train.optimizer``, ``train.ema`` and, on more than one rank,
    ``train.allreduce``; the experiment loop's ``experiment.feed_wait``
    and ``eval.pass`` (key: iteration);
  * set-up: ``setup.library`` (attribute ``built``), ``setup.model``,
    ``setup.warmup``.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from contextlib import nullcontext
from typing import Dict, List, Optional

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler

__all__ = ["RING", "Span", "Tracer", "enable", "span", "begin", "end",
           "count", "watch", "watched", "add_watched", "counters", "spans",
           "mark"]

RING = 1 << 16
"""Finished spans kept: a benchmark run records about 7 a train step or
104 a served batch and 4 a request, ~5,000 in its longest run."""

_NULL = nullcontext()


class Span:
    """One span; ``end`` is None while it is open."""

    __slots__ = ("name", "id", "parent", "key", "start", "end", "attrs",
                 "_rf")

    def __init__(self, name, id_, parent, key, start, attrs):
        self.name, self.id, self.parent, self.key = name, id_, parent, key
        self.start, self.end, self.attrs = start, None, attrs
        self._rf = None

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9

    def __repr__(self):
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"key={self.key}, {self.start}..{self.end}, {self.attrs})")


class _Scope:
    """``with tracer.span(...)``: begins on enter, ends on exit."""

    __slots__ = ("_tracer", "_args", "_span")

    def __init__(self, tracer, args):
        self._tracer, self._args = tracer, args

    def __enter__(self) -> Optional[Span]:
        name, key, attrs = self._args
        self._span = self._tracer.begin(name, key, **attrs)
        return self._span

    def __exit__(self, *exc) -> None:
        self._tracer.end(self._span)


class Tracer:
    """A ring of finished spans, each thread's stack of open ones, and
    the counters.  The module's functions use one process-wide tracer."""

    def __init__(self, maxlen: int = RING):
        self._ring: "deque[Span]" = deque(maxlen=maxlen)
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._counts: Dict[str, int] = {}
        self._watched: Dict[str, tuple] = {}
        self._lock = threading.Lock()
        self._on = True

    def enable(self, on: bool = True) -> None:
        self._on = bool(on)

    def _stack(self) -> List[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def span(self, name: str, key=None, **attrs):
        """A context manager that records ``name`` around its block and
        yields the open :class:`Span` (None while recording is off)."""
        if not self._on:
            return _NULL
        return _Scope(self, (name, key, attrs))

    def begin(self, name: str, key=None, start: Optional[int] = None,
              stack: bool = True, **attrs) -> Optional[Span]:
        """Open a span now (or at ``start``, a ``perf_counter_ns``
        reading) under the span open on this thread.  With ``stack`` it
        is the parent of what this thread opens until :meth:`end`;
        without, it may be ended on another thread.  None while
        recording is off."""
        if not self._on:
            return None
        st = self._stack()
        parent = st[-1] if st else None
        if key is None and parent is not None:
            key = parent.key
        sp = Span(name, next(self._ids),
                  None if parent is None else parent.id, key,
                  time.perf_counter_ns() if start is None else start, attrs)
        if stack:
            st.append(sp)
            if _autograd_profiler._is_profiler_enabled:
                sp._rf = _RecordFunctionFast(name)
                sp._rf.__enter__()
        return sp

    def end(self, sp: Optional[Span], end: Optional[int] = None,
            **attrs) -> None:
        """Close ``sp`` now (or at ``end``), adding ``attrs``, and keep
        it in the ring; nothing for None."""
        if sp is None:
            return
        sp.end = time.perf_counter_ns() if end is None else end
        if attrs:
            sp.attrs.update(attrs)
        st = self._stack()
        if st and st[-1] is sp:
            st.pop()
        elif sp in st:
            st.remove(sp)
        if sp._rf is not None:
            sp._rf.__exit__(None, None, None)
            sp._rf = None
        self._ring.append(sp)

    def count(self, name: str, n: int = 1) -> None:
        if self._on:
            with self._lock:
                self._counts[name] = self._counts.get(name, 0) + n

    def watch(self, name: str, obj, attr: str) -> None:
        """Report ``obj.<attr>`` as the counter ``name`` in
        :meth:`counters`, read where it is kept (a kernel wrapper's
        launch count)."""
        self._watched[name] = (obj, attr)

    def watched(self) -> Dict[str, int]:
        """The watched attributes as they are now."""
        return {n: getattr(o, a) for n, (o, a) in self._watched.items()}

    def add_watched(self, rises: Dict[str, int], times: int = 1) -> None:
        """Add ``times`` x ``rises[name]`` to each watched attribute named
        there: the launches a replayed CUDA graph ran, which no wrapper
        counted (``models/graphed.py``)."""
        for name, n in rises.items():
            obj, attr = self._watched[name]
            setattr(obj, attr, getattr(obj, attr) + times * n)

    def counters(self) -> Dict[str, int]:
        """One snapshot of every counter, the watched attributes
        included."""
        with self._lock:
            snap = dict(self._counts)
        snap.update(self.watched())
        return snap

    def spans(self, name: Optional[str] = None, after: int = 0
              ) -> List[Span]:
        """The finished spans in the ring, in the order they ended: those
        named ``name`` (every name if None) begun after the
        :meth:`mark` ``after``."""
        return [s for s in list(self._ring)
                if s.id > after and (name is None or s.name == name)]

    def mark(self) -> int:
        """A number below the id of every span begun after this call
        (for :meth:`spans`' ``after``)."""
        return next(self._ids)


_TRACER = Tracer()
enable = _TRACER.enable
span = _TRACER.span
begin = _TRACER.begin
end = _TRACER.end
count = _TRACER.count
watch = _TRACER.watch
watched = _TRACER.watched
add_watched = _TRACER.add_watched
counters = _TRACER.counters
spans = _TRACER.spans
mark = _TRACER.mark
