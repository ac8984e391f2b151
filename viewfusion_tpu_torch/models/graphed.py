"""The denoiser's forward replayed as a CUDA graph.

One forward of the paper UNet at the served 48 rows is ~300 kernel
launches that the host issues one by one, through Python, in about
twice the time the card takes to run them.  :class:`GraphedForward`
issues such a forward as one replay of a captured
``torch.cuda.CUDAGraph`` instead: the same hand-written kernels and
cuDNN convolutions, in the same order, on the same data, so the result
is bit for bit the eager one.

Whether a call is graphed depends only on what the call shows: the
input is on a CUDA device, autograd is off (``no_grad`` or
``inference_mode``), no dropout is asked for and no denoiser override
is given (the train step's DDP and view-split wrappers).  Otherwise the
denoiser runs eagerly and the call counts as ``unet.graph_bypassed``.

A graph is keyed on the inputs' shapes and dtypes, their device,
whether inference mode is on, and the storage of the denoiser's
parameters and buffers (their data pointers).  An in-place update
(``load_state_dict``, the optimizer, the EMA) is read by the next
replay; a parameter given new storage (a new tensor, or ``.data``
replaced) makes a new key.  A key runs eagerly on its first call; on
its second it runs eagerly on a side stream (the warm-up, whose output
is that call's result) and is then captured; from its third on it is
replayed: the inputs are copied into the graph's own, the graph is
replayed and its output cloned, so no caller holds a buffer the next
replay overwrites.  At most ``MAX_GRAPHS`` keys are kept, the least
recently used dropped first.  All of a runner's graphs on a device
share one memory pool, so replays must not overlap: they are issued one
at a time, on the caller's current stream.

Two things keep a replay from hanging the process while a profiler is
started or stopped from another thread (the harness's main thread,
while the server's worker samples).  The graph is launched by
``cuGraphLaunch`` from ``libcuda`` called through ``ctypes.PyDLL``, which
holds the GIL, as ``torch.profiler``'s start and stop do: with
``CUDAGraph.replay``, whose launch runs without the GIL, graph launches
on one thread and the profiler's stop on another hung the process now
and then on the H100 (torch 2.11, CUDA 12.8).  And the host issues at most
``IN_FLIGHT`` replays ahead of the card: before each it waits, on a
CUDA event and without the GIL, for the replay issued ``IN_FLIGHT``
before it, so a launch never blocks on a full command buffer while it
holds the GIL.  The captured forward draws no random numbers (dropout
runs eagerly), so the launch needs none of the generator bookkeeping
that ``CUDAGraph.replay`` does.

The kernel wrappers count their launches in Python (``tracing.watch``),
which a replay does not run.  The rise of each watched counter during a
capture is taken back (a capture runs nothing) and added again on every
replay, so the counters keep counting the kernels run.  Counters:
``unet.graph_captures``, ``unet.graph_replays``, ``unet.graph_bypassed``.
"""

from __future__ import annotations

import ctypes
import threading
from collections import OrderedDict, deque
from typing import Dict, Optional, Tuple

import torch

from viewfusion_tpu_torch import tracing

__all__ = ["GraphedForward", "MAX_GRAPHS", "IN_FLIGHT"]

MAX_GRAPHS = 4
"""Keys kept (graphs and shapes seen once): the server's one shape, or
an evaluation's packed row counts."""

IN_FLIGHT = 2
"""Replays the host may issue ahead of the card: two forwards queued
keep it busy while the host issues the next sampler step, and far fewer
launches than fill the card's command buffer."""


_launch = None


def _graph_launch():
    """``cuGraphLaunch(exec, stream)`` from ``libcuda``, called with the
    GIL held."""
    global _launch
    if _launch is None:
        fn = ctypes.PyDLL("libcuda.so.1").cuGraphLaunch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch


class _Graph:
    """One captured forward: its static inputs and output, and the
    watched counters' rise per replay."""

    __slots__ = ("graph", "exec", "device", "inputs", "output", "launches")

    def __init__(self, graph, inputs, output, launches):
        # the CUDAGraph owns the executable graph that ``exec`` names
        self.graph, self.inputs, self.output = graph, inputs, output
        self.exec = graph.raw_cuda_graph_exec()
        self.device = output.device
        self.launches = launches

    def replay(self, inputs) -> torch.Tensor:
        for static, t in zip(self.inputs, inputs):
            static.copy_(t)
        with torch.cuda.device(self.device):
            err = _graph_launch()(
                self.exec, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"cuGraphLaunch: CUresult {err}")
        tracing.add_watched(self.launches)
        tracing.count("unet.graph_replays")
        return self.output.clone()


class GraphedForward:
    """``runner(denoiser, x, angle, noise_level, dropout=, override=)``
    runs ``denoiser(x, angle, noise_level)`` and returns (its output,
    whether a graph was replayed); see the module docstring."""

    def __init__(self):
        self.entries: "OrderedDict[tuple, Optional[_Graph]]" = OrderedDict()
        self._lock = threading.Lock()
        self._capture_on: Dict[torch.device, tuple] = {}  # (stream, pool)
        self._module = None
        self._stores: list = []  # the denoiser's parameter and buffer dicts
        self._issued: "deque[torch.cuda.Event]" = deque()  # replays' ends

    @staticmethod
    def eager_reason(x: torch.Tensor, dropout=None,
                     override: bool = False) -> Optional[str]:
        """Why a call runs eagerly, or None where it is graphed."""
        if override:
            return "override"
        if dropout is not None:
            return "dropout"
        if torch.is_grad_enabled():
            return "autograd"
        if x.device.type != "cuda":
            return "device"
        return None

    def key(self, module: torch.nn.Module, inputs) -> tuple:
        """The graph's key for ``module(*inputs)`` (see the module
        docstring).  The submodules' parameter and buffer dicts are listed
        once per denoiser; what they hold is read on every call."""
        if module is not self._module:
            self._module = module
            self._stores = [d for m in module.modules()
                            for d in (m._parameters, m._buffers) if d]
        tensors = [t for d in self._stores for t in d.values()
                   if t is not None]
        return (tuple((tuple(t.shape), t.dtype) for t in inputs),
                inputs[0].device, torch.is_inference_mode_enabled(),
                tuple(map(torch.Tensor.data_ptr, tensors)))

    def remember(self, key: tuple, entry: Optional[_Graph]) -> None:
        """Keep ``entry`` under ``key`` as the most recently used, and drop
        the least recently used beyond ``MAX_GRAPHS``."""
        self.entries[key] = entry
        self.entries.move_to_end(key)
        while len(self.entries) > MAX_GRAPHS:
            self.entries.popitem(last=False)

    def __call__(self, module, x, angle, noise_level, dropout=None,
                 override: bool = False) -> Tuple[torch.Tensor, bool]:
        if self.eager_reason(x, dropout, override) is not None:
            tracing.count("unet.graph_bypassed")
            kw = {} if dropout is None else {"dropout": dropout}
            return module(x, angle, noise_level, **kw), False
        inputs = (x, angle, noise_level)
        with self._lock:
            key = self.key(module, inputs)
            if key not in self.entries:
                self.remember(key, None)
                return module(*inputs), False
            entry = self.entries[key]
            if entry is None:
                out, entry = self._capture(module, inputs)
                self.remember(key, entry)
                return out, False
            self.entries.move_to_end(key)
            if len(self._issued) >= IN_FLIGHT:
                self._issued.popleft().synchronize()
            out = entry.replay(inputs)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(x.device))
            self._issued.append(done)
            return out, True

    def _capture(self, module, inputs) -> Tuple[torch.Tensor, _Graph]:
        """The warm-up forward on the capture stream (this call's output),
        then the capture, from static copies of ``inputs``."""
        dev = inputs[0].device
        with torch.cuda.device(dev):
            if dev not in self._capture_on:
                self._capture_on[dev] = (torch.cuda.Stream(),
                                         torch.cuda.graph_pool_handle())
            stream, pool = self._capture_on[dev]
            main = torch.cuda.current_stream()
            static = tuple(t.clone(memory_format=torch.contiguous_format)
                           for t in inputs)
            stream.wait_stream(main)
            with torch.cuda.stream(stream):
                out = module(*inputs)
            main.wait_stream(stream)
            out.record_stream(main)
            before = tracing.watched()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                output = module(*static)
            launches = {n: v - before[n] for n, v in tracing.watched().items()
                        if n in before and v != before[n]}
            tracing.add_watched(launches, -1)
        tracing.count("unet.graph_captures")
        return out, _Graph(graph, static, output, launches)
