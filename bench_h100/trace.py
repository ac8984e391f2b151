"""The device trace of a profiled stretch, reduced in memory.

``Profiled`` runs ``torch.profiler`` (CPU and CUDA activities) between
``start()`` and ``stop()`` and keeps, from its events, the device
operations (kernels, copies, sets) as (name, start, end) in seconds, the
host's operations as (name, start, end) and the host ranges marked with
``torch.profiler.record_function`` as (name, start, end).  Nothing is
written to disk.  Busy time is the union of the device intervals, so
overlapping streams count once.  ``families`` names kernels as
``chip_smoke.py:report_profile`` does (a frozen copy of its classifier,
repo commit f80e7a7, with NCCL apart)."""

from __future__ import annotations

import bisect
import time
from collections import Counter


def family(name: str) -> str:
    low = name.lower()
    if "nccl" in low:
        return "nccl"
    if "gn_bwd" in low:
        return "K2 groupnorm bwd"
    if "gn_" in low:
        return "K1 groupnorm"
    if "attn_fwd" in low:
        return "K3 attention"
    if any(w in low for w in ("conv", "gemm", "xmma", "cutlass", "cudnn",
                              "sm90", "nvjet")):
        if any(t in low for t in ("sgemm", "f32f32", "ffma")):
            return "conv/gemm f32"
        return "conv/gemm"
    if any(w in low for w in ("multi_tensor", "foreach", "adam")):
        return "optimizer"
    return "other"


class Profiled:
    """A profiled stretch.  After ``stop()``: ``device``, ``host`` and
    ``marks`` (the host ranges marked with ``record_function``) lists of
    (name, start_s, end_s) on the trace's clock, ``window_s`` its wall
    length, ``host_t0`` and ``host_t1`` its ends on ``time.perf_counter``,
    and ``to_trace`` from that clock to the trace's.

    The profiler records only the ranges of the thread that starts it, so
    a range of another thread is kept on ``time.perf_counter`` and moved
    onto the trace's clock by ``to_trace``: the offset between the two
    clocks is read from a mark this thread makes at either end."""

    CLOCK = "bench_h100.clock"

    def __init__(self):
        self.device, self.host, self.marks = [], [], []
        self.window_s = 0.0
        self.host_t0 = self.host_t1 = None
        self.offset_s = None
        self._prof = None
        self._clocks = []

    def _clock(self) -> float:
        from torch.profiler import record_function

        a = time.perf_counter()
        with record_function(self.CLOCK):
            pass
        b = time.perf_counter()
        self._clocks.append((a + b) / 2)
        return b

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.host_t0 = self._clock()

    def stop(self) -> None:
        import torch
        from torch.autograd import DeviceType

        torch.cuda.synchronize()
        self.host_t1 = self._clock()
        self.window_s = self.host_t1 - self.host_t0
        self._prof.__exit__(None, None, None)
        for e in self._prof.events():
            span = (e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
            if getattr(e, "is_user_annotation", False) or \
                    e.name.startswith("Optimizer."):
                if e.device_type == DeviceType.CPU:
                    self.marks.append(span)
                continue
            if e.device_type == DeviceType.CUDA:
                self.device.append(span)
            elif e.device_type == DeviceType.CPU:
                self.host.append(span)
        self.device.sort(key=lambda s: s[1])
        self.marks.sort(key=lambda s: s[1])
        clocks = [(a + b) / 2 for n, a, b in self.marks if n == self.CLOCK]
        if len(clocks) == len(self._clocks):
            gaps = sorted(t - h for t, h in zip(clocks, self._clocks))
            self.offset_s = gaps[len(gaps) // 2]
        self._prof = None

    def to_trace(self, t: float):
        """A ``time.perf_counter`` reading on the trace's clock, or None
        where the clock marks were not traced."""
        return None if self.offset_s is None else t + self.offset_s


def busy_intervals(spans):
    """The union of (start, end) intervals, merged, in order."""
    merged = []
    for _, a, b in sorted(spans, key=lambda s: s[1]):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1] = b
        else:
            merged.append([a, b])
    return merged


def busy_s(spans) -> float:
    return sum(b - a for a, b in busy_intervals(spans))


def ops_until_copy_back(device, ranges, copy="DtoH"):
    """For each host range (start, end), in the order given, the device
    spans that started inside it or after it up to the first copy to the
    host (a device span whose name holds ``copy``) that started after its
    end, that copy included: the device work of a call whose result the
    host reads back next.  None where that copy is not in ``device``."""
    starts = [s[1] for s in device]
    out = []
    for a, b in ranges:
        i = bisect.bisect_left(starts, a)
        j = i
        while j < len(device) and not (device[j][1] >= b
                                       and copy in device[j][0]):
            j += 1
        out.append(list(device[i:j + 1]) if j < len(device) else None)
    return out


def kernel_s(spans, names) -> tuple:
    """(seconds, count) of the device spans whose name contains one of
    ``names``."""
    picked = [b - a for n, a, b in spans if any(k in n for k in names)]
    return sum(picked), len(picked)


def device_ops(spans, top: int = 10):
    """[[family, seconds]] of the device time by kernel family."""
    fam = Counter()
    for n, a, b in spans:
        fam[family(n)] += b - a
    return [[k, v] for k, v in fam.most_common(top)]


def idle_gaps(device, host, top: int = 10, min_gap_s: float = 2e-6):
    """[[label, seconds]]: the device's idle gaps summed by what the host
    was doing in them (the host operation that started last before the
    gap's middle), the largest first."""
    merged = busy_intervals(device)
    starts = sorted(host, key=lambda s: s[1])
    host_starts = [s[1] for s in starts]
    by = Counter()
    for (_, a_end), (b_start, _) in zip(merged, merged[1:]):
        gap = b_start - a_end
        if gap < min_gap_s:
            continue
        i = bisect.bisect_right(host_starts, (a_end + b_start) / 2) - 1
        label = starts[i][0][:80] if i >= 0 else "no host operation recorded"
        by["host in " + label] += gap
    return [[k, v] for k, v in by.most_common(top)]
