"""The share of the device's idle time in the batches served wholly
inside the profiled stretch whose gap midpoint falls inside a UNet
forward (the program's ``unet.forward`` spans): idle while the host
issues the forward, against idle in the sampler's own steps, the copies
and the batch's edges.  The program's spans are put on the trace's
clock by the blocking copy back: each copy to the host in the trace
starts after its batch's ``serve.copy_back`` begins and ends before it
returns; the copies are paired with those spans by their spacing, and
the offset is the middle of what every pair allows
(``_spans.served_batches``; PERF.md, section 3, gives its resolution)."""

from bench_h100.metrics import _spans


def read(record):
    got = _spans.served_idle_by_span(record, _spans.program_spans())
    if got is None or got[1] <= 0:
        return None
    by, total, _ = got
    return 100.0 * by.get("unet.forward", 0.0) / total
