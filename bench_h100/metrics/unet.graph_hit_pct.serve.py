"""The share of the UNet forwards issued as a replayed CUDA graph: 100 x
the program's ``unet.forward`` spans whose ``graphed`` attribute is true
over all of them, in the batches that ended before the profiled stretch
began.  None where no forward carries the attribute (a program without
the graph runner)."""

from bench_h100.metrics import _spans


def read(record):
    n = _spans.unprofiled_batches(record)
    if n is None:
        return None
    forwards = _spans.in_batches(_spans.program_spans(), "unet.forward", n)
    if not any("graphed" in s.attrs for s in forwards):
        return None
    return 100.0 * sum(bool(s.attrs.get("graphed")) for s in forwards) \
        / len(forwards)
