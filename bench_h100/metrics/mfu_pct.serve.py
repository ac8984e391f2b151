"""The whole served step's share of the bf16 peak: real views (never the
padded slots) x steps x the denoiser's analytic forward FLOPs per row
(``flops_per_row`` of the record's family, ``work/<denoiser>.py``), over
the ``batch_log`` seconds of the same batches, over 989 TFLOP/s; in a
traced run the batches that ended before the profiler started."""

from bench_h100.metrics._common import PEAK_BF16, work


def read(record):
    if record.get("kind") != "serve":
        return None
    log, views = record.get("batch_log"), record.get("real_views")
    if not log or not views or len(views) != len(log):
        return None
    n = record.get("unprofiled_batches")   # the profiler slows the rest
    log, views = log[:n], views[:n]
    if not log:
        return None
    seconds = sum(s for (_, _, _, s) in log)
    flops = sum(views) * record["steps"] * work(
        record, __file__).flops_per_row(record["widths"])
    return 100.0 * flops / seconds / PEAK_BF16
