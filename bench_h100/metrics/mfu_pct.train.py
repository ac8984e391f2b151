"""The whole training step's share of the bf16 peak: 3 x the analytic
forward FLOPs per row (``flops_per_row`` of the record's family,
``work/<denoiser>.py``) x the packed rows a step x the window's steps,
over the window, over the chips, over 989 TFLOP/s."""

from bench_h100.metrics._common import PEAK_BF16, work


def read(record):
    if record.get("kind") != "train":
        return None
    flops = (3.0 * work(record, __file__).flops_per_row(record["widths"])
             * record["rows"] * record["window_steps"])
    return 100.0 * flops / record["window_elapsed_s"] / record["chips"] \
        / PEAK_BF16
