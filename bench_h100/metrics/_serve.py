"""What the serving readers share: the batches run wholly inside the
profiled stretch, each with its device ops."""

from __future__ import annotations

from bench_h100.trace import busy_s, kernel_s


def batches(record):
    """The profiled batches of a traced serving run, or []."""
    if record.get("kind") != "serve":
        return []
    return record.get("profiled_batches") or []


def busy_per_forward_s(record):
    """Device-busy seconds per denoiser forward over the profiled batches
    (the union of each batch's device intervals), or None."""
    bs = batches(record)
    if not bs:
        return None
    return sum(busy_s(b["ops"]) for b in bs) / (len(bs) * record["steps"])


def roofline_pct(record, names, bound_per_forward_s):
    """100 x the bound time of the profiled batches' forwards at the rows
    the kernels ran (``bound_per_forward_s(rows)``; every forward runs
    all ``batch_size`` x ``n_max`` view slots, padded or not) over the
    traced time of the kernels ``names`` in them; None where there is
    nothing to read (no batch, or no such kernel)."""
    bs = batches(record)
    if not bs:
        return None
    seconds = sum(kernel_s(b["ops"], names)[0] for b in bs)
    if seconds <= 0:
        return None
    rows = record["batch_size"] * record["n_max"]
    return (100.0 * bound_per_forward_s(rows) * len(bs) * record["steps"]
            / seconds)
