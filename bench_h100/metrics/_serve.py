"""What the serving readers share: the batches run wholly inside the
profiled stretch, each with its device ops and its real views (the
views of the requests in it, never the padded slots)."""

from __future__ import annotations

from bench_h100.trace import busy_s, kernel_s
from bench_h100.work import h100


def batches(record):
    """The profiled batches of a traced UNet serving run, or []."""
    if record.get("kind") != "serve" or record.get("denoiser") != "unet":
        return []
    return record.get("profiled_batches") or []


def busy_per_forward_s(record):
    """Device-busy seconds per UNet forward over the profiled batches
    (the union of each batch's device intervals), or None."""
    bs = batches(record)
    if not bs:
        return None
    return sum(busy_s(b["ops"]) for b in bs) / (len(bs) * record["steps"])


def roofline_pct(record, names, bound_per_forward_s):
    """100 x the bound time of the profiled batches' forwards at their
    real rows (``bound_per_forward_s(rows)``) over the traced time of
    the kernels ``names`` in them; None where there is nothing to read
    (no batch, no real views, or no such kernel)."""
    bs = batches(record)
    if not bs or any(b["real_views"] is None for b in bs):
        return None
    seconds = sum(kernel_s(b["ops"], names)[0] for b in bs)
    if seconds <= 0:
        return None
    bound = sum(bound_per_forward_s(b["real_views"]) for b in bs)
    return 100.0 * bound * record["steps"] / seconds


def site_bound_s(sites, bytes_of, flops_of, dtype):
    """``rows -> bound seconds of one forward`` over ``sites`` (a
    Counter of shape -> count)."""
    return lambda rows: sum(
        n * h100.bound_s(bytes_of(rows, *shape), flops_of(rows, *shape),
                         dtype) for shape, n in sites.items())
