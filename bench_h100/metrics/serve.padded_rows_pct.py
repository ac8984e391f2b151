"""The share of the UNet rows a served batch runs that are padding:
100 x (rows run - real views) / rows run, summed over the batches that
ended before the profiled stretch began (the ``serve.batch`` span's
``rows``, batch size x view slots, and ``views``, its requests' views)."""

from bench_h100.metrics import _spans


def read(record):
    n = _spans.unprofiled_batches(record)
    if n is None:
        return None
    batches = _spans.in_batches(_spans.program_spans(), "serve.batch", n)
    rows = sum(s.attrs["rows"] for s in batches)
    if not rows:
        return None
    return 100.0 * (rows - sum(s.attrs["views"] for s in batches)) / rows
