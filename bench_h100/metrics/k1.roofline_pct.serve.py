"""K1 (``gn_fwd``) against its roofline in the batches served inside the
profiled stretch: the bytes every GroupNorm site of a forward needs at
the batch's real views (the padded slots need none; ``work/unet.py``),
over 3.35 TB/s, against K1's traced time in those batches."""

from bench_h100.metrics import _serve
from bench_h100.work import unet as work


def read(record):
    if not _serve.batches(record):
        return None
    sites = work.groupnorm_sites(record["widths"])
    bound = _serve.site_bound_s(
        sites, lambda rows, L, C, _act: work.groupnorm_fwd_bytes(rows, L, C),
        lambda rows, *_: 0.0, record["dtype"])
    return _serve.roofline_pct(record, ("gn_fwd",), bound)
