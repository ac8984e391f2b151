"""K1 (``gn_fwd``) against its roofline in the batches served inside the
profiled stretch: the bytes every GroupNorm site of a forward needs at
the rows the kernel ran (batch size x view slots, the padded slots
included; the sites from the record's family, ``work/<denoiser>.py``,
the bytes from ``work/kernels.py``), over 3.35 TB/s, against K1's traced
time in those batches.  None for a family without GroupNorm sites."""

from bench_h100.metrics import _common, _serve
from bench_h100.work import kernels


def read(record):
    if not _serve.batches(record):
        return None
    sites = getattr(_common.work(record, __file__), "groupnorm_sites", None)
    if sites is None:
        return None
    return _serve.roofline_pct(
        record, ("gn_fwd",), lambda rows: kernels.groupnorm_bound_s(
            sites(record["widths"]), rows, record["dtype"]))
