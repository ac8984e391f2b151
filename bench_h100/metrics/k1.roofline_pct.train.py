"""K1 (``gn_fwd``) against its roofline in the training step: the bytes
every GroupNorm site's forward needs at this rank's packed rows (the
sites from the record's family, ``work/<denoiser>.py``, the bytes from
``work/kernels.py``), over 3.35 TB/s, times the steps profiled, against
K1's traced time in them.  None for a family without GroupNorm sites."""

from bench_h100.metrics import _common
from bench_h100.work import kernels


def read(record):
    if record.get("kind") != "train" or "rank_rows" not in record:
        return None
    sites = getattr(_common.work(record, __file__), "groupnorm_sites", None)
    if sites is None:
        return None
    bound = kernels.groupnorm_bound_s(sites(record["widths"]),
                                      record["rank_rows"], record["dtype"])
    return _common.roofline_pct(record, ("gn_fwd",),
                                bound * record["profile_steps"])
