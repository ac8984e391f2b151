"""K2 (``gn_bwd``) against its roofline at the step's rows: the bytes
every GroupNorm site's backward needs at this rank's packed rows
(``work/unet.py``), over 3.35 TB/s, times the steps profiled, against
K2's traced time in them."""

from bench_h100.metrics._common import roofline_pct
from bench_h100.work import h100
from bench_h100.work import unet as work


def read(record):
    if record.get("kind") != "train" or record.get("denoiser") != "unet":
        return None
    if "rank_rows" not in record:
        return None
    sites = work.groupnorm_sites(record["widths"])
    rows = record["rank_rows"]
    bound = sum(n * h100.bound_s(work.groupnorm_bwd_bytes(rows, L, C), 0.0,
                                 record["dtype"])
                for (L, C, _), n in sites.items())
    return roofline_pct(record, ("gn_bwd",), bound * record["profile_steps"])
