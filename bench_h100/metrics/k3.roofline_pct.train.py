"""K3 (``attn_fwd*``) against its roofline in the training step: one
call on (rank rows x heads, S, head width) per attention site of the
record's family (``work/<denoiser>.py``); the larger of bytes over
3.35 TB/s and FLOPs over the bf16 peak (``work/kernels.py``), times the
steps profiled, against K3's traced time in them.  None for a family
without attention sites."""

from bench_h100.metrics import _common
from bench_h100.work import kernels


def read(record):
    if record.get("kind") != "train" or "rank_rows" not in record:
        return None
    sites = getattr(_common.work(record, __file__), "attention_sites", None)
    if sites is None:
        return None
    bound = kernels.attention_bound_s(sites(record["widths"]),
                                      record["rank_rows"], record["dtype"])
    return _common.roofline_pct(record, ("attn_fwd",),
                                bound * record["profile_steps"])
