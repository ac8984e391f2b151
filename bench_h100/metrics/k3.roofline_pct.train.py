"""K3 (``attn_fwd*``) against its roofline at the DiT's sites in the
training step: per block one call on (R x heads, S, head width); the
larger of bytes over 3.35 TB/s and FLOPs over the bf16 peak, times the
steps profiled, against K3's traced time in them."""

from bench_h100.metrics._common import roofline_pct
from bench_h100.work import dit as work
from bench_h100.work import h100
from bench_h100.work import unet as work_unet


def read(record):
    if record.get("kind") != "train" or record.get("denoiser") != "dit":
        return None
    if "rank_rows" not in record:
        return None
    sites = work.attention_sites(record["widths"])
    bound = sum(n * h100.bound_s(
        work_unet.attention_bytes(record["rank_rows"] * heads, S, hd),
        work_unet.attention_flops(record["rank_rows"] * heads, S, hd),
        record["dtype"]) for (S, hd, heads), n in sites.items())
    return roofline_pct(record, ("attn_fwd",),
                        bound * record["profile_steps"])
