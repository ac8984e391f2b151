"""K5 (``attn_bwd*``, the fused attention backward for heads of 64)
against its roofline in the training step.  Per attention site of the
record's family (``work/<denoiser>.py`` ``attention_sites``), one call on
(rank rows x heads, S, head width): the larger of its bytes over 3.35 TB/s
(q, k, v, dq, dk and dv in the compute dtype, the upstream gradient g in
f32, each moved once) and its FLOPs over the bf16 peak (the four products
q k^T, g v^T, dS k and dS^T q, 2 x S^2 x C each a row: neither the
recomputed scores nor the split-term products count), times the steps
profiled, against the traced time of the ``attn_bwd`` kernels in them.
None where no ``attn_bwd`` kernel ran (a family without heads of 64, a
program without K5)."""

from bench_h100.metrics import _common
from bench_h100.work import h100

_ACT_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def bound_s(sites, rows: int, dtype: str) -> float:
    """K5's least time over ``sites`` ((S, head width, heads) counts) at
    ``rows`` samples."""
    act = _ACT_BYTES[dtype]
    total = 0.0
    for (s, hd, heads), n in sites.items():
        calls = rows * heads
        nbytes = calls * s * hd * (6 * act + 4)
        flops = calls * 8.0 * s * s * hd
        total += n * max(nbytes / h100.HBM_BYTES_PER_S,
                         flops / h100.PEAK_FLOPS["bfloat16"])
    return total


def read(record):
    if record.get("kind") != "train" or "rank_rows" not in record:
        return None
    sites = getattr(_common.work(record, __file__), "attention_sites", None)
    if sites is None:
        return None
    bound = bound_s(sites(record["widths"]), record["rank_rows"],
                    record["dtype"])
    return _common.roofline_pct(record, ("attn_bwd",),
                                bound * record["profile_steps"])
