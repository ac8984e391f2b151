"""K3 (``attn_fwd*``) against its roofline in the batches served inside
the profiled stretch: the larger of bytes over 3.35 TB/s and FLOPs over
the bf16 peak, per attention site of a forward at the batch's real views
(the padded slots need none; ``work/unet.py``), against K3's traced time
in those batches."""

from bench_h100.metrics import _serve
from bench_h100.work import unet as work


def read(record):
    if not _serve.batches(record):
        return None
    bound = _serve.site_bound_s(work.attention_sites(record["widths"]),
                                work.attention_bytes, work.attention_flops,
                                record["dtype"])
    return _serve.roofline_pct(record, ("attn_fwd",), bound)
