"""K3 (``attn_fwd*``) against its roofline in the batches served inside
the profiled stretch: the larger of bytes over 3.35 TB/s and FLOPs over
the bf16 peak, per attention site of a forward at the rows the kernel
ran (batch size x view slots, the padded slots included; the sites from
the record's family, ``work/<denoiser>.py``, the counts from
``work/kernels.py``), against K3's traced time in those batches.  None
for a family without attention sites."""

from bench_h100.metrics import _common, _serve
from bench_h100.work import kernels


def read(record):
    if not _serve.batches(record):
        return None
    sites = getattr(_common.work(record, __file__), "attention_sites", None)
    if sites is None:
        return None
    return _serve.roofline_pct(
        record, ("attn_fwd",), lambda rows: kernels.attention_bound_s(
            sites(record["widths"]), rows, record["dtype"]))
