"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates).

Frozen copy of ``chip_smoke.py``'s ``HBM_BYTES_PER_S`` and
``PEAK_OPS_PER_S`` (repo commit f80e7a7): 3.35 TB/s of HBM, 989 TFLOP/s
in bf16 on the tensor cores, 67 TFLOP/s in f32 outside them.  The rates
assume the card's full 700 W; every result line carries the card's name.
"""

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}


def bound_s(nbytes: float, flops: float, dtype: str) -> float:
    """The least time the card could take for the work: the larger of
    bytes over HBM bandwidth and FLOPs over the dtype's peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])
