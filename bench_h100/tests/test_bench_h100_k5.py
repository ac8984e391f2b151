"""The reader ``k5.roofline_pct.train`` (K5, the program's fused
attention backward for heads of 64) on fixed ADM and UNet records."""

import pytest

from bench_h100 import harness
from bench_h100.tests import _tiny

ADM = harness.load_json(_tiny.BENCH / "configs" / "adm-imagenet-64.json")
WIDTHS = ADM["widths"]


def _reader():
    return harness._module(_tiny.BENCH / "metrics" / "k5.roofline_pct.train.py",
                           "k5_reader").read


def _record(ops):
    """A traced ADM training record: 112 rows, 5 steps profiled."""
    return {"kind": "train", "denoiser": "adm", "widths": WIDTHS,
            "rows": 112, "rank_rows": 112, "chips": 1, "dtype": "bfloat16",
            "profile_steps": 5, "window_steps": 3, "device_ops": ops,
            "busy_s": 0.3}


def test_k5_training_roofline_on_a_fixed_record():
    """The bound of the ADM's 22 sites at 112 rows (7 at S = 1024 in 6
    heads, 7 at 256 in 9, 8 at 64 in 12: 2.79 TFLOP of the four products,
    3.32 ms a step) against the ``attn_bwd`` kernels' traced time; None
    without them and outside training."""
    ops = [(f"attn_bwd_{p}(CUtensorMap_st)", 0.1 * i + 0.01 * j,
            0.1 * i + 0.01 * j + 0.004)
           for i in range(5) for j, p in enumerate(("rows", "kv", "q"))]
    ops.append(("attn_fwd_wgmma<1>", 0.05, 0.06))
    read = _reader()
    sites = harness.family_module("work", "adm").attention_sites(WIDTHS)
    assert sites == {(1024, 64, 6): 7, (256, 64, 9): 7, (64, 64, 12): 8}
    flops = sum(n * 112 * heads * 8.0 * s * s * hd
                for (s, hd, heads), n in sites.items())
    assert flops == pytest.approx(2.79e12, rel=2e-3)
    bound = sum(n * max(112 * heads * s * hd * 16 / 3.35e12,
                        112 * heads * 8.0 * s * s * hd / 989e12)
                for (s, hd, heads), n in sites.items())
    assert bound == pytest.approx(3.316e-3, rel=1e-3)
    got = read(_record(ops))
    assert got == pytest.approx(100.0 * 5 * bound / (15 * 0.004), rel=1e-12)
    assert read(_record([("attn_fwd_wgmma<1>", 0.0, 0.1)])) is None
    assert read(dict(_record(ops), kind="serve")) is None


def test_k5_roofline_reads_none_without_rank_rows():
    """A record without the profiled rows (an untraced run) reads None."""
    record = _record([("attn_bwd_kv(CUtensorMap_st)", 0.0, 0.001)])
    assert _reader()(record) is not None
    del record["rank_rows"]
    assert _reader()(record) is None
