"""The serving readers count the work of the batches run wholly inside
the profiled stretch: a batch's device ops run from its host range's
start to the copy back that follows it, forwards are batches x steps,
and the K1 roofline's bytes follow the rows the kernel ran (batch size x
view slots, padded or not), not the real views or the number of K1
launches."""

import importlib.util
from pathlib import Path

import pytest

from bench_h100 import trace
from bench_h100.work import h100, kernels
from bench_h100.work import unet as work

METRICS = Path(__file__).resolve().parent.parent / "metrics"
TINY = {"image_size": 8, "in_channel": 6, "out_channel": 6,
        "inner_channel": 8, "res_blocks": 1, "attn_res": [4],
        "channel_mults": [1, 2]}


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "reader_" + name.replace(".", "_"), METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_ops_until_copy_back():
    device = [("gn_fwd", 1.0, 1.1), ("Memcpy DtoH", 1.5, 1.6),
              ("conv", 2.0, 2.2), ("Memcpy DtoH", 2.25, 2.3),
              ("gn_fwd", 2.4, 2.5), ("Memcpy DtoH", 2.9, 3.0),
              ("gn_fwd", 3.1, 3.2)]
    got = trace.ops_until_copy_back(device, [(0.9, 2.5), (3.05, 3.3)])
    # the copy inside the first range is not the one that follows it
    assert got[0] == device[:6]
    assert got[1] is None       # no copy back traced after it


def _record(real_views, k1_s_per_batch, steps=2, launches=3):
    sites = work.groupnorm_sites(TINY)
    batches = []
    for k, (v, s) in enumerate(zip(real_views, k1_s_per_batch)):
        t = 10.0 * k
        ops = [("gn_fwd_kernel", t + i * s / launches,
                t + (i + 1) * s / launches) for i in range(launches)]
        ops.append(("Memcpy DtoH", t + 5.0, t + 6.0))
        batches.append({"index": k, "real_views": v, "ops": ops})
    return sites, {"kind": "serve", "denoiser": "unet", "widths": TINY,
                   "steps": steps, "dtype": "bfloat16", "batch_size": 4,
                   "n_max": 3,
                   "profiled_batches": batches,
                   "unprofiled_batch_s": [40.0]}


def test_k1_roofline_follows_real_rows_not_launches():
    read = _reader("k1.roofline_pct.serve")
    sites, rec = _record([5, 11], [2e-3, 3e-3])
    # both batches ran 4 x 3 = 12 rows a forward, whatever their views
    want = 2 * sum(n * h100.bound_s(kernels.groupnorm_fwd_bytes(12, L, C),
                                    0.0, "bfloat16")
                   for (L, C, _), n in sites.items())
    want = 100.0 * want * rec["steps"] / 5e-3
    assert read(rec) == pytest.approx(want, rel=1e-12)
    # the same work in other launches, or at other real views, reads the
    # same
    _, rec7 = _record([5, 11], [2e-3, 3e-3], launches=7)
    assert read(rec7) == pytest.approx(want, rel=1e-12)
    _, rec_views = _record([1, None], [2e-3, 3e-3])
    assert read(rec_views) == pytest.approx(want, rel=1e-12)
    # no K1 traced in the batches gives nothing to read
    _, rec_none = _record([5, 11], [0.0, 0.0])
    assert read(rec_none) is None


def test_forwards_are_batches_times_steps():
    fwd = _reader("unet.device_ms_per_fwd.serve")
    idle = _reader("device.idle_pct.serve")
    _, rec = _record([5, 11], [2e-3, 3e-3], steps=4)
    busy = 2 * 1.0 + 2e-3 + 3e-3      # each batch's copy back and K1
    assert fwd(rec) == pytest.approx(busy / 8 * 1e3, rel=1e-12)
    assert idle(rec) == pytest.approx(
        100.0 * (1 - (busy / 8) / (40.0 / 4)), rel=1e-12)
    rec["profiled_batches"] = []
    assert fwd(rec) is None and idle(rec) is None


def test_profiled_moves_host_times_onto_the_trace(monkeypatch):
    """A range timed on ``time.perf_counter`` lands, through the clock
    marks, on the trace's clock around the ops run inside it."""
    import time

    import torch

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    p = trace.Profiled()
    p.start()
    x = torch.randn(64, 64)
    a = time.perf_counter()
    for _ in range(20):
        x = torch.mm(x, x)
        x = x / x.norm()
    b = time.perf_counter()
    p.stop()
    assert p.offset_s is not None
    mm = [s for s in p.host if s[0] == "aten::mm"]
    assert len(mm) == 20
    slack = 2e-3
    assert p.to_trace(a) - slack <= mm[0][1]
    assert mm[-1][2] <= p.to_trace(b) + slack
    assert p.host_t0 <= a and b <= p.host_t1
