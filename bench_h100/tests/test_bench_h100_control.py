"""The control comes out as not correct: the reference put in the
program's place and computed in the precision below the configuration's
bf16 (every product operand rounded to fp8 e4m3) fails one of the cell's
limits against the float32 reference, at the cell's own size.

Every test here needs a card and is marked ``cuda``:

    python -m pytest -m cuda bench_h100/tests/test_bench_h100_control.py

(``tools/serve_limits.py`` and ``tools/train_limits.py`` read the same
numbers over many seeds.)"""

import json
import time
from pathlib import Path

import numpy as np
import pytest

from bench_h100 import harness
from bench_h100.reference import diffusion, precision

pytestmark = pytest.mark.cuda
MANIFEST = json.loads((Path(harness.__file__).resolve().parent.parent
                       / "BENCHMARK.json").read_text())
CELLS = {w["name"] for w in MANIFEST["workloads"]}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell runs at its own size")
    return "cuda"


@pytest.mark.skipif("unet-serve-ddim50" not in CELLS, reason="no such cell")
def test_serving_control_fails(card):
    cell = harness.Cell("unet-serve-ddim50")
    drv = cell.driver()
    tr = cell.workload["traffic"]
    s = drv.Served(cell, 424242, card)
    reqs = s.requests(424242, float(tr["rate"]), 6.0, tr["views"])
    loop = drv.OpenLoop(reqs)
    loop.go(time.monotonic() + 0.2, s.port, 6.0, float(tr["drain_s"]))
    recs = loop.records()
    s.close()
    picked = [i for i, r in enumerate(recs) if r["image"]][:8]
    loc = drv.locate([(reqs[i]["count"], reqs[i]["angle"], reqs[i]["views"])
                      for i in picked], s.recorder.batches)
    precision.no_tf32()
    sched = diffusion.Schedule(**cell.config["schedule"])
    ref, ctl = (drv.reference_images(
        s.reference.forward, s.params, s.widths, sched, loc,
        s.recorder.batches, s.steps, s.size, int(tr["batch_size"]), card,
        precision.Precision(p))
        for p in ("float32", "fp8"))
    d = np.abs(ctl.astype(np.int32) - ref.astype(np.int32))
    lim = cell.workload["limits"]
    assert (d.max() > lim["pixel_gap_max"]
            or max(x.mean() for x in d) > lim["pixel_gap_mean"])


@pytest.mark.parametrize("name", sorted(c for c in CELLS if "train" in c
                                        and "4gpu" not in c))
def test_training_control_fails(card, name):
    cell = harness.Cell(name)
    drv = cell.driver()
    tr = cell.workload["traffic"]
    cfg = cell.config
    mod = cell.reference()
    params = harness.make_params(mod.param_specs(cfg["widths"]),
                                 harness.sub_seed(515151, 2), card)
    batches = drv.make_batches(515151, int(tr["check_steps"]),
                               int(tr["batch"]), cfg["max_views"],
                               cfg["widths"]["image_size"])
    n, seed = int(tr["check_steps"]), harness.sub_seed(515151, 4)
    ref = drv.reference_steps(cell, params, batches, seed, n, card)
    ctl = drv.reference_steps(cell, params, batches, seed, n, card,
                              precision.Precision("fp8"))
    got = dict(zip(("loss_gap", "grad_norm_gap", "change_norm_gap"),
                   drv.gaps(ctl, ref)))
    lim = cell.workload["limits"]
    assert any(got[k] > lim[k] for k in lim), got
