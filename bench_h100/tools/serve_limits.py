"""The readings the serving cell's limits are set from: for each seed,
a short window at the cell's own load through the program's server,
then the same sampled requests recomputed by the float32 reference and
by the reference with every product operand rounded to fp8 e4m3 (the
control, the step below the configuration's bf16).  Prints one JSON
line per seed with the program's and the control's ``pixel_gap_max``
and ``pixel_gap_mean`` against the float32 reference, and appends it to
``chiprun_out/serve_limits.jsonl``.

    python3 bench_h100/tools/serve_limits.py --workload unet-serve-ddim50 \
        --seeds 11,12,13 --seconds 10
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

CHECKOUT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(CHECKOUT))

from bench_h100 import harness  # noqa: E402
from bench_h100.reference import diffusion, precision  # noqa: E402


def gaps(a, b):
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return float(d.max()), float(max(x.mean() for x in d))


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = harness.Cell(args.workload)
    drv = cell.driver()
    tr = cell.workload["traffic"]
    out_dir = CHECKOUT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.monotonic()
        s = drv.Served(cell, seed, args.device)
        reqs = s.requests(seed, float(tr["rate"]), args.seconds, tr["views"])
        loop = drv.OpenLoop(reqs)
        start = time.monotonic() + 0.2
        loop.go(start, s.port, args.seconds, float(tr["drain_s"]))
        recs = loop.records()
        s.close()
        answered = [i for i, r in enumerate(recs) if r["image"] is not None]
        rng = np.random.default_rng([seed, 3])
        n = min(int(tr["check_requests"]), len(answered))
        most = max(reqs[i]["count"] for i in answered)
        picked = [int(rng.choice([i for i in answered
                                  if reqs[i]["count"] == most]))]
        rest = [i for i in answered if i != picked[0]]
        picked += [int(i) for i in rng.choice(rest, n - 1, replace=False)]
        loc = drv.locate([(reqs[i]["count"], reqs[i]["angle"],
                           reqs[i]["views"]) for i in picked],
                         s.recorder.batches)
        if any(x is None for x in loc):
            raise RuntimeError("a request was not found among the batches")
        precision.no_tf32()
        sched = diffusion.Schedule(**cell.config["schedule"])
        imgs = {}
        for name in ("float32", "fp8"):
            imgs[name] = drv.reference_images(
                s.reference.forward, s.params, s.widths, sched, loc,
                s.recorder.batches, s.steps, s.size, int(tr["batch_size"]),
                args.device, precision.Precision(name))
        served = np.stack([drv._served_image(recs[i], s.size)
                           for i in picked])
        row = {"seed": seed, "requests": len(recs), "compared": len(picked)}
        for name, img in (("program", served), ("fp8", imgs["fp8"])):
            row[name] = dict(zip(("pixel_gap_max", "pixel_gap_mean"),
                                 gaps(img, imgs["float32"])))
        row["seconds"] = time.monotonic() - t
        line = json.dumps(row)
        print(line, flush=True)
        with open(out_dir / "serve_limits.jsonl", "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
