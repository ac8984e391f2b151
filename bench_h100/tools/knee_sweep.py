"""Find the serving cell's knee: the highest offered rate that one
server sustains with at least 99% of the requests answered and no
backlog that grows over the window.  One server (set up once) takes
windows of rising rates in turn; each prints one JSON line (and appends
it to ``chiprun_out/knee_sweep.jsonl`` under the checkout).

    python3 bench_h100/tools/knee_sweep.py --workload unet-serve-ddim50 \
        --seed 7 --seconds 20 --rates 4,5,6,7,8,9,10,12
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(CHECKOUT))

from bench_h100 import harness  # noqa: E402


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--rates", required=True)
    args = p.parse_args(argv)
    cell = harness.Cell(args.workload)
    drv = cell.driver()
    tr = cell.workload["traffic"]
    served = drv.Served(cell, args.seed, "cuda")
    out_dir = CHECKOUT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    print(f"card: {harness.card_description()}", flush=True)
    for k, rate in enumerate(float(r) for r in args.rates.split(",")):
        reqs = served.requests(args.seed + 1000 * (k + 1), rate,
                               args.seconds, tr["views"])
        loop = drv.OpenLoop(reqs)
        before = len(served.service.batch_log)
        start = time.monotonic() + 0.2
        loop.go(start, served.port, args.seconds, float(tr["drain_s"]))
        recs = loop.records()
        close = start + args.seconds
        lat, in_window, failed = drv.latencies(recs, close)
        q = len(recs) // 4
        first = [x for x in lat[:q]]
        last = [x for x in lat[-q:]]
        log = list(served.service.batch_log)[before:]
        row = {"rate": rate, "requests": len(recs),
               "answered_share": 1 - failed / len(recs),
               "views_per_s": in_window / args.seconds,
               "p50_ms": harness.percentile(lat, 50),
               "p95_ms": harness.percentile(lat, 95),
               "first_quarter_median_ms": statistics.median(first),
               "last_quarter_median_ms": statistics.median(last),
               "batches": len(log),
               "mean_fill": (sum(n for _, _, n, _ in log) / len(log)
                             if log else None),
               "median_batch_ms": (statistics.median(s for *_, s in log)
                                   * 1e3 if log else None)}
        line = json.dumps(row)
        print(line, flush=True)
        with open(out_dir / "knee_sweep.jsonl", "a") as f:
            f.write(line + "\n")
    served.close()


if __name__ == "__main__":
    main()
