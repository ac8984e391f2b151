"""Run one cell several times, each run a process of its own as the
benchmark's command, and report each metric's spread: the distance
between the first and third quartiles (``statistics.quantiles(n=4)``)
as a share of the median, per set of runs.  Each run's result line is
appended to ``chiprun_out/<cell>.runs.jsonl``.

    python3 bench_h100/tools/spread.py --workload unet-serve-ddim50 \
        --seeds 1,2,3,4,5,6 --sets 2 --seconds 40 [--trace 1]
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]


def spread(values) -> float:
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--sets", type=int, default=1)
    p.add_argument("--seconds", type=float, default=40)
    p.add_argument("--trace", type=int, default=0)
    args = p.parse_args(argv)
    out_dir = CHECKOUT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    log = out_dir / f"{args.workload}.runs.jsonl"
    seeds = [int(s) for s in args.seeds.split(",")]
    sets = []
    for k in range(args.sets):
        lines = []
        for seed in seeds:
            t = time.monotonic()
            proc = subprocess.run(
                [sys.executable, "bench_h100/run.py", "--workload",
                 args.workload, "--seed", str(seed), "--seconds",
                 str(args.seconds), "--trace", str(args.trace)],
                cwd=CHECKOUT, capture_output=True, text=True)
            last = proc.stdout.strip().splitlines()[-1:] or [""]
            try:
                line = json.loads(last[0])
            except ValueError:
                line = None
            rec = {"set": k, "seed": seed, "rc": proc.returncode,
                   "wall_s": time.monotonic() - t, "line": line}
            if line is None:
                rec["stderr"] = proc.stderr[-3000:]
            else:
                print(proc.stderr.strip().splitlines()[-6:], flush=True)
            with open(log, "a") as f:
                f.write(json.dumps(rec) + "\n")
            print(json.dumps(rec), flush=True)
            lines.append(line)
        sets.append(lines)
    for k, lines in enumerate(sets):
        ok = [x for x in lines if x]
        names = sorted({m for x in ok for m in x["metrics"]})
        summary = {"set": k, "correct": [x["correct"] for x in ok]}
        for m in names:
            vals = [x["metrics"][m]["value"] for x in ok
                    if m in x["metrics"]]
            if len(vals) >= 2:
                summary[m] = {"median": statistics.median(vals),
                              "spread": spread(vals) if len(vals) >= 3
                              else None, "values": vals}
        print("SUMMARY " + json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
