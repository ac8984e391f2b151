"""The cost of the program's tracer, and the parent against this tree, on
the end-to-end metrics of one cell: runs of ``run.py --trace 0``, each a
process of its own, in turns: with the tracer on (the program's
default), with it off (``tracing.enable(False)`` before the run), and,
with ``--parent``, the checkout in that directory.  Prints each run's
metrics and then, per side, each metric's median and spread (the
distance between the first and third quartiles, ``statistics.quantiles``,
over the median); the lines go to ``chiprun_out/tracer_cost.jsonl``.
``--span-cost`` instead times one span's open and close on this host's
CPU, with recording on and off, and prints that.

    python3 bench_h100/tools/tracer_cost.py --workload unet-train-b80 \
        --seeds 11,12 [--parent _verify/parent] [--seconds 51]
    python3 bench_h100/tools/tracer_cost.py --span-cost
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


def child_off(argv) -> None:
    """One run with the tracer off (the run's clock starts at its
    import, as it does from the command line)."""
    sys.path.insert(0, str(CHECKOUT))
    from bench_h100 import run

    from viewfusion_tpu_torch import tracing

    tracing.enable(False)
    run.main(argv)


def span_cost(n: int = 200_000) -> dict:
    """Microseconds a ``with span(...)`` takes on this host's CPU, no
    profiler running, each the best of 3 loops of ``n``: under an open
    parent (the key inherited), and with recording off; beside them the
    same loop around an empty block."""
    sys.path.insert(0, str(CHECKOUT))
    from contextlib import nullcontext

    from viewfusion_tpu_torch import tracing

    def loop(make):
        best = float("inf")
        for _ in range(3):
            a = time.perf_counter_ns()
            for _ in range(n):
                with make():
                    pass
            best = min(best, time.perf_counter_ns() - a)
        return best / n / 1e3

    out = {"empty_block_us": loop(nullcontext)}
    for label, on in (("span_us", True), ("span_off_us", False)):
        t = tracing.Tracer()
        t.enable(on)
        with t.span("parent", key=1):
            out[label] = loop(lambda: t.span("s"))
    return out


def one(side: str, parent, argv, timeout: float):
    if side == "parent":
        cmd, cwd = [sys.executable, "bench_h100/run.py", *argv], parent
    elif side == "on":
        cmd, cwd = [sys.executable, "bench_h100/run.py", *argv], CHECKOUT
    else:
        cmd = [sys.executable, str(Path(__file__).resolve()), "--off", "--",
               *argv]
        cwd = CHECKOUT
    out = subprocess.run(cmd, cwd=str(cwd), capture_output=True, text=True,
                         timeout=timeout)
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines:
        sys.stderr.write(out.stderr[-4000:])
        return {"side": side, "rc": out.returncode}
    res = json.loads(lines[-1])
    return {"side": side, "rc": 0, "correct": res["correct"],
            "failed": res["failed"],
            "metrics": {k: v["value"] for k, v in res["metrics"].items()}}


def summary(runs) -> dict:
    out = {}
    for side in sorted({r["side"] for r in runs}):
        got = {}
        for r in runs:
            if r["side"] == side and r["rc"] == 0:
                for k, v in r["metrics"].items():
                    got.setdefault(k, []).append(v)
        out[side] = {}
        for k, vals in got.items():
            med = statistics.median(vals)
            spread = None
            if len(vals) >= 2:
                q1, _, q3 = statistics.quantiles(vals, n=4)
                spread = (q3 - q1) / med
            out[side][k] = {"median": med, "spread": spread, "runs": vals}
    return out


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:2] == ["--off", "--"]:
        return child_off(argv[2:])
    if argv == ["--span-cost"]:
        print(json.dumps(span_cost()), flush=True)
        return None
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=51)
    p.add_argument("--parent", default=None)
    p.add_argument("--timeout", type=float, default=600)
    args = p.parse_args(argv)
    sides = ["on", "off"] + (["parent"] if args.parent else [])
    log = CHECKOUT / "chiprun_out"
    log.mkdir(exist_ok=True)
    # each tree builds its kernel library once, before any run is timed
    for tree in [CHECKOUT] + ([args.parent] if args.parent else []):
        subprocess.run([sys.executable, "-c", "from viewfusion_tpu_torch "
                        "import _native; _native.library()"],
                       cwd=str(tree), check=True, timeout=args.timeout)
    runs = []
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        run_argv = ["--workload", args.workload, "--seed", str(seed),
                    "--seconds", str(args.seconds), "--trace", "0"]
        for side in (sides if i % 2 == 0 else sides[::-1]):
            r = one(side, args.parent, run_argv, args.timeout)
            r.update(seed=seed, workload=args.workload)
            runs.append(r)
            print(json.dumps(r), flush=True)
            with open(log / "tracer_cost.jsonl", "a") as f:
                f.write(json.dumps(r) + "\n")
    print(json.dumps({"workload": args.workload,
                      "summary": summary(runs)}), flush=True)


if __name__ == "__main__":
    main()
