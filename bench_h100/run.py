"""Run one cell of the benchmark of ``viewfusion_tpu_torch`` on this
machine's H100s and print its result as the last line of standard output.

    python3 bench_h100/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics (``BENCHMARK.json`` says
which), each run with its check of ``correct`` against the plain
reference; the numbers compared, each beside its limit, are the last
lines of standard error and the ``checks`` of the result.  The run exits
with another code than 0, and prints no result, where it finds no CUDA
device or fewer than the cell asks for, where the program cannot be
imported, or where JAX or the JAX package was loaded."""

from __future__ import annotations

import time

T0 = time.monotonic()  # set-up is timed from the process's start

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

from bench_h100 import harness  # noqa: E402


def _fail(msg: str, code: int = 2):
    print(f"bench_h100: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(code)


def _cache_dirs() -> None:
    """Kernel caches at fixed paths inside the checkout; the program's own
    library lives in ``viewfusion_tpu_torch/_build/``."""
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(CHECKOUT / ".bench_cache" / "triton"))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--result", default=None,
                   help="(a rank of a multi-card cell) where rank 0 writes "
                        "the result line")
    return p.parse_args(argv)


def launch_ranks(argv, chips: int) -> dict:
    """Start one process per card with torchrun; rank 0 hands the result
    line back through a file in a fresh directory under TMPDIR."""
    import subprocess
    import tempfile

    with tempfile.TemporaryDirectory(prefix="bench_h100-") as tmp:
        result = Path(tmp) / "result.json"
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", str(chips), str(Path(__file__).resolve()),
               *argv, "--result", str(result)]
        env = dict(os.environ, BENCH_H100_T0=repr(T0))
        rc = subprocess.run(cmd, env=env).returncode
        if rc != 0 or not result.is_file():
            _fail(f"the ranks ended with code {rc} and no result")
        return json.loads(result.read_text())


def result_line(cell, outcome, trace: int, manifest: dict, chips: int,
                kind: str) -> dict:
    e2e, per_layer = harness.manifest_metrics(manifest, cell.name)
    metrics = {}
    if trace:
        for m in per_layer:
            value = cell.metric(m["name"]).read(outcome.record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in e2e:
            if m["name"] in outcome.end_to_end:
                metrics[m["name"]] = {"value": outcome.end_to_end[m["name"]],
                                      "unit": m["unit"]}
    device = {"platform": "gpu", "kind": kind, "count": chips,
              "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    if trace:
        device["busy_s"] = outcome.busy_s
        device["window_s"] = outcome.window_s
    line = {"correct": bool(outcome.correct), "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics, "device": device}
    if trace and outcome.breakdown:
        line["breakdown"] = outcome.breakdown
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, value, limit in outcome.checks}
    return line


def main(argv=None, root: Path = harness.HERE, device: str = "cuda",
         t0: float = T0) -> dict:
    """Run the cell; ``device="cpu"`` (tests only) skips the look for a
    card and runs the program's plain kernel versions.  Returns the
    result line after printing it."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse(argv)
    _cache_dirs()
    rank = int(os.environ.get("RANK", "0"))
    if "BENCH_H100_T0" in os.environ:
        t0 = float(os.environ["BENCH_H100_T0"])
    cell = harness.Cell(args.workload, root)
    try:                        # the model family's files, before any weights
        cell.reference(), cell.work()
    except FileNotFoundError as e:
        _fail(str(e))
    chips = int(cell.workload["chips"])
    manifest_path = root.parent / "BENCHMARK.json"
    manifest = harness.load_json(manifest_path) \
        if manifest_path.is_file() else {}
    import torch

    if device == "cuda":
        if not torch.cuda.is_available():
            _fail("no CUDA device")
        if torch.cuda.device_count() < chips:
            _fail(f"the cell asks for {chips} CUDA devices, "
                  f"{torch.cuda.device_count()} found")
        if chips > 1 and "WORLD_SIZE" not in os.environ:
            return _print(launch_ranks(argv, chips), [])
        kind = torch.cuda.get_device_name(
            int(os.environ.get("LOCAL_RANK", "0")))
        if rank == 0:
            print(f"card: {harness.card_description()}", file=sys.stderr)
    else:
        kind = "cpu"
    try:
        import viewfusion_tpu_torch  # noqa: F401
    except ImportError as e:
        _fail(f"the program is not importable here: {e}")
    outcome = cell.driver().run(cell=cell, seed=args.seed,
                                seconds=args.seconds, trace=args.trace,
                                device=device, t0=t0)
    if outcome is None:         # a rank other than 0 of a multi-card cell
        return None
    line = result_line(cell, outcome, args.trace, manifest, chips, kind)
    if args.result:
        found = harness.forbidden_modules()
        if found:
            _fail("JAX or the JAX package was loaded: " + ", ".join(found))
        Path(args.result).write_text(json.dumps(line))
        for note in outcome.notes:
            print(note, file=sys.stderr)
        return line
    return _print(line, outcome.notes)


def _print(line: dict, notes) -> dict:
    """The checks as the last lines of standard error, the result as the
    last line of standard output, once no JAX module is loaded."""
    found = harness.forbidden_modules()
    if found:
        _fail("JAX or the JAX package was loaded: " + ", ".join(found))
    for note in notes:
        print(note, file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
