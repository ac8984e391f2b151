"""Run one cell traced, as ``run.py --trace 1`` does, and report from the
same process what the span readers build on: the device's idle time in
the profiled stretch by the innermost program span over each gap's
midpoint; for serving, the copy-back brackets that put the worker's
spans on the trace's clock and how closely they agree (the metric at
either end of what they allow, and the harness's own clock offset
beside them), what happens around each batch's copy to the host by
CUPTI's runtime records, and the sampler's spans against the batch
time.  In
training the program's spans are profiler ranges of the thread that
runs the profiler, so they are on the trace's clock already.

    python3 bench_h100/tools/span_report.py --workload unet-serve-ddim50 \
        --seed 7 [--seconds 51]

The result line is the last line but one of standard output, the report
the last; both are appended to ``chiprun_out/span_report.jsonl``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from collections import Counter
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

from bench_h100 import run  # noqa: E402  (its clock starts here)
from bench_h100 import trace  # noqa: E402
from bench_h100.metrics import _spans  # noqa: E402

PROGRAM = ("serve.", "sampler.", "unet.", "train.", "setup.", "eval.",
           "experiment.")


def _keep(kept):
    """Keep each profiled stretch and each outcome the run makes."""
    base = trace.Profiled

    class Kept(base):
        def stop(self):
            super().stop()
            kept["prof"] = self

    trace.Profiled = Kept
    result_line = run.result_line

    def keep_outcome(cell, outcome, *a, **kw):
        kept["outcome"] = outcome
        return result_line(cell, outcome, *a, **kw)

    run.result_line = keep_outcome


def _table(by, total):
    return {k: [v * 1e3, 100.0 * v / total] for k, v in by.most_common()}


def by_name(spans):
    """{name: [count, median ms]} of the spans of the whole run."""
    got = {}
    for s in spans:
        got.setdefault(s.name, []).append(_spans.ms(s))
    return {k: [len(v), statistics.median(v)] for k, v in sorted(got.items())}


def _quartiles(values):
    """[min, q1, median, q3, max] (``statistics.quantiles``)."""
    v = sorted(values)
    if len(v) < 2:
        return v * 5
    q1, q2, q3 = statistics.quantiles(v, n=4)
    return [v[0], q1, q2, q3, v[-1]]


def copy_back_timeline(prof, batches, offset):
    """Per batch, in microseconds, what happens around its copy to the
    host, each on the trace's clock: from ``serve.copy_back``'s start
    (put there by ``offset``) to the start of the runtime call that
    issued the copy; the copy; from its end to the return of the runtime
    call that waited for it (these two are CUPTI's own records, on the
    clock of the device's ops); and from that return to the span's end:
    the Python thread's lag behind the runtime, a wait for the GIL
    among it."""
    calls = sorted((h for h in prof.host if h[0].startswith("cuda")),
                   key=lambda h: h[1])
    out = []
    for ops, _, below in batches:
        cb = next(s for s in below if s.name == "serve.copy_back")
        _, a, b = ops[-1]
        s, e = cb.start / 1e9 - offset, cb.end / 1e9 - offset
        issued = [h for h in calls if h[1] <= a
                  and h[0].startswith("cudaMemcpy")]
        waited = [h for h in calls if h[1] <= b <= h[2]]
        row = {"copy_us": (b - a) * 1e6}
        if issued:
            row["span_start_to_call_us"] = (issued[-1][1] - s) * 1e6
        if waited:
            ret = max(h[2] for h in waited)
            row["waited_in"] = sorted({h[0] for h in waited})
            row["copy_end_to_return_us"] = (ret - b) * 1e6
            row["return_to_span_end_us"] = (e - ret) * 1e6
        out.append(row)
    return out


def _unet_share(record, spans, offset):
    got = _spans.served_idle_by_span(record, spans, offset)
    return None if got is None else 100.0 * got[0].get(
        "unet.forward", 0.0) / got[1]


def serving(record, line, prof):
    spans = _spans.program_spans()
    got = _spans.served_batches(record, spans)
    if got is None or not got[3]:
        return {"aligned": False}
    offset, half, brackets, batches = got
    by, total, _ = _spans.served_idle_by_span(record, spans)
    report = {
        "idle_ms_by_span": _table(by, total), "idle_ms": total * 1e3,
        "copies_to_host": sum("DtoH" in n for n, _, _ in
                              record["device_ops"]),
        "copies_paired": len(brackets), "batches": len(batches),
        "copy_back_offset_s": offset, "copy_back_resolution_us": half * 1e6,
        "copy_back_brackets_us": [[(lo - offset) * 1e6, (hi - offset) * 1e6]
                                  for lo, hi in brackets],
        # the metric with the spans at either end of what the copies allow
        "idle_in_unet_pct_at_ends": [_unet_share(record, spans, offset + d)
                                     for d in (-half, half)],
        "harness_batch_ops": [len(b["ops"]) for b in
                              record.get("profiled_batches") or []],
        "batch_ops": [len(ops) for ops, _, _ in batches],
    }
    if prof is not None:
        report["copy_back_timeline"] = copy_back_timeline(
            prof, batches, offset)
        if prof.offset_s is not None:
            # the harness's clock marks against the copies' brackets, and
            # the table on the marks
            marks = -prof.offset_s
            report["marks_less_copy_back_us"] = (marks - offset) * 1e6
            by_marks = Counter()
            for ops, span, below in batches:
                by_marks.update(_spans.idle_by_span(
                    ops, _spans.on_trace([span] + below, marks))[0])
            report["idle_ms_by_span_on_clock_marks"] = _table(by_marks,
                                                              total)
    cbs = [s for s in spans if s.name == "serve.copy_back"]
    report["copy_back_wall_us"] = _quartiles(
        [(s.end - s.start) / 1e3 for s in cbs])
    n = _spans.unprofiled_batches(record) or 0
    ids = {s.key for s in _spans.unprofiled_queue_waits(spans, n)}
    for name in ("serve.decode", "serve.encode"):
        report[name + "_ms"] = _quartiles(
            [_spans.ms(s) for s in spans if s.name == name and s.key in ids])
    m = {k: v["value"] for k, v in line["metrics"].items()}
    batch = m.get("serve.batch_ms")
    report["fwd_plus_self_ms"] = (m.get("unet.host_ms_per_fwd.serve", 0.0)
                                  + m.get("sampler.self_ms_per_step.serve",
                                          0.0))
    report["batch_ms_per_step"] = (None if batch is None
                                   else batch / record["steps"])
    return report


def training(record, prof):
    ranges = [r for r in prof.host if r[0].startswith(PROGRAM)]
    by, total = _spans.idle_by_span(record["device_ops"], ranges)
    return {"idle_ms_by_span": _table(by, total), "idle_ms": total * 1e3,
            "ranges": len(ranges), "profile_steps": record["profile_steps"]}


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=51)
    args = p.parse_args(argv)
    kept = {}
    _keep(kept)
    line = run.main(["--workload", args.workload, "--seed", str(args.seed),
                     "--seconds", str(args.seconds), "--trace", "1"])
    record, prof = kept["outcome"].record, kept.get("prof")
    report = {"workload": args.workload, "seed": args.seed,
              "card": run.harness.card_description()}
    if prof is not None:
        report["harness_offset_s"] = prof.offset_s
        # the program's ranges are host ranges: none may be device time
        report["program_ranges_on_device"] = sum(
            n.startswith(PROGRAM) for n, _, _ in prof.device)
    spans = _spans.program_spans()
    report["span_ms"] = by_name(spans)
    report["setup_s"] = {s.name: _spans.ms(s) / 1e3 for s in spans
                         if s.name.startswith("setup.")}
    if record.get("kind") == "serve":
        report.update(serving(record, line, prof))
    elif prof is not None:
        report.update(training(record, prof))
    out = CHECKOUT / "chiprun_out"
    out.mkdir(exist_ok=True)
    with open(out / "span_report.jsonl", "a") as f:
        f.write(json.dumps({"line": line, "report": report}) + "\n")
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
