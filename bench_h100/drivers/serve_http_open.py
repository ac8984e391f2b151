"""Open-loop HTTP serving of novel views: the program's server
(``make_server(ViewFusionService.from_state_dict(...))``) on an ephemeral
localhost port, and a load generator in a process of its own
(``traffic/loadgen.py``) that sends ``POST /generate`` requests at the
cell's fixed rate, each due at its scheduled time whatever came before.

The cell's ``traffic`` block: ``rate`` (requests/s), ``views`` [lo, hi]
(each count equally often, shuffled by the seed), ``steps`` and
``sampler``, the server's ``batch_size`` and ``max_wait_ms``, ``drain_s``
(how long after the window a reply may still come) and ``check_requests``
(how many finished requests the reference recomputes).

End to end: ``request_p95_ms``, the 95th percentile over every request
due in the window of its due time to its reply (a failed request or one
without a reply counts as missing it); ``views_per_s``, the views
returned successfully within the window over the window; ``setup_s``.

``correct``: a sample, drawn from the seed, of the requests answered,
the largest (6 views) among them, recomputed by the float32 reference
from the harness's own views (not the server's decode) and the weights;
the served PNG, decoded by the harness, against the reference image
turned to bytes as the server does.  The sampler's noise is the
program's: each batch draws it from a generator seeded by the server; a
recorder around ``generate_ddim`` keeps each batch's seed, angles and
view counts, the request's angle finds its batch and slot, and the
reference draws the same noise from that seed.
"""

from __future__ import annotations

import base64
import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

from bench_h100 import harness
from bench_h100 import trace as tracing
from bench_h100.reference import diffusion, precision
from bench_h100.traffic import arrivals, png, views

LOADGEN = Path(__file__).resolve().parent.parent / "traffic" / "loadgen.py"
# The traced stretch starts PROFILE_LEAD_S before the window's close and
# ends once PROFILE_BATCHES batches have run wholly inside it (the next
# one has started, so their results were read back), or PROFILE_MAX_S
# after the profiler came up.  The profiler's start stalls the server for
# seconds and then roughly halves the host's launch rate, so a batch
# takes about two seconds in it and the one in flight up to seven; the
# requests that pile up meanwhile keep the batches coming past the close.
PROFILE_LEAD_S = 35.0
PROFILE_BATCHES = 3
PROFILE_MAX_S = 40.0


class Recorder:
    """Wraps the model's ``generate_ddim``: keeps, per batch, the
    generator's seed and the (device) angles and view counts, and the
    call's start and end on ``time.perf_counter``."""

    def __init__(self, model):
        self.batches, self.starts, self.spans = [], [], []
        self._orig = model.generate_ddim
        model.generate_ddim = self

    def __call__(self, y_cond, view_count, angle, *args, **kw):
        gen = kw.get("generator")
        self.batches.append((gen.initial_seed(), angle.detach().clone(),
                             view_count.detach().clone()))
        t = time.perf_counter()
        self.starts.append(t)
        out = self._orig(y_cond, view_count, angle, *args, **kw)
        self.spans.append((len(self.batches) - 1, t, time.perf_counter()))
        return out


def make_requests(seed: int, rate: float, seconds: float, lo: int, hi: int,
                  size: int, steps: int, sampler: str):
    """The window's requests: due offsets, view counts (each of lo..hi
    equally often, shuffled), angles in [0, 2 pi) as float32 values, the
    uint8 views and the JSON bodies with the views as base64 PNGs."""
    rng = np.random.default_rng([seed % (2 ** 64), 1])
    due = arrivals.due_times(rate, seconds, rng)
    n = len(due)
    counts = np.resize(np.arange(lo, hi + 1), n)
    rng.shuffle(counts)
    angles = rng.uniform(0.0, 2 * np.pi, n).astype(np.float32)
    reqs = []
    for i in range(n):
        v = views.render_views(rng, int(counts[i]), size)
        encoded = [base64.b64encode(png.encode(x.tobytes(), size, size))
                   .decode() for x in v]
        body = json.dumps({"views": encoded, "angle": float(angles[i]),
                           "steps": steps, "sampler": sampler})
        reqs.append({"due": float(due[i]), "count": int(counts[i]),
                     "angle": angles[i], "views": v, "body": body})
    return reqs


def _served_image(rec, size):
    w, h, data = png.decode(base64.b64decode(rec["image"]))
    if (w, h) != (size, size):
        raise ValueError(f"served image is {w}x{h}")
    return np.frombuffer(data, np.uint8).reshape(size, size, 3)


def reference_images(forward, params, widths, sched, picks, batches, steps,
                     size, batch_size, device, prec=precision.FLOAT32):
    """The reference's uint8 image for each picked request ((count, angle,
    views, batch index, slot)), all in one reference batch, with the
    family's reference ``forward``."""
    import torch

    draws = {}
    for _, _, _, k, _ in picks:
        seed = batches[k][0]
        if seed not in draws:
            g = torch.Generator(device=device).manual_seed(seed)
            draws[seed] = [torch.randn((batch_size, size, size, 3),
                                       generator=g, device=device)
                           for _ in range(steps)]
    n_max = max(p[0] for p in picks)
    b = len(picks)
    cond = torch.zeros((b, n_max, size, size, 3), device=device)
    for j, (c, _, v, _, _) in enumerate(picks):
        cond[j, :c] = torch.from_numpy(v).to(device).float() / 255.0
    counts = torch.tensor([p[0] for p in picks], device=device)
    angle = torch.tensor(np.array([p[1] for p in picks], np.float32),
                         device=device)

    def noise(i):
        return torch.stack([draws[batches[k][0]][i][slot]
                            for _, _, _, k, slot in picks])

    def denoiser(x, a, lv):
        return forward(params, widths, x, a, lv, prec)

    with torch.no_grad():
        y = diffusion.ddim_eta1(denoiser, sched, cond, counts, angle, steps,
                                noise)
    img = np.clip(y.cpu().numpy(), 0.0, 1.0)
    return (img * 255).astype(np.uint8)


def locate(picks_in, batches):
    """(count, angle, views, batch index, slot) of each request, found by
    its angle among the recorded batches; None where it is in none."""
    angles = [b[1].cpu().numpy() for b in batches]
    counts = [b[2].cpu().numpy() for b in batches]
    out = []
    for c, a, v in picks_in:
        hit = None
        for k, arr in enumerate(angles):
            idx = np.nonzero(arr == np.float32(a))[0]
            if len(idx):
                hit = (k, int(idx[0]))
                break
        if hit is None or int(counts[hit[0]][hit[1]]) != c:
            out.append(None)
        else:
            out.append((c, a, v) + hit)
    return out


class Served:
    """The program's server on a localhost port, built from the cell's
    configuration and the seed's weights, warmed up at the cell's shape."""

    def __init__(self, cell, seed: int, device: str):
        from viewfusion_tpu_torch.config import load_config
        from viewfusion_tpu_torch.serving import (ViewFusionService,
                                                  make_server)

        tr = cell.workload["traffic"]
        self.widths = widths = cell.config["widths"]
        config = load_config(str(cell.yaml_path))
        harness.check_widths(config, widths, cell.yaml_path)
        self.size = widths["image_size"]
        self.steps, self.sampler = int(tr["steps"]), tr["sampler"]
        if self.sampler != "ddim":
            raise ValueError("the reference follows the ddim sampler only")
        self.reference = cell.reference()
        self.params = harness.make_params(
            self.reference.param_specs(widths), harness.sub_seed(seed, 2),
            device)
        self.service = ViewFusionService.from_state_dict(
            config, self.params, batch_size=int(tr["batch_size"]),
            max_wait_ms=float(tr["max_wait_ms"]), default_steps=self.steps,
            device=device)
        self.service.warmup([self.steps], sampler=self.sampler)
        self.recorder = Recorder(self.service.model)
        self.httpd = make_server(self.service, "127.0.0.1", 0)
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        self.port = self.httpd.server_address[1]

    def requests(self, seed: int, rate: float, seconds: float, views_lo_hi):
        return make_requests(seed, rate, seconds, views_lo_hi[0],
                             views_lo_hi[1], self.size, self.steps,
                             self.sampler)

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


class OpenLoop:
    """The load generator's process, fed the window's requests; ``go``
    sets the window's start, ``records`` waits for its replies."""

    def __init__(self, reqs):
        self.n = len(reqs)
        self.child = subprocess.Popen([sys.executable, str(LOADGEN)],
                                      stdin=subprocess.PIPE,
                                      stdout=subprocess.PIPE, text=True)
        self._out = []
        self._reader = threading.Thread(
            target=lambda: self._out.append(self.child.stdout.read()),
            daemon=True)
        self._reader.start()
        for r in reqs:
            self.child.stdin.write(json.dumps({"due": r["due"],
                                               "body": r["body"]}) + "\n")

    def go(self, start: float, port: int, seconds: float, drain_s: float):
        self.child.stdin.write(json.dumps({
            "start": start, "port": port, "seconds": seconds,
            "drain_s": drain_s}) + "\n")
        self.child.stdin.close()
        self.timeout = start + seconds + drain_s + 120 - time.monotonic()

    def records(self):
        self._reader.join(max(1.0, self.timeout))
        self.child.wait(30)
        out = self._out[0] if self._out else ""
        recs = [json.loads(x) for x in out.splitlines() if x.strip()]
        if len(recs) != self.n:
            raise RuntimeError(f"the load generator returned {len(recs)} "
                               f"records for {self.n} requests")
        return recs


def latencies(records, close: float):
    """(latencies in ms, inf where there was no reply; replies within the
    window; requests failed)."""
    lat, in_window, failed = [], 0, 0
    for r in records:
        if r["done"] is not None and r["image"] is not None:
            lat.append((r["done"] - r["due"]) * 1e3)
            in_window += r["done"] <= close
        else:
            lat.append(math.inf)
            failed += 1
    return lat, in_window, failed


def run(cell, seed: int, seconds: float, trace: int, device: str,
        t0: float) -> harness.Outcome:
    import torch

    tr = cell.workload["traffic"]
    s = Served(cell, seed, device)
    service, widths, size, steps = s.service, s.widths, s.size, s.steps
    reqs = s.requests(seed, float(tr["rate"]), seconds, tr["views"])
    loop = OpenLoop(reqs)
    if device == "cuda":
        torch.cuda.synchronize()
    start = time.monotonic() + 0.2
    setup_s = start - t0
    drain_s = float(tr["drain_s"])
    loop.go(start, s.port, seconds, drain_s)
    prof = (profile_stretch(start, seconds, device, service, s.recorder)
            if trace else None)
    records = loop.records()
    close = start + seconds
    lat, ok_in_window, failed = latencies(records, close)
    sent = [r["sent"] - r["due"] for r in records if r["sent"] is not None]
    late = max(sent) if sent else math.inf
    memory_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    s.close()

    # the reference, once the window has closed and the peak is read
    batch_log = list(service.batch_log)
    batches = list(s.recorder.batches)
    answered = [i for i, r in enumerate(records) if r["image"] is not None]
    rng = np.random.default_rng([seed % (2 ** 64), 3])
    n_check = min(int(tr["check_requests"]), len(answered))
    picked = []
    if answered:
        most = max(reqs[j]["count"] for j in answered)
        largest = [i for i in answered if reqs[i]["count"] == most]
        picked.append(int(rng.choice(largest)))
        rest = [i for i in answered if i != picked[0]]
        if rest and n_check > 1:
            picked += [int(i) for i in rng.choice(
                rest, size=min(n_check - 1, len(rest)), replace=False)]
    located = locate([(reqs[i]["count"], reqs[i]["angle"], reqs[i]["views"])
                      for i in picked], batches)
    gap_max, gap_mean = 0.0, 0.0
    good = [(i, p) for i, p in zip(picked, located) if p is not None]
    unmatched = len(picked) - len(good)
    if good:
        precision.no_tf32()
        sched = diffusion.Schedule(**cell.config["schedule"])
        ref = reference_images(s.reference.forward, s.params, widths, sched,
                               [p for _, p in good], batches, steps, size,
                               int(tr["batch_size"]), device)
        for (i, _), ref_img in zip(good, ref):
            served = _served_image(records[i], size).astype(np.int32)
            diff = np.abs(served - ref_img.astype(np.int32))
            gap_max = max(gap_max, float(diff.max()))
            gap_mean = max(gap_mean, float(diff.mean()))
    lim = cell.workload["limits"]
    checks = [("pixel_gap_max", gap_max, lim["pixel_gap_max"]),
              ("pixel_gap_mean", gap_mean, lim["pixel_gap_mean"]),
              ("requests_compared", len(good), n_check),
              ("requests_unmatched", unmatched, 0)]
    correct = (bool(good) and len(good) == n_check and unmatched == 0
               and gap_max <= lim["pixel_gap_max"]
               and gap_mean <= lim["pixel_gap_mean"])

    e2e = {"request_p95_ms": harness.percentile(lat, 95),
           "views_per_s": ok_in_window / seconds, "setup_s": setup_s}
    # per-batch view sums: the recorder and the batch log pair in order
    real_views = ([int(b[2][:n].sum()) for b, (_, _, n, _) in
                   zip(batches, batch_log)]
                  if len(batches) == len(batch_log) else None)
    record = {"kind": "serve", "widths": widths,
              "denoiser": cell.config["denoiser"],
              "steps": steps, "batch_size": int(tr["batch_size"]),
              "n_max": service.n_max, "batch_log": batch_log,
              "real_views": real_views, "dtype": cell.config["compute_dtype"]}
    outcome = harness.Outcome(
        correct=correct, attempted=len(records), failed=failed,
        end_to_end=e2e, record=record, checks=checks,
        memory_peak_bytes=memory_peak,
        notes=[f"requests {len(records)}, answered {len(answered)}, "
               f"in the window {ok_in_window}, generator at most "
               f"{late * 1e3:.1f} ms late, batches {len(batch_log)}, "
               f"p50 {harness.percentile(lat, 50):.1f} ms"])
    if prof is not None:
        _traced(prof, record, outcome, list(s.recorder.spans))
    return outcome


def profile_stretch(start, seconds, device, service, recorder):
    """Profile the window's end from this thread, as PROFILE_LEAD_S,
    PROFILE_BATCHES and PROFILE_MAX_S say; the profile keeps how many
    batches had ended when it started (those ran unprofiled) and how
    long the profiler took to come up."""
    close = start + seconds
    time.sleep(max(0.0, close - PROFILE_LEAD_S - time.monotonic()))
    if device != "cuda":
        return None
    p = tracing.Profiled()
    p.batches_before = len(service.batch_log)
    asked = time.perf_counter()
    p.start()
    p.start_s = p.host_t0 - asked
    while time.perf_counter() < p.host_t0 + PROFILE_MAX_S and sum(
            t >= p.host_t0 for t in list(recorder.starts)) \
            <= PROFILE_BATCHES:
        time.sleep(0.05)
    p.stop()
    return p


def _traced(prof, record, outcome, spans) -> None:
    """Fill the record and the outcome from the profiled stretch: device
    ops, busy time, the device ops of each batch run wholly inside it,
    and the batches before it for the wall time."""
    record["device_ops"] = prof.device
    record["busy_s"] = tracing.busy_s(prof.device)
    inside = [(k, a, b) for k, a, b in spans
              if a >= prof.host_t0 and b <= prof.host_t1]
    ops = ([] if prof.offset_s is None else tracing.ops_until_copy_back(
        prof.device, [(prof.to_trace(a), prof.to_trace(b))
                      for _, a, b in inside]))
    record["profiled_batches"] = [
        {"index": k, "ops": o}
        for (k, _, _), o in zip(inside, ops) if o is not None]
    record["forwards_profiled"] = (len(record["profiled_batches"])
                                   * record["steps"])
    # batches that ended before the profile started, for the wall time
    record["unprofiled_batches"] = prof.batches_before
    record["unprofiled_batch_s"] = [
        s for (_, _, _, s) in record["batch_log"][:prof.batches_before]]
    outcome.notes.append(
        f"profiler up in {prof.start_s:.2f} s, traced {prof.window_s:.2f} "
        f"s, batches wholly inside {len(record['profiled_batches'])}")
    outcome.busy_s = record["busy_s"]
    outcome.window_s = prof.window_s
    outcome.breakdown = {"device_ops": tracing.device_ops(prof.device),
                         "idle_gaps": tracing.idle_gaps(prof.device,
                                                      prof.host)}
