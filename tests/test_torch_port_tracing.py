"""The port's tracer (viewfusion_tpu_torch/tracing.py) and the spans the
program records with it, on the CPU at TINY_CONFIG's sizes: the ring,
the stacks and the switch; a served request's decode, queue wait and
encode under its id; a batch's sampler steps and UNet forwards, timed as
its ``batch_log`` entry; a train step's phases; the experiment loop's
steps, feed waits and eval pass."""

import base64
import copy
import json
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tests.conftest import TINY_CONFIG
from viewfusion_tpu_torch import tracing
from viewfusion_tpu_torch.config import Config, dump_yaml
from viewfusion_tpu_torch.data.synthetic import make_synthetic_shards
from viewfusion_tpu_torch.models.unet import UNet
from viewfusion_tpu_torch.serving import ViewFusionService, make_server
from viewfusion_tpu_torch.training.trainer import (Experiment,
                                                   ExperimentArgs, Trainer,
                                                   packed_indices)
from viewfusion_tpu_torch.utils.png import encode_png

torch.set_num_threads(2)
STEPS = 3


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.id]


# ---------------------------------------------------------------------
# the tracer


def test_nesting_parents_keys_and_attributes():
    t = tracing.Tracer()
    with t.span("outer", key=7, n=1) as outer:
        with t.span("inner") as inner:
            with t.span("leaf", key=9) as leaf:
                pass
            with t.span("sibling") as sibling:
                pass
        explicit = t.begin("explicit", start=5)
        t.end(explicit, end=6, extra=2)
    with t.span("next") as after:
        pass
    assert after.parent is None and after.key is None
    assert sibling.parent == inner.id and sibling.key == 7
    got = {s.name: s for s in t.spans()}
    assert [s.name for s in t.spans()] == ["leaf", "sibling", "inner",
                                           "explicit", "outer", "next"]
    assert got["outer"].parent is None and got["outer"].attrs == {"n": 1}
    assert got["inner"].parent == outer.id and got["inner"].key == 7
    assert got["leaf"].parent == inner.id and leaf.key == 9
    assert got["explicit"].parent == outer.id
    assert (explicit.start, explicit.end, explicit.attrs) == (5, 6,
                                                              {"extra": 2})
    assert outer.start <= inner.start <= leaf.start <= leaf.end \
        <= inner.end <= outer.end
    assert t.spans("inner") == [inner]
    mark = t.mark()
    with t.span("later"):
        pass
    assert [s.name for s in t.spans(after=mark)] == ["later"]


def test_keys_follow_each_threads_own_stack():
    """A span opened off the stack is closed on another thread; the
    parent of what a thread opens is that thread's open span only."""
    t = tracing.Tracer()
    handed = {}

    def worker():
        with t.span("worker", key=2):
            t.end(handed["queued"])
            with t.span("step") as step:
                handed["step"] = step

    with t.span("request", key=1) as req:
        handed["queued"] = t.begin("queue", stack=False)
        th = threading.Thread(target=worker)
        th.start()
        th.join(10)
        assert not th.is_alive()
        with t.span("encode") as enc:
            pass
    got = {s.name: s for s in t.spans()}
    assert got["queue"].parent == req.id and got["queue"].key == 1
    assert enc.parent == req.id and enc.key == 1
    assert handed["step"].parent == got["worker"].id
    assert handed["step"].key == 2


def test_the_ring_keeps_the_newest():
    t = tracing.Tracer(maxlen=4)
    for i in range(10):
        with t.span("s", key=i):
            pass
    assert [s.key for s in t.spans()] == [6, 7, 8, 9]


def test_disabled_records_nothing_and_counts_nothing():
    t = tracing.Tracer()
    t.enable(False)
    with t.span("a", key=1) as sp:
        assert sp is None
    assert t.begin("b") is None
    t.end(None)
    t.count("c")
    assert t.spans() == [] and "c" not in t.counters()
    t.enable(True)
    with t.span("a"):
        pass
    assert [s.name for s in t.spans()] == ["a"]


def test_spans_and_counts_from_many_threads():
    """More threads than cores, a short switch interval: every span and
    every count is kept, each thread's spans under its own parent."""
    t = tracing.Tracer()
    n_threads, per = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def run(k):
            with t.span("thread", key=k):
                for _ in range(per):
                    with t.span("inner"):
                        t.count("n")

        threads = [threading.Thread(target=run, args=(k,))
                   for k in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    spans = t.spans()
    outer = {s.id: s.key for s in spans if s.name == "thread"}
    inner = [s for s in spans if s.name == "inner"]
    assert len(outer) == n_threads and len(inner) == n_threads * per
    assert all(outer[s.parent] == s.key for s in inner)
    assert len({s.id for s in spans}) == len(spans)
    assert t.counters()["n"] == n_threads * per


def test_counters_read_the_kernel_wrappers():
    """Each wrapper registers its counts where it keeps them; a snapshot
    reads them there, with no second count."""
    from viewfusion_tpu_torch.ops.attention import spatial_self_attention
    from viewfusion_tpu_torch.ops.conv_wgrad import conv3x3
    from viewfusion_tpu_torch.ops.groupnorm import group_norm_act

    snap = tracing.counters()
    assert snap["k1.launches"] == group_norm_act.launches
    assert snap["k3.launches"] == spatial_self_attention.launches
    assert snap["conv3x3.grad_copies"] == conv3x3.grad_copies
    assert {"k2.launches", "k2.grad_copies", "k4.launches",
            "conv3x3.input_copies"} <= set(snap)
    t = tracing.Tracer()
    holder = type("Holder", (), {"launches": 3})
    t.watch("h.launches", holder, "launches")
    holder.launches += 2
    assert t.counters()["h.launches"] == 5


def test_spans_open_profiler_ranges():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.span("unet.forward"):
            torch.ones(4).sum()
    assert "unet.forward" in {e.name for e in prof.events()}


# ---------------------------------------------------------------------
# the served path


def _weights(seed=0):
    torch.manual_seed(seed)
    return UNet(Config.from_dict(TINY_CONFIG).unet).state_dict()


@pytest.fixture(scope="module")
def served():
    mark = tracing.mark()
    service = ViewFusionService.from_state_dict(
        Config.from_dict(TINY_CONFIG), _weights(), batch_size=2,
        max_wait_ms=500, default_steps=STEPS, device="cpu")
    service.warmup([STEPS])
    setup = tracing.spans(after=mark)
    httpd = make_server(service, host="127.0.0.1", port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield service, httpd.server_address[1], setup
    httpd.shutdown()
    httpd.server_close()


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_served_requests_and_batches(served):
    service, port, setup = served
    stages = [s for s in setup if s.name.startswith("setup.")]
    assert [s.name for s in stages] == ["setup.model", "setup.warmup"]
    assert stages[1].attrs == {"steps": STEPS}
    warm = [s for s in setup if s.parent == stages[1].id]
    assert [s.name for s in warm] == ["sampler.step"] * STEPS
    rng = np.random.default_rng(0)
    bodies = [{"angle": 0.5 + i, "steps": STEPS, "views": [
        base64.b64encode(encode_png(rng.integers(
            0, 256, (8, 8, 3), dtype=np.uint8))).decode()
        for _ in range(1 + i)]} for i in range(2)]
    log_before = len(service.batch_log)
    mark = tracing.mark()
    codes = [None, None]

    def call(i):
        codes[i] = _post(port, bodies[i])[0]

    threads = [threading.Thread(target=call, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(120)
    assert codes == [200, 200]
    # a handler closes its request's spans just after the reply is sent
    deadline = time.monotonic() + 30
    while (len(tracing.spans("serve.request", after=mark)) < 2
           and time.monotonic() < deadline):
        time.sleep(0.01)
    spans = tracing.spans(after=mark)
    by = {}
    for s in spans:
        by.setdefault(s.name, []).append(s)
    # each request: its decode, queue wait and encode under its id
    requests = by["serve.request"]
    assert len(requests) == 2
    for req in requests:
        kids = _children(spans, req)
        assert [k.name for k in sorted(kids, key=lambda k: k.start)] == [
            "serve.decode", "serve.queue", "serve.encode"]
        assert all(k.key == req.key for k in kids)
    # each batch: its requests, one sampler step a step, one forward each
    batches = by["serve.batch"]
    log = list(service.batch_log)[log_before:]
    assert len(batches) == len(log) >= 1
    rids = sorted(r for b in batches for r in b.attrs["request_ids"])
    assert rids == sorted(r.key for r in requests)
    for b, (_, _, n, seconds) in zip(batches, log):
        assert b.attrs["requests"] == n == len(b.attrs["request_ids"])
        assert b.attrs["rows"] == 2 * service.n_max
        assert (b.end - b.start) / 1e9 == seconds
        kids = sorted(_children(spans, b), key=lambda k: k.start)
        assert [k.name for k in kids] == (["serve.h2d"]
                                          + ["sampler.step"] * STEPS
                                          + ["serve.copy_back"])
        for step in kids[1:-1]:
            fwd = _children(spans, step)
            assert [f.name for f in fwd] == ["unet.forward"]
            assert step.key == fwd[0].key == b.key
        waits = [q for q in by["serve.queue"]
                 if q.attrs["batch"] == b.key]
        assert sorted(q.key for q in waits) == sorted(
            b.attrs["request_ids"])
        assert all(q.end <= b.start for q in waits)
    views = {r.key: len(body["views"]) for r, body in zip(
        sorted(requests, key=lambda r: r.key), bodies)}
    assert sum(b.attrs["views"] for b in batches) == sum(views.values())
    assert len(by["serve.assemble"]) == len(batches)


def test_refused_and_timed_out_requests_are_counted(served):
    service, port, _ = served
    before = tracing.counters()
    code, _ = _post(port, {"angle": 0.0, "views": ["bm90IGFuIGltYWdl"]})
    assert code == 400
    with pytest.raises(TimeoutError):
        service.submit(np.zeros((1, 8, 8, 3), np.float32), 0.0,
                       timeout=0.0)
    after = tracing.counters()
    assert after.get("serve.refused", 0) == before.get("serve.refused",
                                                       0) + 1
    # the timed-out request is skipped by the worker, which counts it
    assert service.submit(np.zeros((1, 8, 8, 3), np.float32), 0.0).shape \
        == (8, 8, 3)
    assert tracing.counters().get("serve.abandoned", 0) >= \
        before.get("serve.abandoned", 0) + 1


def test_disabled_program_records_no_span():
    model_cfg = Config.from_dict(TINY_CONFIG)
    tracing.enable(False)
    try:
        mark = tracing.mark()
        service = ViewFusionService.from_state_dict(
            model_cfg, _weights(), batch_size=1, default_steps=2,
            device="cpu")
        img = service.submit(np.zeros((1, 8, 8, 3), np.float32), 0.0)
        assert img.shape == (8, 8, 3) and len(service.batch_log) == 1
        tr = Trainer(_train_config(), device="cpu")
        tr.train_step(_batch(np.random.default_rng(1)))
        assert tracing.spans(after=mark) == []
    finally:
        tracing.enable(True)


# ---------------------------------------------------------------------
# training


def _train_config(**tpu):
    raw = copy.deepcopy(TINY_CONFIG)
    raw["data"]["params"]["batch_size"] = 4
    raw["tpu"].update({"packed_views": True, "ema_decay": 0.9,
                       "lr_warmup": 1, **tpu})
    return Config.from_dict(raw)


def _batch(rng, b=4, n=3):
    counts = np.array([1, 3, 2, 3], np.int32)[:b]
    si, vi = packed_indices(counts)
    return {"target": rng.integers(0, 256, (b, 8, 8, 3), dtype=np.uint8),
            "cond": rng.integers(0, 256, (b, n, 8, 8, 3), dtype=np.uint8),
            "angle": rng.uniform(0, 6.28, b).astype(np.float32),
            "view_count": counts, "sample_idx": si, "view_idx": vi}


def test_train_step_phases_in_order():
    mark = tracing.mark()
    tr = Trainer(_train_config(), device="cpu")
    rng = np.random.default_rng(0)
    tr.train_step(_batch(rng))
    tr.train_step(_batch(rng))
    spans = tracing.spans(after=mark)
    assert spans[0].name == "setup.model"
    steps = [s for s in spans if s.name == "train.step"]
    assert [s.key for s in steps] == [0, 1]
    for step in steps:
        kids = sorted(_children(spans, step), key=lambda k: k.start)
        assert [k.name for k in kids] == [
            "train.h2d", "train.forward", "train.backward",
            "train.optimizer", "train.ema"]
        assert all(k.key == step.key for k in kids)
        assert all(step.start <= k.start <= k.end <= step.end
                   for k in kids)
        assert all(a.end <= b.start for a, b in zip(kids, kids[1:]))
        fwd = _children(spans, kids[1])
        assert [f.name for f in fwd] == ["unet.forward"]


def test_experiment_loop_records_one_step_an_iteration(tmp_path):
    data = str(tmp_path / "data")
    make_synthetic_shards(data, "train", num_objects=8, image_size=8)
    make_synthetic_shards(data, "test", num_objects=8, image_size=8)
    raw = copy.deepcopy(TINY_CONFIG)
    for split in ("train", "test"):
        raw["data"]["params"][split]["params"]["path"] = data
    raw["data"]["params"]["test"]["params"]["size"] = 4
    raw["data"]["params"]["batch_size"] = 4
    raw["model"].update(max_it=3, checkpoint_every=0, log_every=2,
                        validate_every=3, validate_from=3)
    raw["tpu"].update({"packed_views": True, "native_loader": False,
                       "async_checkpoint": False})
    path = str(tmp_path / "t.yaml")
    with open(path, "w") as f:
        f.write(dump_yaml(raw))
    mark = tracing.mark()
    exp = Experiment(ExperimentArgs(config=path, train=True, device="cpu"),
                     log_root=str(tmp_path / "logs"))
    exp.train()
    spans = tracing.spans(after=mark)
    steps = [s for s in spans if s.name == "train.step"]
    assert exp.it == 3 and len(steps) == exp.trainer.step == 4
    assert [s.key for s in steps] == [0, 1, 2, 3]
    assert all(a.end <= b.start for a, b in zip(steps, steps[1:]))
    waits = [s for s in spans if s.name == "experiment.feed_wait"]
    assert [w.key for w in waits][:4] == [0, 1, 2, 3]
    evals = [s for s in spans if s.name == "eval.pass"]
    assert len(evals) == 1 and evals[0].key == 3
    assert evals[0].end <= steps[3].start
    inside = [s for s in spans if s.name == "sampler.step"
              and s.key == 3 and evals[0].start <= s.start <= evals[0].end]
    assert inside  # the eval's chain, keyed by its iteration
