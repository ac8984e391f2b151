"""The denoiser's CUDA-graph runner (``viewfusion_tpu_torch/models/
graphed.py``) on the CPU, at TINY_CONFIG's sizes: the rule that sends a
call down the eager path, the graph's key, the bound on the keys kept,
and the counters a replay adds to.  On the CPU every call is eager, so
a forward through the runner equals the denoiser called directly, bit
for bit.  The graphs themselves are held against the eager forward on a
card (``tests/test_torch_port_cuda.py``)."""

import numpy as np
import pytest
import torch

from tests.conftest import TINY_CONFIG
from viewfusion_tpu_torch import tracing
from viewfusion_tpu_torch.config import Config
from viewfusion_tpu_torch.models import graphed
from viewfusion_tpu_torch.models.graphed import MAX_GRAPHS, GraphedForward
from viewfusion_tpu_torch.models.view_fusion import ViewFusion

torch.set_num_threads(2)

B, N, HW = 2, 3, 8


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    return ViewFusion.from_config(Config.from_dict(TINY_CONFIG))


def _inputs(seed=1, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((B, N, HW, HW, 3), generator=g).to(dtype),
            torch.randn((B, HW, HW, 3), generator=g),
            torch.rand((B,), generator=g),
            torch.rand((B,), generator=g) * 6.28)


def _unet_inputs(rows=B * N, dtype=torch.float32, seed=2):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((rows, HW, HW, 6), generator=g).to(dtype),
            torch.rand((rows,), generator=g), torch.rand((rows,), generator=g))


def _count(name):
    return tracing.counters().get(name, 0)


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode"])
@pytest.mark.parametrize("packed", [False, True])
def test_cpu_forward_is_eager_and_equals_the_denoiser(model, mode, packed):
    y_cond, y_t, level, angle = _inputs()
    ctx = torch.no_grad if mode == "no_grad" else torch.inference_mode
    with ctx():
        if packed:
            s = torch.tensor([0, 0, 1, 1, 1])
            v = torch.tensor([0, 1, 0, 1, 2])
            x = torch.cat([y_cond[s, v], y_t[s]], dim=-1)
            want = torch.zeros((B * N, HW, HW, 6))
            want[s * N + v] = model.unet(x, angle[s], level[s])
            rows = 5
        else:
            x = torch.cat([y_cond, y_t[:, None].expand(B, N, HW, HW, 3)],
                          dim=-1).reshape(B * N, HW, HW, 6)
            want = model.unet(x, angle.repeat_interleave(N),
                              level.repeat_interleave(N))
            rows = B * N
        before = tracing.counters()
        mark = tracing.mark()
        got = model._denoise_views(y_cond, y_t, level, angle,
                                   packed_idx=(s, v) if packed else None)
    assert torch.equal(got.reshape(B * N, HW, HW, 6), want)
    after = tracing.counters()
    assert after["unet.graph_bypassed"] == before.get(
        "unet.graph_bypassed", 0) + 1
    for name in ("unet.graph_captures", "unet.graph_replays"):
        assert after.get(name, 0) == before.get(name, 0)
    (span,) = tracing.spans("unet.forward", after=mark)
    assert span.attrs == {"graphed": False, "rows": rows}
    assert not model.graphs.entries


@pytest.mark.parametrize("case", ["override", "dropout", "autograd",
                                  "device_no_grad", "device_inference"])
def test_the_rule_names_why_a_call_is_eager(model, case):
    """Each condition of the rule on its own; the CPU is the last
    checked, so each other reason shows here too."""
    x = _unet_inputs()[0]
    want = {"device_no_grad": "device",
            "device_inference": "device"}.get(case, case)
    kw = {"override": case == "override",
          "dropout": torch.Generator() if case == "dropout" else None}
    if case == "autograd":
        with torch.enable_grad():
            got = GraphedForward.eager_reason(x, **kw)
    elif case == "device_inference":
        with torch.inference_mode():
            got = GraphedForward.eager_reason(x, **kw)
    else:
        with torch.no_grad():
            got = GraphedForward.eager_reason(x, **kw)
    assert got == want
    if case in ("override", "dropout", "autograd"):
        # a call that leaves the condition out: on the CPU, "device" still
        with torch.no_grad():
            assert GraphedForward.eager_reason(x) == "device"


@pytest.mark.parametrize("case", ["autograd", "dropout", "override"])
def test_bypassed_calls_are_counted_and_run_the_denoiser(model, case):
    y_cond, y_t, level, angle = _inputs(seed=3)
    calls = []

    def override(x, a, lvl, **kw):
        calls.append(kw)
        return model.unet(x, a, lvl, **kw)

    kw = {}
    if case == "override":
        kw["denoiser"] = override
    elif case == "dropout":
        kw["dropout"] = torch.Generator().manual_seed(0)
    before = _count("unet.graph_bypassed")
    with torch.set_grad_enabled(case == "autograd"):
        out = model._denoise_views(y_cond, y_t, level, angle, **kw)
    assert _count("unet.graph_bypassed") == before + 1
    assert out.shape == (B, N, HW, HW, 6)
    assert out.requires_grad == (case == "autograd")
    assert calls == ([{}] if case == "override" else [])


@pytest.mark.parametrize("change", ["shape", "dtype", "inference_mode",
                                    "data_replaced", "parameter_replaced",
                                    "buffer_replaced"])
def test_the_key_follows_what_the_graph_reads(model, change):
    unet = model.unet
    runner = GraphedForward()
    inputs = _unet_inputs()
    with torch.no_grad():
        base = runner.key(unet, inputs)
        assert runner.key(unet, inputs) == base
        restored = base
        if change == "shape":
            other = runner.key(unet, _unet_inputs(rows=5))
        elif change == "dtype":
            other = runner.key(unet, _unet_inputs(dtype=torch.bfloat16))
        elif change == "inference_mode":
            with torch.inference_mode():
                other = runner.key(unet, inputs)
        else:
            m = unet.downs[0]
            if change == "buffer_replaced":
                m.register_buffer("probe", torch.zeros(3))
                runner = GraphedForward()  # a new denoiser structure
                base = runner.key(unet, inputs)
            saved = m.weight, m.weight.data, getattr(m, "probe", None)
            try:
                if change == "data_replaced":
                    m.weight.data = m.weight.data.clone()
                elif change == "parameter_replaced":
                    m.weight = torch.nn.Parameter(m.weight.data.clone())
                else:
                    m.probe = torch.zeros(3)
                other = runner.key(unet, inputs)
            finally:
                m.weight = saved[0]
                m.weight.data = saved[1]
                if change == "buffer_replaced":
                    m.probe = saved[2]
            restored = runner.key(unet, inputs)
            if change == "buffer_replaced":
                del m.probe
        assert other != base
        assert restored == base


@pytest.mark.parametrize("update", ["load_state_dict", "optimizer", "ema"])
def test_the_key_holds_across_in_place_weight_updates(update):
    torch.manual_seed(0)
    unet = ViewFusion.from_config(Config.from_dict(TINY_CONFIG)).unet
    runner = GraphedForward()
    inputs = _unet_inputs()
    with torch.no_grad():
        base = runner.key(unet, inputs)
    first = {k: v.clone() for k, v in unet.state_dict().items()}
    if update == "load_state_dict":
        unet.load_state_dict({k: v + 1.0 for k, v in first.items()})
    elif update == "optimizer":
        opt = torch.optim.Adam(unet.parameters(), lr=0.1)
        unet(*inputs).square().mean().backward()
        opt.step()
    else:  # the Trainer's EMA update of its shadow
        unet.requires_grad_(False)
        params = list(unet.parameters())
        torch._foreach_mul_(params, 0.9)
        torch._foreach_add_(params, [p * 0.1 + 0.5 for p in params])
    assert any(not torch.equal(v, first[k])
               for k, v in unet.state_dict().items())
    with torch.no_grad():
        assert runner.key(unet, inputs) == base


def test_at_most_max_graphs_keys_are_kept_least_recently_used_first():
    runner = GraphedForward()
    for k in range(MAX_GRAPHS):
        runner.remember(("key", k), None)
    runner.remember(("key", 0), None)  # used again: now the newest
    for k in range(MAX_GRAPHS, MAX_GRAPHS + 2):
        runner.remember(("key", k), None)
    assert len(runner.entries) == MAX_GRAPHS
    assert list(runner.entries) == [("key", k) for k in (
        3, 0, MAX_GRAPHS, MAX_GRAPHS + 1)][-MAX_GRAPHS:]
    assert ("key", 1) not in runner.entries
    assert ("key", 2) not in runner.entries
    assert graphed.MAX_GRAPHS == MAX_GRAPHS >= 1


def test_a_replay_adds_each_counters_rise_to_the_watched_attribute():
    class Wrapper:
        launches = 5

    t = tracing.Tracer()
    t.watch("probe.launches", Wrapper, "launches")
    before = t.watched()
    Wrapper.launches += 69
    rise = {n: v - before[n] for n, v in t.watched().items()}
    t.add_watched(rise, -1)  # a capture runs nothing
    assert Wrapper.launches == 5
    for _ in range(3):
        t.add_watched(rise)  # each replay runs the forward's launches
    assert t.counters()["probe.launches"] == 5 + 3 * 69
    assert np.array_equal(sorted(t.watched()), ["probe.launches"])
