"""The harness is driven by data: a cell, a configuration and its YAML
that only this test writes are found by name and run through the
drivers, and no file that was there changes.  Run on the CPU at tiny
sizes in float32, the program agrees with the reference to rounding."""

import json
from pathlib import Path

import pytest

from bench_h100 import harness
from bench_h100.metrics import _spans
from bench_h100.tests import _tiny
from bench_h100.tests import test_bench_h100_span_readers as span_tests


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    root = _tiny.copy_bench(tmp_path_factory.mktemp("checkout"))
    return root, _tiny.tree_hashes(root)


def _unchanged(root, before):
    after = _tiny.tree_hashes(root)
    assert {k: after.get(k) for k in before} == before


def test_new_serving_cell_runs(bench):
    root, before = bench
    name = _tiny.add_tiny_cell(root, "test-serve", "unet-serve-ddim50",
                               **_tiny.SERVE_TINY)
    line = _tiny.run_cell(root, name, seconds=3.0)
    _unchanged(root, before)
    assert line["correct"] is True
    assert line["attempted"] == 12 and line["failed"] == 0
    checks = line["checks"]
    # float32 on both sides: a byte may round the other way
    assert checks["pixel_gap_max"]["value"] <= 1.0
    assert checks["pixel_gap_mean"]["value"] < 0.01
    assert checks["requests_compared"]["value"] == 4
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]


@pytest.mark.parametrize("base", ["unet-train-b80", "dit-train-b28"])
def test_new_training_cell_runs(bench, base):
    root, before = bench
    name = _tiny.add_tiny_cell(root, "test-" + base, base,
                               **_tiny.TRAIN_TINY)
    line = _tiny.run_cell(root, name, seconds=1.0)
    _unchanged(root, before)
    assert line["correct"] is True
    checks = line["checks"]
    assert checks["grad_norm_gap"]["value"] < 1e-5
    assert checks["change_norm_gap"]["value"] < 1e-2


def _family(root, name, fam):
    """Make the cell ``name``'s configuration name the family ``fam``."""
    path = root / "configs" / f"{name}-cfg.json"
    cfg = json.loads(path.read_text())
    cfg["denoiser"] = fam
    path.write_text(json.dumps(cfg))


def _report(root, cell, metrics):
    """List ``cell`` under the per-layer ``metrics`` in the copy's
    BENCHMARK.json, as a later change that adds the cell would."""
    path = root.parent / "BENCHMARK.json"
    manifest = json.loads(path.read_text())
    for m in manifest["per_layer"]:
        if m["name"] in metrics:
            m["workloads"] = m.get("workloads", []) + [cell]
    path.write_text(json.dumps(manifest))


def test_family_only_the_test_knows(bench):
    """A family is its two files, found by the configuration's
    ``denoiser``: this one delegates to the DiT's reference and counts."""
    root, before = bench
    (root / "reference" / "testfam.py").write_text(
        "from bench_h100.reference.dit import forward, param_specs"
        "  # noqa: F401\n")
    (root / "work" / "testfam.py").write_text(
        "from bench_h100.work.dit import attention_sites, flops_per_row"
        "  # noqa: F401\n")
    name = _tiny.add_tiny_cell(root, "test-fam", "dit-train-b28",
                               **_tiny.TRAIN_TINY)
    _family(root, name, "testfam")
    _report(root, name, ("mfu_pct.train", "k2.roofline_pct.train"))
    line = _tiny.run_cell(root, name, seconds=1.0, trace=1)
    _unchanged(root, before)
    assert line["correct"] is True
    assert line["checks"]["grad_norm_gap"]["value"] < 1e-5
    assert line["metrics"]["mfu_pct.train"]["value"] > 0
    # no GroupNorm sites in the family's counts: K2's share is left out
    assert "k2.roofline_pct.train" not in line["metrics"]


def test_dit_serving_cell_runs(bench):
    root, before = bench
    name = _tiny.add_tiny_cell(root, "test-dit-serve", "unet-serve-ddim50",
                               config="dit-s4-64", **_tiny.SERVE_TINY)
    line = _tiny.run_cell(root, name, seconds=3.0)
    _unchanged(root, before)
    assert line["correct"] is True
    assert line["attempted"] == 12 and line["failed"] == 0
    checks = line["checks"]
    assert checks["pixel_gap_max"]["value"] <= 1.0
    assert checks["pixel_gap_mean"]["value"] < 0.01
    assert checks["requests_compared"]["value"] == 4


def test_missing_family_names_its_file(bench, capsys):
    root, before = bench
    name = _tiny.add_tiny_cell(root, "test-nofam", "unet-train-b80",
                               **_tiny.TRAIN_TINY)
    _family(root, name, "nosuchfam")
    with pytest.raises(SystemExit) as e:
        _tiny.run_cell(root, name, seconds=0.5)
    assert e.value.code != 0
    assert str(Path("reference") / "nosuchfam.py") in capsys.readouterr().err
    _unchanged(root, before)


# ---------------------------------------------------------------------
# every reader on fixed records


WIDTHS = {c: json.loads((_tiny.BENCH / "configs" / f"{c}.json").read_text())
          ["widths"] for c in ("unet-paper-64", "dit-s4-64")}


def _span(name, sid, start_ms, end_ms):
    s = type("Span", (), {})()
    s.name, s.id, s.key, s.parent, s.attrs = name, sid, None, None, {}
    s.start, s.end = round(start_ms * 1e6), round(end_ms * 1e6)
    return s


def _setup_spans():
    return [_span("setup.model", 9001, 0, 800),
            _span("setup.warmup", 9002, 900, 2400)]


def pinned_serve():
    """A traced UNet serving record at the paper's widths and its spans:
    the batches and alignment of the span readers' planted run, and one
    profiled batch of 2 forwards at 40 real views in 48 slots."""
    record, spans = span_tests._served()
    for s in spans:                     # batch 1 graphed, batch 2 not
        if s.name == "unet.forward" and s.key in (1, 2):
            s.attrs["graphed"] = s.key == 1
    ops = [("gn_fwd_kernel", 0.0, 1.31e-3), ("attn_fwd_bf16", 1.4e-3,
                                             1.52e-3),
           ("conv", 1.6e-3, 7.2e-3), ("gn_fwd_kernel", 7.3e-3, 8.62e-3),
           ("attn_fwd_bf16", 8.7e-3, 8.82e-3), ("conv", 8.9e-3, 14.5e-3),
           ("Memcpy DtoH", 14.6e-3, 14.7e-3)]
    record.update(
        widths=WIDTHS["unet-paper-64"], dtype="bfloat16", batch_size=8,
        n_max=6, batch_log=[(2, "ddim", 2, 0.0162), (2, "ddim", 1, 0.0184),
                            (2, "ddim", 1, 0.0176)],
        real_views=[3, 5, 40], unprofiled_batch_s=[0.0162, 0.0184],
        busy_s=0.0124, forwards_profiled=2,
        profiled_batches=[{"index": 2, "real_views": 40, "ops": ops}])
    return record, spans + _setup_spans()


def pinned_train(denoiser):
    """A traced one-card training record of the family's configuration
    and the span readers' planted steps: 3 in the window, 2 profiled."""
    record, spans = span_tests._trained()
    cfg = "unet-paper-64" if denoiser == "unet" else "dit-s4-64"
    rows = 280 if denoiser == "unet" else 98
    ops = [("conv", 0.0, 0.08), ("gn_bwd_kernel", 0.08, 0.091),
           ("attn_fwd_bf16", 0.091, 0.0922), ("conv", 0.1, 0.18),
           ("gn_bwd_kernel", 0.18, 0.191), ("attn_fwd_bf16", 0.191, 0.1922)]
    record.update(denoiser=denoiser, widths=WIDTHS[cfg], rows=rows,
                  rank_rows=rows, chips=1, dtype="bfloat16",
                  window_elapsed_s=0.39, device_ops=ops, busy_s=0.1844)
    return record, spans + _setup_spans()


METRICS = sorted(p.stem for p in (_tiny.BENCH / "metrics").glob("*.py")
                 if not p.name.startswith("_"))
# What each reader read on these records before the family lookup (every
# reader not listed reads None), save three: K1's and K3's serving shares
# now count the 48 rows a forward runs where they counted the batch's 40
# real views (x 48 / 40), and K3's training share reads the UNet, where
# it was gated to the DiT.
PINNED = {
    "serve": {
        "device.idle_in_unet_pct.serve": 44.736842105263776,
        "device.idle_pct.serve": 18.09248554913294,
        "k1.roofline_pct.serve": 40.20724580897793,   # was 33.50650501106636
        "k3.roofline_pct.serve": 43.527641791044694,  # was 36.27303482587059
        "mfu_pct.serve": 0.9815971102240251,
        "sampler.self_ms_per_step.serve": 1.0,
        "serve.batch_fill": 1.3333333333333333,
        "serve.batch_ms": 17.3,
        "serve.codec_ms": 4.0,
        "serve.padded_rows_pct": 91.66666666666667,
        "serve.queue_wait_ms": 30.0,
        "setup.program_s": 2.3,
        "unet.device_ms_per_fwd.serve": 7.085,
        "unet.graph_hit_pct.serve": 50.0,
        "unet.host_ms_per_fwd.serve": 2.5,
    },
    "train-unet": {
        "device.idle_pct.train": 29.076923076923077,
        "k2.roofline_pct.train": 42.04872180189958,
        "k3.roofline_pct.train": 25.39112437810931,   # was None
        "mfu_pct.train": 13.715931928630317,
        "setup.program_s": 2.3,
        "train.device_ms_per_step": 92.2,
        "train.h2d_ms": 3.0,
        "train.host_ms_per_step": 7.0,
    },
    "train-dit": {
        "device.idle_pct.train": 29.076923076923077,
        "k3.roofline_pct.train": 28.757588059701334,
        "mfu_pct.train": 2.77639336529517,
        "setup.program_s": 2.3,
        "train.device_ms_per_step": 92.2,
        "train.h2d_ms": 3.0,
        "train.host_ms_per_step": 7.0,
    },
}


@pytest.mark.parametrize("kind", sorted(PINNED))
def test_readers_on_fixed_records(monkeypatch, kind):
    record, spans = (pinned_serve() if kind == "serve"
                     else pinned_train(kind.split("-")[1]))
    monkeypatch.setattr(_spans, "program_spans", lambda: spans)
    got = {m: harness._module(_tiny.BENCH / "metrics" / f"{m}.py",
                              "pinned_" + m.replace(".", "_")).read(record)
           for m in METRICS}
    want = {m: PINNED[kind].get(m) for m in METRICS}
    assert {m for m, v in got.items() if v is None} == \
        {m for m, v in want.items() if v is None}
    for m, v in want.items():
        if v is not None:
            assert got[m] == pytest.approx(v, rel=1e-12), m
