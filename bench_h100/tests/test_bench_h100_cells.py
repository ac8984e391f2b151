"""The harness is driven by data: a cell, a configuration and its YAML
that only this test writes are found by name and run through the
drivers, and no file that was there changes.  Run on the CPU at tiny
sizes in float32, the program agrees with the reference to rounding."""

import pytest

from bench_h100.tests import _tiny


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
