"""``correct`` comes out false when the timed path is broken underneath:
the rest of a run is driven on the CPU at a tiny size in float32 (where
the program reads ~0 against the reference) and held to the cell's own
limits, with one fault planted in the program at a time.

Serving: an answer altered where it is produced (the sampler's output
shifted), and a sampler step that returns its state unchanged (the clean
prediction taken as the state itself, whatever the UNet says).
Training: a step that leaves the state unchanged (no update), and half
of the batch left out (the loss over the first half of the samples);
on more than one rank also the gradients' exchange left out (DDP without
its all-reduce), driven by two gloo ranks."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from bench_h100.tests import _tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = _tiny.copy_bench(tmp_path_factory.mktemp("faults"))
    _tiny.add_tiny_cell(root, "serve", "unet-serve-ddim50",
                        **_tiny.SERVE_TINY)
    _tiny.add_tiny_cell(root, "unet", "unet-train-b80", **_tiny.TRAIN_TINY)
    _tiny.add_tiny_cell(root, "dit", "dit-train-b28", **_tiny.TRAIN_TINY)
    return root


@pytest.mark.parametrize("cell,fault", [
    ("serve", "answer_altered"), ("serve", "step_unchanged"),
    ("unet", "no_update"), ("unet", "half_batch"),
    ("dit", "no_update"), ("dit", "half_batch")])
def test_fault_is_not_correct(root, cell, fault):
    undo = _tiny.plant(fault)
    try:
        line = _tiny.run_cell(root, cell,
                              seconds=2.0 if cell == "serve" else 0.5)
    finally:
        undo()
    assert line["correct"] is False
    failed = [k for k, c in line["checks"].items()
              if c["value"] > c["limit"]]
    assert failed


@pytest.mark.parametrize("cell", ["serve", "unet", "dit"])
def test_unbroken_run_is_correct(root, cell):
    line = _tiny.run_cell(root, cell, seconds=2.0 if cell == "serve" else 0.5)
    assert line["correct"] is True


@pytest.fixture(scope="module")
def ranks_root(tmp_path_factory):
    """The UNet training cell at a tiny size on two ranks."""
    root = _tiny.copy_bench(tmp_path_factory.mktemp("ranks"))
    name = _tiny.add_tiny_cell(root, "ranks", "unet-train-b80",
                               **_tiny.TRAIN_TINY)
    path = root / "workloads" / f"{name}.json"
    path.write_text(path.read_text().replace('"chips": 1', '"chips": 2'))
    return root


@pytest.mark.parametrize("fault", ["", "no_update", "half_batch",
                                   "no_exchange"])
def test_ranks_fault_is_not_correct(ranks_root, tmp_path, fault):
    """Two gloo ranks drive the multi-card path; each fault of it (no
    update, half the batch, the gradients' exchange left out) reads as
    not correct, and the unbroken run as correct."""
    result = tmp_path / "result.json"
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", str(Path(_tiny.__file__).parent
                                      / "_rank_main.py"),
         str(ranks_root), "ranks", str(result), fault],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(result.read_text())
    assert line["device"]["count"] == 2
    assert line["correct"] is (fault == "")
