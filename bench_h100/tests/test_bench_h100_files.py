"""Every file of the benchmark loads, and BENCHMARK.json keeps to the
benchmark's contract: names and units in the allowed characters, each
cell's files found by name, each per-layer metric a reader of its own."""

import json
import re
from pathlib import Path

import pytest

from bench_h100 import harness

BENCH = Path(harness.__file__).resolve().parent
MANIFEST = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_manifest_keys_and_command():
    assert list(MANIFEST) == ["command", "paths", "run_seconds", "configs",
                              "workloads", "end_to_end", "per_layer"]
    assert MANIFEST["command"] == ["python3", "bench_h100/run.py"]
    assert MANIFEST["paths"] == ["bench_h100"]
    assert 1 <= MANIFEST["run_seconds"] <= 51


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_units(kind):
    entries = MANIFEST[kind]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
            assert e["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
        for key in ("why", "layer", "source"):
            if key in e and kind in ("configs", "workloads", "per_layer"):
                assert LINE.match(str(e[key])), (key, e[key])


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_files_found_by_name(cell):
    entry = next(w for w in MANIFEST["workloads"] if w["name"] == cell)
    c = harness.Cell(cell)
    assert c.workload["config"] == entry["config"]
    assert c.workload["chips"] == entry["chips"]
    assert c.workload["why"] == entry["why"]
    assert c.yaml_path.is_file()
    assert c.driver().run
    e2e, per_layer = harness.manifest_metrics(MANIFEST, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert per_layer
    for m in per_layer:
        assert callable(c.metric(m["name"]).read)
        moves = m["moves"]
        assert moves in names


@pytest.mark.parametrize("config", [c["name"] for c in MANIFEST["configs"]])
def test_config_files(config):
    entry = next(c for c in MANIFEST["configs"] if c["name"] == config)
    body = json.loads((BENCH.parent / entry["file"]).read_text())
    assert body["name"] == config
    assert body["source"] == entry["source"]
    assert body["reduced"] == entry["reduced"]
    assert (BENCH / "configs" / body["yaml"]).is_file()


def test_every_metric_file_reads_nothing_from_an_empty_record():
    for path in sorted((BENCH / "metrics").glob("*.py")):
        if path.name.startswith("_"):
            continue
        mod = harness._module(path, "metric_" + path.stem.replace(".", "_"))
        assert mod.read({}) is None, path.name
