"""No module of the benchmark pulls in JAX or the JAX package (compared
by whole top-level names: ``viewfusion_tpu_torch`` begins with
``viewfusion_tpu``), and the reference imports nothing of the program."""

import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
MODULES = sorted(
    "bench_h100." + ".".join(p.relative_to(BENCH).with_suffix("").parts)
    for p in BENCH.rglob("*.py")
    if "tests" not in p.parts and "metrics" not in p.parts
    and p.name != "__init__.py")
PROBE = """
import importlib, sys
for name in sys.argv[2:]:
    importlib.import_module(name)
top = {m.split('.')[0] for m in sys.modules}
bad = sorted(top & set(sys.argv[1].split(',')))
print(','.join(bad))
"""


def _loaded(names, forbidden):
    out = subprocess.run([sys.executable, "-c", PROBE, ",".join(forbidden),
                          *names], capture_output=True, text=True,
                         cwd=BENCH.parent, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


@pytest.mark.parametrize("name", MODULES)
def test_no_jax(name):
    assert _loaded([name], ["jax", "jaxlib", "flax", "viewfusion_tpu"]) == ""


def test_reference_imports_nothing_of_the_program():
    refs = [m for m in MODULES if m.startswith("bench_h100.reference.")]
    assert len(refs) >= 5
    assert _loaded(refs, ["viewfusion_tpu_torch", "jax",
                          "viewfusion_tpu"]) == ""


def test_load_generator_imports_neither_torch_nor_the_program():
    assert _loaded(["bench_h100.traffic.loadgen"],
                   ["torch", "numpy", "viewfusion_tpu_torch"]) == ""


def test_run_refuses_without_a_card():
    out = subprocess.run([sys.executable, "bench_h100/run.py", "--workload",
                          "unet-serve-ddim50", "--seed", "1", "--seconds",
                          "1"], capture_output=True, text=True,
                         cwd=BENCH.parent, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
