"""What every driver shares: finding a cell's files by name, the seeded
weights, the device's description and the result line.

A cell is ``workloads/<name>.json``; it names its configuration
(``configs/<config>.json``, with the YAML the program reads beside it)
and its driver (``drivers/<driver>.py``).  The configuration's
``denoiser`` names its model family: the plain reference
``reference/<denoiser>.py`` and the work counts ``work/<denoiser>.py``
(README.md gives what each must define).  A per-layer metric is
``metrics/<metric>.py``.  ``BENCHMARK.json`` at the checkout's root says
which metrics each cell reports."""

from __future__ import annotations

import importlib.util
import json
import math
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "viewfusion_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"no such file: {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def family_module(part: str, denoiser: str, root: Path = HERE):
    """A model family's ``<part>/<denoiser>.py`` under ``root``, where
    ``part`` is ``reference`` or ``work``; FileNotFoundError, naming the
    path, where the family has no such file."""
    return _module(root / part / f"{denoiser}.py",
                   f"bench_{part}_{denoiser}")


@dataclass
class Cell:
    """A cell's files, found by name under ``root`` (this directory)."""

    name: str
    root: Path = HERE
    workload: dict = field(init=False)
    config: dict = field(init=False)

    def __post_init__(self):
        self.workload = load_json(self.root / "workloads"
                                  / f"{self.name}.json")
        self.config = load_json(
            self.root / "configs" / f"{self.workload['config']}.json")

    @property
    def yaml_path(self) -> Path:
        return self.root / "configs" / self.config["yaml"]

    def driver(self):
        d = self.workload["driver"]
        return _module(self.root / "drivers" / f"{d}.py", f"bench_driver_{d}")

    def metric(self, name: str):
        return _module(self.root / "metrics" / f"{name}.py",
                       "bench_metric_" + name.replace(".", "_"))

    def reference(self):
        """The configuration's plain reference: ``param_specs(widths)``
        and ``forward(params, widths, x, angle, level, prec)``."""
        return family_module("reference", self.config["denoiser"], self.root)

    def work(self):
        """The configuration's work counts: ``flops_per_row(widths)``."""
        return family_module("work", self.config["denoiser"], self.root)


def manifest_metrics(manifest: dict, cell: str):
    """(end-to-end, per-layer) metric entries of ``BENCHMARK.json`` that
    ``cell`` reports: those without ``workloads`` and those listing it."""
    pick = (lambda ms: [m for m in ms
                        if cell in m.get("workloads", [cell])])
    return pick(manifest.get("end_to_end", [])), \
        pick(manifest.get("per_layer", []))


def check_widths(config, widths: dict, path) -> None:
    """The YAML the program read has the widths the cell's configuration
    states (a frozen copy can only drift by an edit)."""
    for k, v in widths.items():
        got = getattr(config.denoiser, k)
        if (list(got) if isinstance(got, tuple) else got) != v:
            raise ValueError(f"{path}: {k} = {got}, the cell's "
                             f"configuration says {v}")


def forbidden_modules() -> List[str]:
    """Loaded modules of JAX or the JAX package, by whole top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def make_params(specs, seed: int, device):
    """Seeded float32 parameters ``{name: tensor}`` from one draw on the
    device: kernels N(0, 1/fan_in), GroupNorm scales 1 + N(0, 0.02^2),
    biases and the adaLN-Zero layers N(0, 0.02^2)."""
    import torch

    total = sum(math.prod(shape) for _, shape, _ in specs)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    flat = torch.randn(total, generator=g, device=device)
    params, off = {}, 0
    with torch.no_grad():
        for name, shape, kind in specs:
            n = math.prod(shape)
            v = flat[off:off + n].view(shape)
            off += n
            if kind == "kernel":
                v.mul_(1.0 / math.sqrt(math.prod(shape[1:])))
            elif kind == "norm":
                v.mul_(0.02).add_(1.0)
            else:                      # "bias", "zero_init"
                v.mul_(0.02)
            params[name] = v
    return params


def sub_seed(seed: int, *salt: int) -> int:
    """A 63-bit seed drawn from (seed, salt...)."""
    import numpy as np

    return int(np.random.SeedSequence([int(seed) % (2 ** 64), *salt])
               .generate_state(2, np.uint64)[0] >> 1)


def percentile(values, q: float) -> float:
    """The q-th percentile by the nearest rank over ``values`` (inf for a
    request with no reply)."""
    vals = sorted(values)
    if not vals:
        return math.inf
    k = max(0, math.ceil(q / 100.0 * len(vals)) - 1)
    return vals[k]


@dataclass
class Outcome:
    """What a driver hands back to ``run.py``."""

    correct: bool
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    record: Dict[str, Any]             # what per-layer readers read
    checks: List[tuple]                # (name, value, limit)
    memory_peak_bytes: int
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    breakdown: Optional[dict] = None
    notes: List[str] = field(default_factory=list)


def card_description() -> str:
    """The card's name and power limit from nvidia-smi, or its name."""
    import subprocess

    import torch

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0)
