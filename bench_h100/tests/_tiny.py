"""A copy of the benchmark's folder with tiny configurations and cells
that only the tests write, run on the CPU with the program's plain
kernel versions."""

from __future__ import annotations

import hashlib
import json
import shutil
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]

TINY_UNET = {"image_size": 16, "in_channel": 6, "out_channel": 6,
             "inner_channel": 8, "norm_groups": 4, "res_blocks": 1,
             "attn_res": [8], "channel_mults": [1, 2]}
TINY_DIT = {"image_size": 16, "in_channel": 6, "out_channel": 6,
            "patch_size": 4, "hidden_size": 32, "depth": 2, "num_heads": 2}


def tree_hashes(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def copy_bench(dest: Path) -> Path:
    root = dest / "bench_h100"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    manifest = BENCH.parent / "BENCHMARK.json"
    if manifest.is_file():
        shutil.copy(manifest, dest)
    return root


def _yaml(root: Path, denoiser: str, dtype: str) -> str:
    if denoiser == "unet":
        y = (root / "configs" / "unet-paper-64.yaml").read_text()
        return (y.replace("image_size: 64", "image_size: 16")
                .replace("inner_channel: 64", "inner_channel: 8\n"
                         "    norm_groups: 4")
                .replace("res_blocks: 3", "res_blocks: 1")
                .replace("- 16\n", "- 8\n").replace("    - 3\n    - 5\n", "")
                .replace("compute_dtype: bfloat16", f"compute_dtype: {dtype}"))
    y = (root / "configs" / "dit-s4-64.yaml").read_text()
    return (y.replace("hidden_size: 384", "hidden_size: 32")
            .replace("depth: 12", "depth: 2")
            .replace("num_heads: 6", "num_heads: 2")
            .replace("image_size: 64", "image_size: 16")
            .replace("compute_dtype: bfloat16", f"compute_dtype: {dtype}"))


def add_tiny_cell(root: Path, name: str, base: str, dtype: str = "float32",
                  config: str = None, **traffic) -> str:
    """Write configs/<name>-cfg.{json,yaml} and workloads/<name>.json,
    cut from the cell ``base`` (and from the configuration ``config``
    where given, else the cell's own); returns the cell's name."""
    wl = json.loads((root / "workloads" / f"{base}.json").read_text())
    cfg = json.loads((root / "configs" / f"{config or wl['config']}.json")
                     .read_text())
    den = cfg["denoiser"]
    cfg.update(name=f"{name}-cfg", yaml=f"{name}-cfg.yaml",
               widths=TINY_UNET if den == "unet" else TINY_DIT,
               compute_dtype=dtype)
    (root / "configs" / f"{name}-cfg.json").write_text(json.dumps(cfg))
    (root / "configs" / f"{name}-cfg.yaml").write_text(_yaml(root, den,
                                                             dtype))
    wl["config"] = f"{name}-cfg"
    wl["traffic"].update(traffic)
    (root / "workloads" / f"{name}.json").write_text(json.dumps(wl))
    return name


def run_cell(root: Path, name: str, seed: int = 3000000001,
             seconds: float = 2.0, trace: int = 0) -> dict:
    from bench_h100 import run

    return run.main(["--workload", name, "--seed", str(seed), "--seconds",
                     str(seconds), "--trace", str(trace)], root=root,
                    device="cpu", t0=time.monotonic())


SERVE_TINY = dict(rate=4.0, steps=5, check_requests=4, drain_s=20.0)
TRAIN_TINY = dict(batch=4, cycle=4)


def plant(fault: str):
    """Break the program's timed path in one way; returns the undo."""
    from viewfusion_tpu_torch.models.view_fusion import ViewFusion
    from viewfusion_tpu_torch.training import trainer as trainer_mod

    saved = []

    def patch(obj, name, value):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    if fault == "answer_altered":          # the sampler's output shifted
        orig = ViewFusion.generate_ddim
        patch(ViewFusion, "generate_ddim",
              lambda self, *a, **kw: orig(self, *a, **kw) + 0.1)
    elif fault == "step_unchanged":        # a step keeps its state
        patch(ViewFusion, "_x0", lambda self, y, eps, t: y.clamp(-1.0, 1.0))
    elif fault == "no_update":             # the optimizer step skipped
        def skipped(self):
            self.step += 1
        patch(trainer_mod.Trainer, "apply_update", skipped)
    elif fault == "half_batch":            # the loss over half the samples
        orig_loss = ViewFusion.loss_packed

        def half(self, y_0, y_cond, view_count, angle, sample_idx, view_idx,
                 **kw):
            h = y_0.shape[0] // 2
            keep = sample_idx < h
            for k in ("noise", "sample_gammas"):
                if kw.get(k) is not None:
                    kw[k] = kw[k][:h]
            return orig_loss(self, y_0[:h], y_cond[:h], view_count[:h],
                             angle[:h], sample_idx[keep], view_idx[keep],
                             **kw)
        patch(ViewFusion, "loss_packed", half)
    elif fault == "no_exchange":           # DDP without its all-reduce
        patch(trainer_mod, "DistributedDataParallel",
              lambda module, **kw: module)
    elif fault:
        raise ValueError(f"unknown fault {fault!r}")

    def undo():
        for obj, name, value in reversed(saved):
            setattr(obj, name, value)
    return undo
