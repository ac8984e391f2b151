"""The ADM family of the benchmark (``configs/adm-imagenet-64.json``,
``reference/adm.py``, ``work/adm.py``, the cell ``adm-train-b32``): its
work counts at the published widths, its reference against the tier-1
tests' copy, a tiny ADM cell run through the training driver on the
CPU, and the reader it brought (``k1.roofline_pct.train``) on a fixed
record."""

import importlib.util
import json
import math
from pathlib import Path

import pytest
import torch

from bench_h100 import harness
from bench_h100.tests import _tiny
from bench_h100.work import kernels

CHECKOUT = _tiny.BENCH.parent
ADM = harness.load_json(_tiny.BENCH / "configs" / "adm-imagenet-64.json")
WIDTHS = ADM["widths"]
TINY = {"image_size": 16, "in_channel": 6, "out_channel": 6,
        "model_channels": 32, "channel_mult": [1, 2], "num_res_blocks": 1,
        "attention_resolutions": [8], "num_head_channels": 16}


def _work():
    return harness.family_module("work", "adm")


def _reader(name):
    return harness._module(_tiny.BENCH / "metrics" / f"{name}.py",
                           "adm_reader_" + name.replace(".", "_")).read


def test_work_counts_at_the_published_widths():
    """295.1 M parameters, 219.4 GFLOP a row, 95 GroupNorm sites (36 of
    them AdaGN), 22 attention sites of heads of 64."""
    ref = harness.family_module("reference", "adm")
    n = sum(math.prod(s) for _, s, _ in ref.param_specs(WIDTHS))
    assert n == 295_141_638
    work = _work()
    assert work.flops_per_row(WIDTHS) == pytest.approx(219.398504448e9,
                                                       rel=1e-12)
    sites = work.groupnorm_sites(WIDTHS)
    assert sum(sites.values()) == 95
    assert sum(n for (_, _, act), n in sites.items() if act == "none") == 22
    # 36 ResBlocks' first norms, their 36 AdaGNs and the output's norm
    assert sum(n for (_, _, act), n in sites.items() if act == "silu") == 73
    assert work.attention_sites(WIDTHS) == {(1024, 64, 6): 7,
                                            (256, 64, 9): 7,
                                            (64, 64, 12): 8}


def test_reference_agrees_with_the_tier1_copy():
    """``reference/adm.py`` (recomputing each block in the backward) and
    ``tests/adm_reference.py`` give the same output and gradients."""
    spec = importlib.util.spec_from_file_location(
        "tier1_adm_reference", CHECKOUT / "tests" / "adm_reference.py")
    tier1 = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tier1)
    ref = harness.family_module("reference", "adm")
    assert ref.param_specs(TINY) == tier1.param_specs(TINY)
    params = harness.make_params(ref.param_specs(TINY), 21, "cpu")
    g = torch.Generator().manual_seed(22)
    x = torch.randn((3, 16, 16, 6), generator=g)
    angle, level = torch.rand(3, generator=g) * 6, torch.rand(3, generator=g)
    outs = []
    for fwd in (ref.forward, tier1.forward):
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        y = fwd(p, TINY, x, angle, level)
        y.square().mean().backward()
        outs.append((y.detach(), {k: v.grad for k, v in p.items()}))
    (y0, g0), (y1, g1) = outs
    assert (y0 - y1).abs().max().item() <= 1e-6 * y1.abs().max().item()
    top = max(v.abs().max().item() for v in g1.values())
    for k in g1:
        assert (g0[k] - g1[k]).abs().max().item() <= 1e-5 * top, k


def _tiny_adm_cell(root: Path) -> str:
    cfg = json.loads((root / "configs" / "adm-imagenet-64.json").read_text())
    cfg.update(name="test-adm-cfg", yaml="test-adm-cfg.yaml", widths=TINY,
               compute_dtype="float32")
    (root / "configs" / "test-adm-cfg.json").write_text(json.dumps(cfg))
    y = (root / "configs" / "adm-imagenet-64.yaml").read_text()
    y = (y.replace("image_size: 64", "image_size: 16")
         .replace("model_channels: 192", "model_channels: 32")
         .replace("    - 1\n    - 2\n    - 3\n    - 4\n",
                  "    - 1\n    - 2\n")
         .replace("num_res_blocks: 3", "num_res_blocks: 1")
         .replace("    - 32\n    - 16\n    - 8\n", "    - 8\n")
         .replace("num_head_channels: 64", "num_head_channels: 16")
         .replace("compute_dtype: bfloat16", "compute_dtype: float32"))
    (root / "configs" / "test-adm-cfg.yaml").write_text(y)
    wl = json.loads((root / "workloads" / "adm-train-b32.json").read_text())
    wl["config"] = "test-adm-cfg"
    wl["traffic"].update(_tiny.TRAIN_TINY)
    # the published cell reads the loss without a limit; here f32 on both
    # sides, so the loss is compared too
    wl["limits"]["loss_gap"] = 1e-5
    (root / "workloads" / "test-adm.json").write_text(json.dumps(wl))
    return "test-adm"


def test_tiny_adm_cell_runs_through_the_training_driver(tmp_path):
    """A tiny ADM cell, found by its configuration's ``denoiser``, runs
    ``train_steps`` on the CPU in float32: the program follows the
    reference to rounding, and no file that was there changes."""
    root = _tiny.copy_bench(tmp_path)
    before = _tiny.tree_hashes(root)
    name = _tiny_adm_cell(root)
    line = _tiny.run_cell(root, name, seconds=1.0)
    after = _tiny.tree_hashes(root)
    assert {k: after.get(k) for k in before} == before
    assert line["correct"] is True
    checks = line["checks"]
    assert checks["loss_gap"]["value"] < 1e-5
    assert checks["grad_norm_gap"]["value"] < 1e-4
    assert checks["change_norm_gap"]["value"] < 1e-2
    assert line["attempted"] > 0 and line["failed"] == 0


def _train_record():
    """A traced ADM training record: 112 rows, 5 steps profiled, K1 at
    12.5 ms a step."""
    ops = [("gn_fwd_kernel<bf16>", 0.1 * i, 0.1 * i + 0.0125)
           for i in range(5)] + [("conv", 0.02, 0.09)]
    return {"kind": "train", "denoiser": "adm", "widths": WIDTHS,
            "rows": 112, "rank_rows": 112, "chips": 1, "dtype": "bfloat16",
            "profile_steps": 5, "window_steps": 3, "device_ops": ops,
            "busy_s": 0.3}


def test_k1_training_roofline_on_a_fixed_record():
    record = _train_record()
    bound = kernels.groupnorm_bound_s(_work().groupnorm_sites(WIDTHS), 112,
                                      "bfloat16")
    got = _reader("k1.roofline_pct.train")(record)
    assert got == pytest.approx(100.0 * bound / 0.0125, rel=1e-12)
    assert 30.0 < got < 60.0
    assert _reader("k1.roofline_pct.train")(dict(record, device_ops=[
        ("conv", 0.0, 1.0)])) is None
    assert _reader("k1.roofline_pct.train")(dict(record, kind="serve")) \
        is None
