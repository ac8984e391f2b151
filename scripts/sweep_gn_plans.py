#!/usr/bin/env python3
"""Time K1 and K2 (GroupNorm(+SiLU) forward and backward) under every
cluster size their plan could choose, at the paper UNet's GroupNorm sites,
on one NVIDIA GPU.

    python3 scripts/sweep_gn_plans.py

For K1 at 48 and 28 rows and K2 at R = 98 rows (bf16, SiLU), at each
site: the kernel's time under the plan ``group_norm_plan`` chooses, and
under each cluster of 1-16 blocks with the rows staged in half an SM's
shared memory ("h") or in all of a block's ("f"; rows that do not fit
are read from device memory), each as staged/rows-per-block rows and
clusters the card holds at once; then per-forward (per-step) totals of
the chosen plans, of the fastest plan per site, and of the byte bound.
Device times as chip_smoke.py takes them (CUDA graph replay).
"""

from __future__ import annotations

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from viewfusion_tpu_torch.ops import groupnorm as gn  # noqa: E402

GROUPS = 32


def sweep(name: str, rows: int, backward: bool, sites, device) -> None:
    n_tensors = 2 if backward else 1
    totals = dict.fromkeys(("plan", "best", "bound"), 0.0)
    for (l, c), count in sorted(sites.items()):
        g = torch.Generator(device=device).manual_seed(cs.SEED)
        x = torch.randn((rows, l, c), generator=g, device=device).bfloat16()
        gy = torch.randn((rows, l, c), generator=g, device=device).bfloat16()
        scale = torch.randn((c,), generator=g, device=device) * 0.5 + 1.0
        bias = torch.randn((c,), generator=g, device=device) * 0.5
        _, mean, rstd = gn.group_norm_act_reference(x, scale, bias,
                                                    groups=GROUPS, act="silu")
        if backward:
            def fn():
                return gn.group_norm_act_backward(
                    x, gy, scale, bias, mean, rstd, groups=GROUPS, act="silu")
        else:
            def fn():
                return gn.group_norm_act(x, scale, bias, groups=GROUPS,
                                         act="silu")
        bound = (n_tensors + 1) * x.numel() * 2 / cs.HBM_BYTES_PER_S * 1e3
        chosen = gn.group_norm_plan(rows, l, c, 2, n_tensors,
                                    cs._native.sm_count(device))
        plan_for, results = gn._plan_for, []
        for cluster in (1, 2, 4, 8, 16):
            if cluster > 2 * l:
                continue
            for cap, tag in ((gn._TWO_BLOCKS, "h"), (gn._SMEM_BYTES, "f")):
                plan = gn._plan_layout(l, c, 2, n_tensors, 8, cluster, cap)
                if tag == "f" and plan == gn._plan_layout(
                        l, c, 2, n_tensors, 8, cluster, gn._TWO_BLOCKS):
                    continue
                active = gn.group_norm_active_clusters(plan, torch.bfloat16,
                                                       backward=backward)
                if active < 1:
                    continue
                gn._plan_for = lambda *args, plan=plan: plan
                try:
                    ms = cs.device_ms(fn)
                finally:
                    gn._plan_for = plan_for
                results.append((ms, f"cl{cluster}{tag}({plan.rows_staged}/"
                                    f"{plan.rows_per_block},{active})"))
        ms = cs.device_ms(fn)
        best = min(results)
        totals["plan"] += count * ms
        totals["best"] += count * best[0]
        totals["bound"] += count * bound
        cs.say(f"{name} {rows}x{l}x{c} x{count}: plan cl{chosen.cluster} "
               f"{chosen.rows_staged}/{chosen.rows_per_block} "
               f"{ms * 1e3:.1f} us, fastest {best[1]} {best[0] * 1e3:.1f} "
               f"us, bound {bound * 1e3:.1f} us | "
               + " ".join(f"{label}:{t * 1e3:.1f}" for t, label in results))
    cs.say(f"== {name} at {rows} rows: plan {totals['plan']:.4f} ms, fastest "
           f"per site {totals['best']:.4f} ms, bound {totals['bound']:.4f} ms")


def main() -> int:
    if not torch.cuda.is_available():
        print("CUDA is not available: this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    device = torch.device("cuda")
    cs._native.library()
    cs.say(cs.card_line())
    unet = cs.paper_unet(device)
    gn_sites, _ = cs.sites(unet, cs.ROWS, device)
    del unet
    torch.cuda.empty_cache()
    sites = {}
    for (l, c, _), count in gn_sites.items():  # both acts, timed with SiLU
        sites[l, c] = sites.get((l, c), 0) + count
    sweep("K1", cs.ROWS, False, sites, device)
    sweep("K1", 28, False, sites, device)
    sweep("K2", cs.TRAIN_ROWS, True, sites, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
