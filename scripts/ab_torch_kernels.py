#!/usr/bin/env python3
"""Time the kernels K1-K4 of checkouts of the PyTorch/CUDA port at the paper
UNet's sites, on one NVIDIA GPU.

    python3 scripts/ab_torch_kernels.py --tree DIR [--tree DIR ...]

For each DIR, in the order given and each in its own process, runs that
checkout's own chip_smoke.py phase 3 (K1 GroupNorm(+SiLU) at every
GroupNorm site at 48 rows), phase 4 (K3 at every attention site at 48
rows), phase 8 (K2, the GroupNorm(+SiLU) backward, at every GroupNorm
site at R = 98 rows) and phase 12 (K4 at every stride-1 3x3 conv site at
R = 98 rows): the checks against the plain versions, the per-site lines,
and one JSON line with the per-forward (K1, K3) and per-step (K2, K4)
totals.  Each checkout builds its kernels into its own
viewfusion_tpu_torch/_build.

To compare a parent commit with a change on one card, unpack the parent
into a git-ignored directory and run the trees in turns:

    git archive HEAD~1 | (mkdir -p _verify/parent && tar -x -C _verify/parent)
    python3 scripts/ab_torch_kernels.py --tree _verify/parent --tree . \\
        --tree . --tree _verify/parent
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def run_one(tree: str) -> int:
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available: this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(tree))
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    cs._native.library()
    unet = cs.paper_unet(device)
    gn_sites, attn_sites = cs.sites(unet, cs.ROWS, device)
    conv_sites = cs.conv_sites(unet, cs.TRAIN_ROWS, device)
    groups = unet.config.norm_groups
    del unet
    torch.cuda.empty_cache()
    k1 = cs.check_group_norm(gn_sites, groups, device)
    k3 = cs.check_attention(attn_sites, device)
    k2 = cs.check_group_norm_backward(gn_sites, groups, device)
    torch.cuda.empty_cache()
    k4 = cs.check_conv_wgrad(conv_sites, device)
    print(json.dumps({"tree": tree, "card": cs.card_line(),
                      "k1_per_forward": k1, "k2_per_step": k2,
                      "k3_per_forward": k3, "k4_per_step": k4}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="root of a checkout of the port (repeatable)")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        return run_one(args.tree[0])
    for tree in args.tree:
        print(f"== {tree}", flush=True)
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--one", "--tree", tree]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
