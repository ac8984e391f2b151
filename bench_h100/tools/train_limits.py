"""The readings a training cell's limits are set from.  For each seed:
the program's first updates (as a run's set-up makes them) against the
float32 reference; on the first ``--control-seeds`` seeds also the
control (the reference with every product operand rounded to fp8 e4m3,
the step below the configuration's bf16) and a planted fault (each step's
loss over half of its samples) against the float32 reference.  Prints
one JSON line per seed and appends it to ``chiprun_out/train_limits.jsonl``.

    python3 bench_h100/tools/train_limits.py --workload unet-train-b80 \
        --seeds 201,202,203 --control-seeds 3
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(CHECKOUT))

from bench_h100 import harness  # noqa: E402
from bench_h100.reference import precision  # noqa: E402

NAMES = ("loss_gap", "grad_norm_gap", "change_norm_gap")


def main(argv=None) -> None:
    import torch

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--device", default="cuda")
    p.add_argument("--reference-only", action="store_true",
                   help="read the control and the faults alone (for a "
                        "multi-card cell: the program's readings come from "
                        "its runs), at the global batch on one card")
    args = p.parse_args(argv)
    args.ranks = int(harness.Cell(args.workload).workload["chips"])
    cell = harness.Cell(args.workload)
    drv = cell.driver()
    n_check = int(cell.workload["traffic"]["check_steps"])
    out_dir = CHECKOUT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t = time.monotonic()
        tr = cell.workload["traffic"]
        cfg = cell.config
        if args.reference_only:
            mod = cell.reference()
            params = harness.make_params(mod.param_specs(cfg["widths"]),
                                         harness.sub_seed(seed, 2),
                                         args.device)
            batches = drv.make_batches(seed, n_check,
                                       int(tr["batch"]) * args.ranks,
                                       cfg["max_views"],
                                       cfg["widths"]["image_size"])
            gen_seed = harness.sub_seed(seed, 4)
        else:
            prog = drv.Program(cell, seed, args.device)
            side = prog.first_steps(n_check)
            params, batches, gen_seed = (prog.params, prog.batches,
                                         prog.gen_seed)
            del prog
            gc.collect()
            if args.device == "cuda":
                torch.cuda.empty_cache()
        ref = drv.reference_steps(cell, params, batches, gen_seed, n_check,
                                  args.device)
        row = {"seed": seed, "ref_losses": ref[0]}
        if not args.reference_only:
            row.update(losses=side[0],
                       program=dict(zip(NAMES, drv.gaps(side, ref))))
        if k < args.control_seeds:
            ctl = drv.reference_steps(cell, params, batches, gen_seed,
                                      n_check, args.device,
                                      precision.Precision("fp8"))
            row["fp8"] = dict(zip(NAMES, drv.gaps(ctl, ref)))
            faults = ["half_batch"] + ([f"no_exchange:{args.ranks}"]
                                       if args.ranks > 1 else [])
            for fault in faults:
                got = drv.reference_steps(cell, params, batches, gen_seed,
                                          n_check, args.device, fault=fault)
                row[fault] = dict(zip(NAMES, drv.gaps(got, ref)))
        row["seconds"] = time.monotonic() - t
        line = json.dumps(row)
        print(line, flush=True)
        with open(out_dir / "train_limits.jsonl", "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
