"""Run chip_smoke.py's multi-process phases (23-24) and its dropout step
alone, on one NVIDIA GPU (two or more cards add phase 24 (a, b) with
NCCL and one rank per card):

    python3 scripts/smoke_mp_phases.py
    python3 scripts/smoke_mp_phases.py --nccl   # 2+ cards: only that

from the repo root (the phases read configs/small-tpu-1.yaml and
configs/small-tpu-4.yaml by relative paths).  Prints what chip_smoke.py
prints for those phases (``chip_smoke.run_mp_phases``), with phase 16's
loop time not measured here.  ``--nccl`` runs only the one-process
reference at batch 112 and its ranks with NCCL, one per card
(``chip_smoke.mp_steps_nccl``).  Any failure raises.
"""

import os
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from viewfusion_tpu_torch import _native  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("CUDA is not available: this script needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.say(cs.card_line(), torch.__version__, torch.version.cuda,
           f"{torch.cuda.device_count()} card(s)")
    t0 = time.perf_counter()
    _native.library()
    cs.say(f"build {time.perf_counter() - t0:.1f} s")
    device = torch.device("cuda")
    gn, attn = cs.sites(cs.paper_unet(device), cs.ROWS, device)
    k1, k3 = sum(gn.values()), sum(attn.values())
    t0 = time.perf_counter()
    if sys.argv[1:] == ["--nccl"]:
        if torch.cuda.device_count() < 2:
            sys.exit("--nccl needs two or more cards")
        with tempfile.TemporaryDirectory(prefix="vf-nccl-") as tmp:
            ref_dir = os.path.join(tmp, "ref")
            os.makedirs(ref_dir)
            ref = cs.mp_reference(ref_dir, device)
            launches, _ = cs.mp_steps_nccl(ref_dir, ref, tmp, k1, k3)
        cs.say(f"phase 24 with NCCL: {time.perf_counter() - t0:.1f} s; "
               f"launches {launches}")
        return
    groups = cs.Config.from_dict(cs.PAPER_CONFIG).unet.norm_groups
    mp = cs.run_mp_phases(device, k1, k3, float("nan"), groups)
    cs.say(f"phases 23-24 and the dropout step: "
           f"{time.perf_counter() - t0:.1f} s; errors {mp['errs']}; "
           f"launches {mp['launches']}")


if __name__ == "__main__":
    main()
