"""Run chip_smoke.py's DiT and offline-tool phases (17-22) alone, on one
NVIDIA GPU, in about two minutes after the kernels' build:

    python3 scripts/smoke_dit_phases.py

from the repo root (the phases read configs/dit-small-tpu-4.yaml by a
relative path).  Prints what chip_smoke.py prints for those phases
(``chip_smoke.run_dit_phases``) and K3's largest error over them; any
failure raises.
"""

import sys
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
    cs.say(cs.card_line(), torch.__version__, torch.version.cuda)
    t0 = time.perf_counter()
    _native.library()
    cs.say(f"build {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dit = cs.run_dit_phases(torch.device("cuda"))
    cs.say(f"phases 17-22: {time.perf_counter() - t0:.1f} s; K3 max abs "
           f"err {dit['max_abs_err']:.3g}; launches {dit['launches']}; K5 "
           f"{dit['k5_launches']}")


if __name__ == "__main__":
    main()
