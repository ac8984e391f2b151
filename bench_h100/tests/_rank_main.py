"""One rank of a multi-card cell on the CPU (gloo), for the tests:
``python -m torch.distributed.run --standalone --nproc_per_node N
_rank_main.py <bench root> <cell> <result file> [fault]``."""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from bench_h100 import run  # noqa: E402
from bench_h100.tests import _tiny  # noqa: E402

if __name__ == "__main__":
    root, cell, result = sys.argv[1:4]
    _tiny.plant(sys.argv[4] if len(sys.argv) > 4 else "")
    run.main(["--workload", cell, "--seed", "3000000001", "--seconds", "1",
              "--trace", "0", "--result", result], root=Path(root),
             device="cpu", t0=time.monotonic())
