"""Metric logging: JSONL in the run dir always, wandb when asked for and
installed (the port's counterpart of
``viewfusion_tpu/training/logging.py``, with the same files).

``metrics.jsonl`` gets one record per ``log`` call: ``{"it", "wall",
<scalars>}``.  Images go to ``<name>-<it>.png`` and videos to
``<name>-<it>.gif`` through the port's own codecs.  ``wandb`` is imported
only when ``use_wandb`` is set; if it is missing, the logger says so and
goes on with JSONL alone.
"""

from __future__ import annotations

import json
import os
import time
import uuid
from typing import Any, Dict, Optional

import numpy as np

from viewfusion_tpu_torch.utils.image import save_gif, save_png

__all__ = ["MetricLogger", "generate_run_id"]


def generate_run_id() -> str:
    """A run id in the form of ``wandb.util.generate_id``."""
    return uuid.uuid4().hex[:8]


class MetricLogger:
    def __init__(self, out_dir: str, use_wandb: bool = False,
                 run_id: Optional[str] = None, exp_name: str = "",
                 config: Optional[Dict[str, Any]] = None,
                 is_host0: bool = True):
        self.out_dir = out_dir
        self.jsonl_path = os.path.join(out_dir, "metrics.jsonl")
        self.wandb = None
        self.run_id = run_id
        # with more than one process, rank 0 alone writes and talks to wandb
        self.is_host0 = is_host0
        if is_host0:
            os.makedirs(out_dir, exist_ok=True)
        if use_wandb and is_host0:
            try:
                import wandb
            except ImportError:
                print("wandb not installed; logging to JSONL only.")
            else:
                if self.run_id is None:
                    self.run_id = wandb.util.generate_id()
                wandb.init(project="view-fusion", name=exp_name or None,
                           id=self.run_id, resume=True, config=config)
                wandb.define_metric("ssim", summary="max")
                wandb.define_metric("psnr", summary="max")
                self.wandb = wandb
        if self.run_id is None:
            self.run_id = generate_run_id()

    def best_metric_summary(self) -> Optional[Dict[str, float]]:
        """Max ssim/psnr of the wandb run summary, which overrides the
        checkpoint's on resume; None without wandb."""
        if self.wandb is None:
            return None
        out: Dict[str, float] = {}
        for key in ("ssim", "psnr"):
            v = self.wandb.run.summary.get(key)
            if v is None:
                out[key] = float("-inf")
            elif hasattr(v, "get"):  # define_metric summary {"max": x}
                out[key] = float(v.get("max", float("-inf")))
            else:
                out[key] = float(v)
        return out

    def log(self, metrics: Dict[str, Any], step: int) -> None:
        if not metrics or not self.is_host0:
            return
        scalars = {k: (float(v) if hasattr(v, "__float__") else v)
                   for k, v in metrics.items()
                   if isinstance(v, (int, float)) or hasattr(v, "__float__")}
        record = {"it": step, "wall": time.time(), **scalars}
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self.wandb is not None:
            self.wandb.log(metrics, step=step)

    def log_image(self, name: str, image, step: int,
                  caption: str = "") -> None:
        """Save an (H, W, 3) uint8 or [0, 1] image as
        ``<name>-<step>.png``."""
        if not self.is_host0:
            return
        path = os.path.join(self.out_dir, f"{name}-{step}.png")
        save_png(image, path)
        if self.wandb is not None:
            self.wandb.log({name: self.wandb.Image(path, caption=caption)},
                           step=step)

    def log_video(self, name: str, frames, step: int,
                  duration: float = 0.1) -> None:
        """Save frames as the looping GIF ``<name>-<step>.gif``."""
        if not self.is_host0:
            return
        path = os.path.join(self.out_dir, f"{name}-{step}.gif")
        save_gif(frames, path, duration=duration)
        if self.wandb is not None:
            self.wandb.log({name: self.wandb.Video(
                np.stack(frames).transpose(0, 3, 1, 2), format="gif")},
                step=step)
