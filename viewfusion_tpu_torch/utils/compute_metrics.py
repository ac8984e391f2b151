"""Offline PSNR / SSIM / LPIPS over dumped image folders (counterpart of
``viewfusion_tpu/utils/compute_metrics.py``, with its flags plus
``--device``, ``cuda`` unless ``cpu`` is asked for):

    python -m viewfusion_tpu_torch.utils.compute_metrics --generated g/ --target t/
    python -m viewfusion_tpu_torch.utils.compute_metrics --root imagefolder_root/

``--root`` is the reference's ImageFolder layout: the first class dir
(sorted) holds the generated images, the second the ground truth.  Files
pair up in sorted name order.  ``.png``, ``.jpg`` and ``.jpeg`` files are
read by the port's decoders (``utils/image.py:decode_image``, by content,
as the JAX script's PIL reads them), equal to PIL's.
LPIPS runs only when its weights file exists (``ops/lpips.py``);
PSNR/SSIM always.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np
import torch

from viewfusion_tpu_torch.ops.metrics import compute_psnr, compute_ssim
from viewfusion_tpu_torch.utils.device import to_device
from viewfusion_tpu_torch.utils.image import decode_image

__all__ = ["compute_folder_metrics", "main"]


def _load_dir(path: str, exts=(".png", ".jpg", ".jpeg")) -> np.ndarray:
    files = sorted(f for f in os.listdir(path) if f.lower().endswith(exts))
    if not files:
        raise FileNotFoundError(f"no images in {path}")
    imgs = []
    for f in files:
        full = os.path.join(path, f)
        with open(full, "rb") as fh:
            try:
                img = decode_image(fh.read())
            except ValueError as e:
                raise ValueError(f"{full}: {e}") from e
        imgs.append(img.astype(np.float32) / 255.0)
    return np.stack(imgs)


def compute_folder_metrics(generated_dir: str, target_dir: str,
                           batch_size: int = 256,
                           lpips_weights: Optional[str] = None,
                           device="cuda") -> dict:
    """Mean PSNR and SSIM (and LPIPS, given its weights) of the generated
    images against the targets, computed on ``device``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("compute_metrics: CUDA is not available; pass "
                           "--device cpu to run on the CPU")
    gen = _load_dir(generated_dir)
    tgt = _load_dir(target_dir)
    if gen.shape != tgt.shape:
        raise ValueError(f"generated {gen.shape} and target {tgt.shape} "
                         "folders differ in shape")

    lpips_fn = None
    try:
        from viewfusion_tpu_torch.ops.lpips import load_lpips

        lpips_fn = load_lpips(**({"weights_path": lpips_weights}
                                 if lpips_weights else {}), device=device)
    except FileNotFoundError as e:
        print(f"LPIPS skipped: {e}")

    psnrs: List[np.ndarray] = []
    ssims: List[np.ndarray] = []
    lpipss: List[np.ndarray] = []
    for i in range(0, len(gen), batch_size):
        g, t = to_device((gen[i:i + batch_size], tgt[i:i + batch_size]),
                         device)
        psnrs.append(compute_psnr(g, t).cpu().numpy())
        ssims.append(compute_ssim(g, t).cpu().numpy())
        if lpips_fn is not None:
            # the reference rescales to [-1, 1] (utils/compute_metrics.py:41)
            lpipss.append(lpips_fn(2 * g - 1, 2 * t - 1).cpu().numpy())

    out = {"psnr": float(np.concatenate(psnrs).mean()),
           "ssim": float(np.concatenate(ssims).mean()),
           "count": int(len(gen))}
    if lpipss:
        out["lpips"] = float(np.concatenate(lpipss).mean())
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        prog="python -m viewfusion_tpu_torch.utils.compute_metrics")
    p.add_argument("--generated", type=str, default=None)
    p.add_argument("--target", type=str, default=None)
    p.add_argument("--root", type=str, default=None,
                   help="ImageFolder root: first class dir = generated, "
                        "second = ground truth (reference layout)")
    p.add_argument("--lpips-weights", type=str, default=None)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)

    if args.root:
        classes = sorted(d for d in os.listdir(args.root)
                         if os.path.isdir(os.path.join(args.root, d)))
        if len(classes) < 2:
            p.error("an ImageFolder root needs 2 class dirs")
        gen_dir = os.path.join(args.root, classes[0])
        tgt_dir = os.path.join(args.root, classes[1])
    else:
        if not (args.generated and args.target):
            p.error("provide --generated/--target or --root")
        gen_dir, tgt_dir = args.generated, args.target

    metrics = compute_folder_metrics(gen_dir, tgt_dir, args.batch_size,
                                     args.lpips_weights, args.device)
    for k, v in metrics.items():
        print(f"{k}: {v}")
    return metrics


if __name__ == "__main__":
    main()
