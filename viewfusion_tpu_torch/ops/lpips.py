"""LPIPS perceptual metric (VGG16 backbone) in PyTorch (counterpart of
``viewfusion_tpu/ops/lpips.py``).

VGG16 conv features at relu1_2/relu2_2/relu3_3/relu4_3/relu5_3 of inputs
in [-1, 1] (shifted and scaled as ``lpips.ScalingLayer``), each
unit-normalised over its channels, the squared difference weighted by
the non-negative 1x1 linear heads, the spatial mean, summed over the
stages (Zhang et al. 2018).  The JAX metric runs XLA convolutions and
``reduce_window``, no Pallas kernel; here they are ``F.conv2d`` and
``F.max_pool2d``, in exact f32 (TF32 off) on a card as on the CPU.

Weights are the ``.npz`` that ``scripts/convert_lpips_weights.py``
writes, as the JAX metric reads it: ``conv{i}_w`` (3, 3, in, out) HWIO,
``conv{i}_b`` and ``lin{s}_w`` (1, 1, C, 1); they are laid out for
PyTorch when loaded.
"""

from __future__ import annotations

import os
from typing import Callable, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["load_lpips", "LPIPS_STAGES", "vgg16_features"]

# VGG16: (#convs, channels) per stage; LPIPS taps the relu after the last
# conv of each stage
_VGG_STAGES: List[Tuple[int, int]] = [
    (2, 64), (2, 128), (3, 256), (3, 512), (3, 512)]
LPIPS_STAGES = len(_VGG_STAGES)

# lpips.ScalingLayer's ImageNet normalisation of [-1, 1] inputs
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def vgg16_features(params, x: torch.Tensor) -> List[torch.Tensor]:
    """x (B, H, W, 3) in [-1, 1] -> the 5 stage feature maps, NCHW.
    ``params`` holds torch tensors in PyTorch's layout (OIHW convs)."""
    shift = torch.from_numpy(_SHIFT).to(x.device)
    scale = torch.from_numpy(_SCALE).to(x.device)
    h = ((x - shift) / scale).permute(0, 3, 1, 2)
    feats = []
    conv_idx = 0
    for stage, (n_convs, _) in enumerate(_VGG_STAGES):
        for _ in range(n_convs):
            h = F.relu(F.conv2d(h, params[f"conv{conv_idx}_w"],
                                params[f"conv{conv_idx}_b"], padding=1))
            conv_idx += 1
        feats.append(h)
        if stage != len(_VGG_STAGES) - 1:
            h = F.max_pool2d(h, 2, 2)
    return feats


def load_lpips(weights_path: str = "~/.cache/viewfusion_tpu/lpips_vgg.npz",
               device="cuda") -> Callable:
    """Return ``lpips(x, y) -> (B,)`` f32 distances on ``device``; x and y
    are NHWC in [-1, 1] (tensors or arrays).  Raises FileNotFoundError
    when the weights file does not exist."""
    weights_path = os.path.expanduser(weights_path)
    if not os.path.exists(weights_path):
        raise FileNotFoundError(
            f"LPIPS weights not found at {weights_path}. Generate them "
            "with scripts/convert_lpips_weights.py on a machine with "
            "torchvision+lpips, or pass weights_path explicitly. "
            "(PSNR/SSIM need no weights.)")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("load_lpips: CUDA is not available; pass "
                           "device='cpu' to run on the CPU")
    params = {}
    for k, v in np.load(weights_path).items():
        t = torch.from_numpy(np.asarray(v, np.float32))
        if k.startswith("conv") and k.endswith("_w"):
            t = t.permute(3, 2, 0, 1)  # HWIO -> OIHW
        elif k.startswith("lin"):
            t = t.reshape(1, -1, 1, 1)  # (1, 1, C, 1) -> per channel
        params[k] = t.contiguous().to(device)

    def lpips_fn(x, y) -> torch.Tensor:
        x, y = (torch.as_tensor(a, dtype=torch.float32, device=device)
                for a in (x, y))
        cudnn = torch.backends.cudnn
        with torch.no_grad(), cudnn.flags(
                enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                deterministic=cudnn.deterministic, allow_tf32=False):
            fx, fy = vgg16_features(params, x), vgg16_features(params, y)
        total = torch.zeros(x.shape[0], dtype=torch.float32, device=device)
        for s, (a, b) in enumerate(zip(fx, fy)):
            a = a / torch.sqrt((a * a).sum(dim=1, keepdim=True) + 1e-10)
            b = b / torch.sqrt((b * b).sum(dim=1, keepdim=True) + 1e-10)
            d = ((a - b) ** 2 * params[f"lin{s}_w"]).sum(dim=1)
            total = total + d.mean(dim=(1, 2))
        return total

    return lpips_fn
