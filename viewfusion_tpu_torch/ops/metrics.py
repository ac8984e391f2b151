"""Image quality metrics: PSNR and SSIM (the port's counterpart of
``viewfusion_tpu/ops/metrics.py``).

PSNR = 20 log10(range / sqrt(MSE)) per image.  SSIM is Wang et al.
(2004) as pytorch_msssim implements it: an 11-tap separable Gaussian
window (sigma 1.5), VALID padding, K = (0.01, 0.03), the mean over the
spatial dims and then the channels: one value per image.  The blur is
exact f32 (no TF32): the variance estimate subtracts two blurred values
whose true difference can be ~0 on flat regions, so a reduced-precision
blur can push SSIM outside [-1, 1] (the JAX metric pins
``Precision.HIGHEST`` for the same reason).

Images are NHWC float in [0, data_range]; plain torch ops, on whatever
device the tensors are on.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["compute_psnr", "compute_ssim", "gaussian_window"]


def compute_psnr(generated: torch.Tensor, target: torch.Tensor,
                 data_range: float = 1.0) -> torch.Tensor:
    """Per-image PSNR over all pixels and channels."""
    dims = tuple(range(1, generated.ndim))
    mse = torch.mean((generated - target) ** 2, dim=dims)
    return 20.0 * torch.log10(data_range / torch.sqrt(mse))


def gaussian_window(win_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """Normalised 1-D Gaussian window (pytorch_msssim's
    ``_fspecial_gauss_1d``), float32."""
    coords = np.arange(win_size, dtype=np.float64) - win_size // 2
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _depthwise_blur(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Separable depthwise Gaussian filter, VALID padding, NHWC: a sum of
    shifted f32 products per axis, so no reduced-precision (TF32)
    convolution path can be taken."""
    k = win.shape[0]
    h, w = x.shape[1] - k + 1, x.shape[2] - k + 1
    y = sum(win[i] * x[:, i:i + h] for i in range(k))
    return sum(win[i] * y[:, :, i:i + w] for i in range(k))


def compute_ssim(generated: torch.Tensor, target: torch.Tensor,
                 data_range: float = 1.0, win_size: int = 11,
                 win_sigma: float = 1.5) -> torch.Tensor:
    """Per-image SSIM, NHWC, with pytorch_msssim's defaults.  The window
    shrinks to the largest odd size that fits images under 11 px."""
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    min_dim = min(generated.shape[1], generated.shape[2])
    if win_size > min_dim:
        win_size = min_dim if min_dim % 2 == 1 else min_dim - 1
    x = generated.float()
    y = target.float()
    win = torch.from_numpy(gaussian_window(win_size, win_sigma)).to(x.device)
    mu1 = _depthwise_blur(x, win)
    mu2 = _depthwise_blur(y, win)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _depthwise_blur(x * x, win) - mu1_sq
    sigma2_sq = _depthwise_blur(y * y, win) - mu2_sq
    sigma12 = _depthwise_blur(x * y, win) - mu1_mu2
    # exact arithmetic has sigma^2 >= 0 and |sigma12| <= sqrt(s1 s2)
    # (Cauchy-Schwarz), which bounds SSIM to [-1, 1]; projecting back onto
    # them only corrects float cancellation, as the JAX metric does
    sigma1_sq = torch.clamp(sigma1_sq, min=0.0)
    sigma2_sq = torch.clamp(sigma2_sq, min=0.0)
    bound = torch.sqrt(sigma1_sq * sigma2_sq)
    sigma12 = torch.maximum(torch.minimum(sigma12, bound), -bound)
    cs_map = (2 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    ssim_map = ((2 * mu1_mu2 + c1) / (mu1_sq + mu2_sq + c1)) * cs_map
    return ssim_map.mean(dim=(1, 2, 3))
