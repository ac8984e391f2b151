"""ViewFusion's diffusion around the denoiser, in plain float32 PyTorch
(from the paper, arXiv 2402.02906, and the reference repository's
``model/view_fusion.py``): the linear beta schedule, the per-pixel
softmax composition over a sample's valid views, the packed training
loss and the DDIM sampler with eta = 1 over the JAX package's step grid.

Noise is drawn as the program's documented draw order makes it (a
``torch.Generator`` on the device, one draw per shape in order), so the
reference sees the same noise; everything else is computed here again.
"""

from __future__ import annotations

import numpy as np
import torch

_f32 = np.float32


class Schedule:
    """The linear schedule's tables, computed in float64 and kept as
    float32 (T,) arrays: ``gammas`` = cumprod(1 - betas)."""

    def __init__(self, num_timesteps: int, linear_start: float,
                 linear_end: float):
        betas = np.linspace(linear_start, linear_end, num_timesteps,
                            dtype=np.float64)
        gammas = np.cumprod(1.0 - betas)
        self.T = num_timesteps
        self.gammas = gammas.astype(np.float32)
        self.sqrt_recip = np.sqrt(1.0 / gammas).astype(np.float32)
        self.sqrt_recipm1 = np.sqrt(1.0 / gammas - 1.0).astype(np.float32)


def ddim_timesteps(T: int, n: int) -> np.ndarray:
    """The descending grid of ``jnp.linspace(0, T-1, n)`` rounded half to
    even, as XLA computes it in float32 (a frozen copy of the rule in
    ``viewfusion_tpu_torch/models/view_fusion.py:ddim_timesteps``, repo
    commit f80e7a7, which other linspaces miss for some (T, n))."""
    stop = _f32(T - 1)
    if n == 1:
        grid = np.zeros(1, _f32)
    else:
        div = n - 1
        grid = np.append(np.arange(div, dtype=_f32)
                         * ((_f32(1) / _f32(div)) * stop), stop)
    return np.round(grid).astype(np.int64)[::-1].copy()


def compose(out, counts):
    """out (B, N, H, W, 6) per-view predictions, counts (B,) ->
    the composed noise (B, H, W, 3): a softmax over the valid views of
    the logit channels weights the noise channels."""
    n = out.shape[1]
    mask = (torch.arange(n, device=out.device)[None, :]
            < counts[:, None])[:, :, None, None, None]
    logits = torch.where(mask, out[..., 3:], float("-inf"))
    w = torch.softmax(logits, dim=1)
    w = torch.where(mask, w, 0.0)
    return (out[..., :3] * w).sum(dim=1)


def denoise_packed(denoiser, cond, y, level, angle, counts):
    """The denoiser on each sample's valid views: cond (B, N, H, W, 3),
    y (B, H, W, 3), level and angle (B,) -> (B, N, H, W, out) with zeros
    in the invalid slots."""
    b, n = cond.shape[:2]
    si = torch.repeat_interleave(torch.arange(b, device=cond.device), counts)
    vi = torch.cat([torch.arange(int(c), device=cond.device)
                    for c in counts.tolist()])
    x = torch.cat([cond[si, vi], y[si]], dim=-1)
    rows = denoiser(x, angle[si], level[si])
    dense = rows.new_zeros((b * n,) + rows.shape[1:])
    dense[si * n + vi] = rows
    return dense.reshape((b, n) + rows.shape[1:])


def ddim_eta1(denoiser, sched: Schedule, cond, counts, angle, steps: int,
              noise):
    """DDIM with eta = 1 (the server's ``ddim``): ``noise(i)`` is the
    (B, H, W, 3) draw number i (0: y_T; 1..steps-1: the steps').
    Returns the last clean prediction, (B, H, W, 3)."""
    ts = ddim_timesteps(sched.T, steps)
    ts_prev = np.append(ts[1:], -1)
    y = noise(0)
    b = y.shape[0]
    for i, (t, tp) in enumerate(zip(ts, ts_prev)):
        g = sched.gammas[t]
        gp = sched.gammas[tp] if tp >= 0 else _f32(1.0)
        level = torch.full((b,), float(g), device=y.device)
        eps = compose(denoise_packed(denoiser, cond, y, level, angle, counts),
                      counts)
        y0 = (float(sched.sqrt_recip[t]) * y
              - float(sched.sqrt_recipm1[t]) * eps).clamp(-1.0, 1.0)
        eps = (y - float(np.sqrt(g)) * y0) / float(np.sqrt(_f32(1.0) - g))
        sigma = np.sqrt((_f32(1.0) - gp) / (_f32(1.0) - g)
                        * (_f32(1.0) - g / gp))
        dir_coef = np.sqrt(max(_f32(1.0) - gp - sigma ** 2, _f32(0.0)))
        y_next = float(np.sqrt(gp)) * y0 + float(dir_coef) * eps
        if tp >= 0:
            y_next = y_next + float(sigma) * noise(i + 1)
        y = y_next
    return y


def training_draws(sched: Schedule, b: int, shape, generator, device):
    """t ~ U{1..T-1}, u ~ U[0, 1), noise, drawn in that order: the
    per-sample noise level gamma_{t-1} + u (gamma_t - gamma_{t-1}) (the
    WaveGrad continuous level) and the (B, H, W, 3) noise."""
    t = torch.randint(1, sched.T, (b,), generator=generator, device=device)
    table = torch.as_tensor(sched.gammas, device=device)
    g1, g2 = table[t - 1], table[t]
    u = torch.rand((b,), generator=generator, device=device)
    noise = torch.randn((b,) + tuple(shape), generator=generator,
                        device=device)
    return (g2 - g1) * u + g1, noise


def packed_loss(denoiser, y0, cond, counts, angle, gammas, noise):
    """The mean squared error between the noise and its composed
    prediction over every pixel of the batch (ViewFusion's objective on
    the valid views only); y0, cond in [0, 1]."""
    g = gammas[:, None, None, None]
    y_noisy = torch.sqrt(g) * y0 + torch.sqrt(1.0 - g) * noise
    out = denoise_packed(denoiser, cond, y_noisy, gammas, angle, counts)
    return torch.mean((noise - compose(out, counts)) ** 2)
