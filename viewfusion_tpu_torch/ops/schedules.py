"""DDPM beta schedules and the derived schedule tables.

The seven schedule variants of the reference (model/view_fusion.py:304-362)
and its derived buffers (model/view_fusion.py:35-68), computed in float64
numpy and cast to float32.  The tables stay host-side numpy: the samplers
read per-step scalars from them on the host, so no step waits on the
device for a coefficient.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from viewfusion_tpu_torch.config import BetaScheduleConfig

__all__ = ["make_beta_schedule", "DiffusionSchedule"]


def _warmup_beta(
    linear_start: float, linear_end: float, num_timesteps: int, warmup_frac: float
) -> np.ndarray:
    """Constant schedule with a linear warmup prefix."""
    betas = linear_end * np.ones(num_timesteps, dtype=np.float64)
    warmup_time = int(num_timesteps * warmup_frac)
    betas[:warmup_time] = np.linspace(
        linear_start, linear_end, warmup_time, dtype=np.float64
    )
    return betas


def make_beta_schedule(
    schedule: str,
    num_timesteps: int,
    linear_start: float = 1e-6,
    linear_end: float = 1e-2,
    cosine_s: float = 8e-3,
) -> np.ndarray:
    """All 7 schedule variants of the reference, as float64 numpy."""
    if schedule == "quad":
        betas = (
            np.linspace(
                linear_start**0.5, linear_end**0.5, num_timesteps, dtype=np.float64
            )
            ** 2
        )
    elif schedule == "linear":
        betas = np.linspace(linear_start, linear_end, num_timesteps, dtype=np.float64)
    elif schedule == "warmup10":
        betas = _warmup_beta(linear_start, linear_end, num_timesteps, 0.1)
    elif schedule == "warmup50":
        betas = _warmup_beta(linear_start, linear_end, num_timesteps, 0.5)
    elif schedule == "const":
        betas = linear_end * np.ones(num_timesteps, dtype=np.float64)
    elif schedule == "jsd":  # 1/T, 1/(T-1), ..., 1
        betas = 1.0 / np.linspace(num_timesteps, 1, num_timesteps, dtype=np.float64)
    elif schedule == "cosine":
        timesteps = (
            np.arange(num_timesteps + 1, dtype=np.float64) / num_timesteps + cosine_s
        )
        alphas = timesteps / (1 + cosine_s) * math.pi / 2
        alphas = np.cos(alphas) ** 2
        alphas = alphas / alphas[0]
        betas = 1.0 - alphas[1:] / alphas[:-1]
        betas = np.clip(betas, a_min=None, a_max=0.999)
    else:
        raise NotImplementedError(schedule)
    return betas


@dataclass(frozen=True)
class DiffusionSchedule:
    """Derived DDPM tables, each (T,) float32 numpy.  ``gammas`` is the
    cumulative alpha-bar product that conditions the UNet."""

    num_timesteps: int
    betas: np.ndarray
    gammas: np.ndarray
    gammas_prev: np.ndarray
    sqrt_recip_gammas: np.ndarray
    sqrt_recipm1_gammas: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray

    @classmethod
    def create(cls, cfg: BetaScheduleConfig) -> "DiffusionSchedule":
        betas = make_beta_schedule(
            schedule=cfg.schedule,
            num_timesteps=cfg.num_timesteps,
            linear_start=cfg.linear_start,
            linear_end=cfg.linear_end,
            cosine_s=cfg.cosine_s,
        )
        alphas = 1.0 - betas
        gammas = np.cumprod(alphas, axis=0)
        gammas_prev = np.append(1.0, gammas[:-1])
        posterior_variance = betas * (1.0 - gammas_prev) / (1.0 - gammas)
        f32 = lambda a: np.asarray(a, dtype=np.float32)  # noqa: E731
        return cls(
            num_timesteps=int(betas.shape[0]),
            betas=f32(betas),
            gammas=f32(gammas),
            gammas_prev=f32(gammas_prev),
            sqrt_recip_gammas=f32(np.sqrt(1.0 / gammas)),
            sqrt_recipm1_gammas=f32(np.sqrt(1.0 / gammas - 1.0)),
            posterior_log_variance_clipped=f32(
                np.log(np.maximum(posterior_variance, 1e-20))
            ),
            posterior_mean_coef1=f32(betas * np.sqrt(gammas_prev) / (1.0 - gammas)),
            posterior_mean_coef2=f32(
                (1.0 - gammas_prev) * np.sqrt(alphas) / (1.0 - gammas)
            ),
        )
