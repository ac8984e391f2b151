"""ViewFusion composable diffusion: the training objectives and the
reverse samplers of the port (counterpart of
``viewfusion_tpu/models/view_fusion.py``).

One shared denoiser (the UNet, the DiT or the ADM) predicts the noise of every
(conditioning view, noisy target) pair; a per-pixel softmax over the
views (masked to each sample's ``view_count``) composes the
predictions.  The dense layout pads
every sample to ``n_max`` views, as the JAX dense ``_denoise_views``; the
packed layout (``loss_packed``) runs the UNet on exactly the valid
(sample, view) rows and scatters its outputs back to the dense layout.

Training draws t ~ U{1..T-1}, the position u of the continuous noise
level between gamma_{t-1} and gamma_t, and the noise, in that order, from
one ``torch.Generator`` on the model's device (the JAX loss splits one
key three ways); ``sample_gammas=`` and ``noise=`` replace the draws.

The reverse chains are Python loops: the reference's T-step ancestral
chain (``generate``, in segments through ``init_chain`` /
``chain_segment`` / ``finalize_chain``), DDIM and DPM-Solver++.  Per-step
coefficients are computed on the host in float32 numpy from the schedule
tables, with the same expressions as the JAX samplers, so no step waits
on the device.  Noise comes from a ``torch.Generator`` on the model's
device; ``noise=`` feeds explicit per-step draws instead (tests feed the
draws the JAX chain makes).  Every sampler takes ``packed_idx`` to run
the per-step UNet on the packed (sample, view) rows.

With more than one process each draws for the global batch and keeps its
own rows: the training draws come from :meth:`ViewFusion.training_draws`
at the global size, and a sampler's ``generator`` may be a
:class:`RowSlice`, whose draws are made for ``total`` rows and cut to
this process's ``[lo, lo + B)``.  So the numbers do not depend on the
number of processes.

Tensors are NHWC: y_cond (B, N, H, W, Cc), y_t (B, H, W, 3),
view_count (B,), angle (B,).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from viewfusion_tpu_torch import tracing
from viewfusion_tpu_torch.config import Config
from viewfusion_tpu_torch.models.adm import ADM
from viewfusion_tpu_torch.models.dit import DiT
from viewfusion_tpu_torch.models.graphed import GraphedForward
from viewfusion_tpu_torch.models.unet import UNet
from viewfusion_tpu_torch.ops.schedules import DiffusionSchedule

__all__ = ["ViewFusion", "GenerateOutput", "ChainCarry", "RowSlice",
           "view_mask", "ddim_timesteps", "dpm_timesteps"]

_f32 = np.float32


class GenerateOutput(NamedTuple):
    """Outputs of the ancestral chain (JAX ``GenerateOutput``)."""

    y_t: torch.Tensor                  # final sample (B, H, W, 3)
    ret_arr: torch.Tensor              # (B, frames + 1, H, W, 3), y_T first
    logit_arr: Optional[torch.Tensor]  # (B, frames, N, H, W, 3) or None
    weight_arr: Optional[torch.Tensor]  # (B, frames, N, H, W, 3) or None
    generated_samples: torch.Tensor    # == ret_arr[:, -1]


@dataclass
class ChainCarry:
    """State of a segmented ancestral chain (the JAX scan carry): the
    current sample, the frame buffers (frame axis first) and the number of
    frames written.  ``generator`` draws the per-step noise, as the key in
    the JAX carry does.  :meth:`ViewFusion.chain_segment` updates it in
    place."""

    y_t: torch.Tensor
    ret_arr: torch.Tensor
    logit_arr: Optional[torch.Tensor]
    weight_arr: Optional[torch.Tensor]
    frame_idx: int
    generator: Optional[torch.Generator]


class RowSlice(NamedTuple):
    """A sampler's generator for rows ``[lo, lo + B)`` of a batch of
    ``total`` rows: each draw is made for all ``total`` rows from
    ``generator`` and cut to this process's rows."""

    generator: torch.Generator
    total: int
    lo: int


def _randn(shape, generator, device) -> torch.Tensor:
    """A normal draw of ``shape`` from ``generator`` (a torch.Generator,
    a :class:`RowSlice` or None)."""
    if isinstance(generator, RowSlice):
        full = torch.randn((generator.total,) + tuple(shape[1:]),
                           generator=generator.generator, device=device)
        return full[generator.lo:generator.lo + shape[0]]
    return torch.randn(shape, generator=generator, device=device)


def view_mask(view_count: torch.Tensor, n_max: int) -> torch.Tensor:
    """(B,) counts -> (B, n_max) boolean validity mask."""
    return (torch.arange(n_max, device=view_count.device)[None, :]
            < view_count[:, None])


def ddim_timesteps(num_timesteps: int, num_steps: int) -> np.ndarray:
    """Descending DDIM grid, bit-for-bit the JAX one:
    ``jnp.linspace(0, T-1, n)`` in float32, rounded half to even.  XLA
    compiles that linspace to ``iota * f32(f32(1/div) * (T-1))`` (the
    division becomes a reciprocal product and the constants fold), with
    the endpoint appended; ``torch.linspace``, float64 ``np.linspace``
    and the unfolded ``iota/div*(T-1)`` pick other steps for some
    (T, n), e.g. T=200 with n=23 or n=63."""
    stop = _f32(num_timesteps - 1)
    if num_steps == 1:
        grid = np.zeros(1, _f32)
    else:
        div = num_steps - 1
        step = (_f32(1) / _f32(div)) * stop
        grid = np.append(np.arange(div, dtype=_f32) * step, stop)
    return np.round(grid).astype(np.int64)[::-1].copy()


def dpm_timesteps(gammas: np.ndarray, num_steps: int,
                  grid: str = "lambda") -> np.ndarray:
    """Descending DPM-Solver step grid (host code of the JAX sampler):
    uniform in half-log-SNR lambda (default) or in t; duplicate nearest
    indices collapse."""
    t_count = gammas.shape[0]
    if grid == "time":
        idx = np.linspace(0, t_count - 1, num_steps).round().astype(int)
    elif grid == "lambda":
        g_np = np.asarray(gammas, np.float64)
        lam_np = 0.5 * (np.log(g_np) - np.log1p(-g_np))
        targets = np.linspace(lam_np[-1], lam_np[0], num_steps)
        idx = np.abs(lam_np[None, :] - targets[:, None]).argmin(axis=1)
    else:
        raise ValueError(f"grid must be 'lambda' or 'time': {grid!r}")
    return np.unique(idx)[::-1].copy()


def _lam(g):
    """Half-log-SNR log(alpha/sigma) with alpha^2 = g, in float32."""
    return _f32(0.5) * (np.log(g) - np.log1p(-g))


class ViewFusion:
    """The denoiser, the active schedule and the composition flags.

    ``unet`` holds the denoiser, a :class:`UNet`, a :class:`DiT` or an
    :class:`ADM` (same call contract), which ``graphs`` calls (a CUDA
    graph replayed where the call allows it).  Each denoiser call is a
    ``unet.forward`` span and each step of a sampler a ``sampler.step``
    span (``tracing.py``)."""

    def __init__(self, unet: Union[UNet, DiT, ADM],
                 schedule: DiffusionSchedule,
                 weighting_train: bool = True,
                 weighting_inference: bool = True):
        self.unet = unet
        self.schedule = schedule
        self.weighting_train = weighting_train
        self.weighting_inference = weighting_inference
        self._gammas = {}  # the gamma table on each device it was used on
        self.graphs = GraphedForward()  # the denoiser's calls

    @classmethod
    def from_config(cls, cfg: Config,
                    dtype: Optional[torch.dtype] = None) -> "ViewFusion":
        if dtype is None:
            dtype = getattr(torch, cfg.train.compute_dtype)
        # the denoiser registry (JAX ViewFusion.from_config)
        if cfg.denoise_net == "unet":
            denoiser = UNet(cfg.denoiser, dtype=dtype, remat=cfg.train.remat)
        elif cfg.denoise_net == "dit":
            denoiser = DiT(cfg.denoiser, dtype=dtype, remat=cfg.train.remat)
        elif cfg.denoise_net == "adm":
            denoiser = ADM(cfg.denoiser, dtype=dtype, remat=cfg.train.remat)
        else:
            raise ValueError("Provided denoising function is not supported!")
        # the *train* schedule is active for inference too
        sched = DiffusionSchedule.create(
            cfg.diffusion.phases[cfg.diffusion.active_phase])
        return cls(denoiser, sched,
                   weighting_train=cfg.diffusion.weighting_train,
                   weighting_inference=cfg.diffusion.weighting_inference)

    # ------------------------------------------------------------------
    def _denoise_views(self, y_cond, y_target, noise_level, angle,
                       packed_idx=None, denoiser=None, dropout=None):
        """Per-view UNet pass -> (B, N, H, W, out).

        Dense: all B * N rows.  Packed (``packed_idx`` = (sample_idx,
        view_idx), (R,) int64): rows gathered by (sample, view), outputs
        scattered into zeros at ``sample_idx * N + view_idx``; untouched
        slots stay 0 and are masked by :meth:`compose`.  ``denoiser``
        replaces ``self.unet`` for the call (the train step's DDP and
        view-split wrappers); ``dropout`` goes to the UNet.  The call
        goes through :attr:`graphs`, which replays it as a CUDA graph
        where it can (``models/graphed.py``)."""
        b, n, h, w, _ = y_cond.shape
        unet = self.unet if denoiser is None else denoiser
        with tracing.span("unet.forward") as span:
            if packed_idx is not None:
                sample_idx, view_idx = packed_idx
                x = torch.cat([y_cond[sample_idx, view_idx],
                               y_target[sample_idx].to(y_cond.dtype)], dim=-1)
                args = (x, angle.reshape(-1)[sample_idx],
                        noise_level[sample_idx])
            else:
                y_rep = y_target[:, None].expand(b, n, h, w,
                                                 y_target.shape[-1])
                x = torch.cat([y_cond, y_rep.to(y_cond.dtype)], dim=-1)
                level_rep = noise_level[:, None].expand(b, n).reshape(-1)
                angle_rep = angle.reshape(-1)[:, None].expand(b, n).reshape(-1)
                args = (x.reshape(b * n, h, w, -1), angle_rep, level_rep)
            out, graphed = self.graphs(unet, *args, dropout=dropout,
                                       override=denoiser is not None)
            if span is not None:
                span.attrs.update(graphed=graphed, rows=args[0].shape[0])
            if packed_idx is None:
                return out.reshape(b, n, h, w, -1)
            dense = out.new_zeros((b * n,) + out.shape[1:])
            dense = dense.index_copy(0, sample_idx * n + view_idx, out)
            return dense.reshape(b, n, h, w, -1)

    @staticmethod
    def compose(unet_out, mask, weighting: bool):
        """Compose per-view noise predictions: -inf masked softmax over
        the view axis (masked views get exactly zero weight), or the mean
        over valid views when ``weighting`` is off.
        Returns (noise_hat, logits, weights)."""
        noise_all = unet_out[..., :3]
        m = mask[:, :, None, None, None]
        if weighting:
            logits = unet_out[..., 3:].float()
            masked = torch.where(m, logits, float("-inf"))
            zmax = masked.amax(dim=1, keepdim=True)
            unnorm = torch.where(m, torch.exp(masked - zmax), 0.0)
            weights = unnorm / unnorm.sum(dim=1, keepdim=True)
            return (noise_all * weights).sum(dim=1), logits, weights
        counts = m.sum(dim=1, dtype=torch.float32)
        noise_hat = torch.where(m, noise_all, 0.0).sum(dim=1) / counts
        return noise_hat, None, None

    # ------------------------------------------------------------------
    def q_sample(self, y_0, sample_gammas, noise):
        """sqrt(g) * y_0 + sqrt(1 - g) * noise; ``sample_gammas``
        broadcasts against y_0 ((B, 1, 1, 1) or scalar)."""
        return (torch.sqrt(sample_gammas) * y_0
                + torch.sqrt(1.0 - sample_gammas) * noise)

    def _gamma_table(self, device) -> torch.Tensor:
        key = str(device)
        if key not in self._gammas:
            self._gammas[key] = torch.as_tensor(self.schedule.gammas,
                                                device=device)
        return self._gammas[key]

    def _sample_gammas(self, b: int, generator, device) -> torch.Tensor:
        """Per-sample gamma uniform in [gamma_{t-1}, gamma_t), t ~
        U{1..T-1} (the WaveGrad continuous noise level): t, then u."""
        t = torch.randint(1, self.schedule.num_timesteps, (b,),
                          generator=generator, device=device)
        table = self._gamma_table(device)
        g1, g2 = table[t - 1], table[t]
        u = torch.rand((b,), generator=generator, device=device)
        return (g2 - g1) * u + g1

    def training_draws(self, shape, generator, device):
        """(noise, sample_gammas) of a training batch of images ``shape``
        (B, H, W, 3), drawn as the losses draw them."""
        gammas = self._sample_gammas(shape[0], generator, device)
        return torch.randn(shape, generator=generator, device=device), gammas

    def _noisy_target(self, y_0, noise, sample_gammas, generator):
        """(noise, sample_gammas, y_noisy) of a training step (the draws
        of :meth:`training_draws` where not given)."""
        b, dev = y_0.shape[0], y_0.device
        if sample_gammas is None:
            sample_gammas = self._sample_gammas(b, generator, dev)
        if noise is None:
            noise = torch.randn(y_0.shape, generator=generator, device=dev)
        y_noisy = self.q_sample(y_0, sample_gammas[:, None, None, None],
                                noise)
        return noise, sample_gammas, y_noisy

    def _mse(self, unet_out, noise, view_count):
        mask = view_mask(view_count, unet_out.shape[1])
        noise_hat = self.compose(unet_out, mask, self.weighting_train)[0]
        return torch.mean((noise - noise_hat) ** 2)

    def loss(self, y_0, y_cond, view_count, angle, noise=None,
             sample_gammas=None, generator: Optional[torch.Generator] = None,
             dropout=None, denoiser=None):
        """MSE between the true noise and the composed prediction, dense
        layout (JAX ``loss``).  y_0 (B, H, W, 3), y_cond (B, N, H, W, Cc),
        view_count and angle (B,); ``noise`` (B, H, W, 3) and
        ``sample_gammas`` (B,) replace the draws.  ``dropout`` (a
        generator or masks by name, see ``models/unet.py``) turns the
        UNet's dropout on, as ``deterministic=False`` does in JAX."""
        noise, gammas, y_noisy = self._noisy_target(y_0, noise,
                                                    sample_gammas, generator)
        out = self._denoise_views(y_cond, y_noisy, gammas, angle,
                                  denoiser=denoiser, dropout=dropout)
        return self._mse(out, noise, view_count)

    def loss_packed(self, y_0, y_cond, view_count, angle, sample_idx,
                    view_idx, noise=None, sample_gammas=None,
                    generator: Optional[torch.Generator] = None,
                    denoiser=None):
        """:meth:`loss` with the UNet on exactly the sum(view_count) valid
        rows (JAX ``loss_packed``).  ``sample_idx``/``view_idx`` (R,)
        enumerate the valid (sample, view < view_count) pairs
        (``training.trainer.packed_indices``).  Dropout stays off, as in
        JAX, whose ``loss_packed`` runs deterministic."""
        noise, gammas, y_noisy = self._noisy_target(y_0, noise,
                                                    sample_gammas, generator)
        out = self._denoise_views(y_cond, y_noisy, gammas, angle,
                                  packed_idx=(sample_idx, view_idx),
                                  denoiser=denoiser)
        return self._mse(out, noise, view_count)

    # ------------------------------------------------------------------
    def _composed(self, y_cond, y, t, mask, angle, packed_idx=None):
        """The composed noise prediction at timestep t:
        (noise_hat, logits, weights)."""
        b = y.shape[0]
        level = torch.full((b,), float(self.schedule.gammas[t]),
                           device=y.device)
        out = self._denoise_views(y_cond, y, level, angle, packed_idx)
        return self.compose(out, mask, self.weighting_inference)

    def _eps(self, y_cond, y, t, mask, angle, packed_idx=None):
        return self._composed(y_cond, y, t, mask, angle, packed_idx)[0]

    def _x0(self, y, eps, t):
        s = self.schedule
        x0 = (float(s.sqrt_recip_gammas[t]) * y
              - float(s.sqrt_recipm1_gammas[t]) * eps)
        return x0.clamp(-1.0, 1.0)

    def _start(self, y_cond, view_count, angle, y_t, generator):
        b, n, h, w, _ = y_cond.shape
        if y_t is None:
            y_t = _randn((b, h, w, 3), generator, y_cond.device)
        # the UNet's first op casts to its dtype: casting here once gives
        # it the same values at a fraction of the per-step traffic
        return (y_cond.to(self.unet.dtype), y_t, view_mask(view_count, n),
                angle.reshape(-1))

    @staticmethod
    def _noise(noise, i, like, generator):
        if noise is not None:
            return noise[i].to(like.device, torch.float32)
        return _randn(like.shape, generator, like.device)

    # ------------------------------------------------------------------
    # the reference's ancestral chain
    # ------------------------------------------------------------------
    @torch.no_grad()
    def p_mean_variance(self, y_t, y_cond, mask, angle, t: int,
                        packed_idx=None):
        """One denoising step's posterior (JAX ``p_mean_variance``):
        y0 from the composed noise prediction, clipped to [-1, 1], then
        the posterior mean coef1[t] * y0 + coef2[t] * y_t.  Returns
        (mean (B, H, W, 3), log-variance (a float32 scalar), logits,
        weights); y_cond is in the UNet's dtype, mask (B, N)."""
        s = self.schedule
        noise, logits, weights = self._composed(y_cond, y_t, t, mask, angle,
                                                packed_idx)
        y0 = self._x0(y_t, noise, t)
        mean = (float(s.posterior_mean_coef1[t]) * y0
                + float(s.posterior_mean_coef2[t]) * y_t)
        return mean, s.posterior_log_variance_clipped[t], logits, weights

    @torch.no_grad()
    def p_sample(self, y_t, y_cond, mask, angle, t: int, packed_idx=None,
                 noise: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None):
        """Ancestral step (JAX ``p_sample``): mean + exp(logvar / 2) * z,
        with z = 0 at t = 0 (no draw is made there).  ``noise`` (B, H, W,
        3) replaces the draw.  Returns (y, logits, weights)."""
        mean, log_var, logits, weights = self.p_mean_variance(
            y_t, y_cond, mask, angle, t, packed_idx)
        if t > 0:
            z = noise.to(mean.device, torch.float32) if noise is not None \
                else _randn(mean.shape, generator, mean.device)
            mean = mean + z * float(np.exp(_f32(0.5) * log_var))
        return mean, logits, weights

    def _frames(self, sample_num: int):
        """(frame interval, frames kept) of a T-step chain: every
        ``T // sample_num``-th step, counted down to t = 0."""
        T = self.schedule.num_timesteps
        if not T > sample_num:
            raise ValueError(f"num_timesteps {T} must be greater than "
                             f"sample_num {sample_num}")
        inter = T // sample_num
        return inter, (T - 1) // inter + 1

    def init_chain(self, y_cond, view_count, sample_num: int = 8, y_t=None,
                   capture_aux: bool = True,
                   generator: Optional[torch.Generator] = None) -> ChainCarry:
        """The initial carry of a (segmented) ancestral chain (JAX
        ``init_chain``): y_T drawn from ``generator`` unless given, and
        zeroed frame buffers with y_T as frame 0.  The logit and weight
        buffers exist when ``weighting_inference and capture_aux``."""
        b, n, h, w, _ = y_cond.shape
        dev = y_cond.device
        _, n_frames = self._frames(sample_num)
        if y_t is None:
            y_t = _randn((b, h, w, 3), generator, dev)
        y_t = y_t.to(dev, torch.float32)
        ret_arr = torch.zeros((n_frames + 1, b, h, w, 3), device=dev)
        ret_arr[0] = y_t
        aux = None
        if self.weighting_inference and capture_aux:
            aux = [torch.zeros((n_frames, b, n, h, w, 3), device=dev)
                   for _ in range(2)]
        return ChainCarry(y_t, ret_arr, *(aux or (None, None)), 0, generator)

    @torch.no_grad()
    def chain_segment(self, carry: ChainCarry, ts, y_cond, view_count,
                      angle, sample_num: int = 8, packed_idx=None,
                      noise: Optional[Sequence[torch.Tensor]] = None
                      ) -> ChainCarry:
        """Run the ancestral chain over the descending timesteps ``ts``
        from ``carry`` (JAX ``chain_segment``), keeping each frame at a
        timestep that is a multiple of the frame interval.  The steps, the
        draws and the frames are those of one :meth:`generate` call, so a
        chain run in segments equals it bit for bit.  ``noise`` holds the
        T per-step draws of the whole chain in the order they are used
        (``noise[T - 1 - t]`` at timestep t).  Updates ``carry`` in place
        and returns it."""
        inter, _ = self._frames(sample_num)
        T = self.schedule.num_timesteps
        y_cond = y_cond.to(self.unet.dtype)  # as _start: the UNet's cast
        mask = view_mask(view_count, y_cond.shape[1])
        angle = angle.reshape(-1)
        for t in ts:
            t = int(t)
            z = None if noise is None else noise[T - 1 - t]
            with tracing.span("sampler.step"):
                y, logits, weights = self.p_sample(
                    carry.y_t, y_cond, mask, angle, t, packed_idx, z,
                    carry.generator)
            carry.y_t = y
            if t % inter == 0:
                carry.ret_arr[carry.frame_idx + 1] = y
                if carry.logit_arr is not None:
                    carry.logit_arr[carry.frame_idx] = logits
                    carry.weight_arr[carry.frame_idx] = weights
                carry.frame_idx += 1
        return carry

    @staticmethod
    def finalize_chain(carry: ChainCarry) -> GenerateOutput:
        """Frame axes to batch-major (B, frames, ...), the reference's
        return contract (JAX ``finalize_chain``)."""
        ret_arr = carry.ret_arr.movedim(0, 1)
        move = (lambda a: None if a is None else a.movedim(0, 1))
        return GenerateOutput(carry.y_t, ret_arr, move(carry.logit_arr),
                              move(carry.weight_arr), ret_arr[:, -1])

    def generate(self, y_cond, view_count, angle, y_t=None,
                 sample_num: int = 8, packed_idx=None,
                 capture_aux: bool = True,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[Sequence[torch.Tensor]] = None
                 ) -> GenerateOutput:
        """The full T-step ancestral chain (JAX ``generate``): y_T (drawn
        from ``generator`` unless given), then t = T-1 .. 0, keeping every
        ``T // sample_num``-th frame and, when ``weighting_inference and
        capture_aux``, the logit and weight maps of those steps.
        ``noise`` holds the T per-step draws (the JAX scan's
        ``split(key)`` draws, in order)."""
        carry = self.init_chain(y_cond, view_count, sample_num, y_t,
                                capture_aux, generator)
        T = self.schedule.num_timesteps
        carry = self.chain_segment(carry, range(T - 1, -1, -1), y_cond,
                                   view_count, angle, sample_num,
                                   packed_idx, noise)
        return self.finalize_chain(carry)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def generate_ddim(self, y_cond, view_count, angle, num_steps: int = 50,
                      eta: float = 1.0, y_t=None,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[Sequence[torch.Tensor]] = None,
                      packed_idx=None):
        """DDIM over a strided subset of the trained schedule (JAX
        ``generate_ddim``).  eta=1 injects DDPM-scale noise per step,
        eta=0 is deterministic.  ``noise[i]`` (B, H, W, 3) replaces the
        draw of step i; ``packed_idx`` runs the UNet on packed rows.
        Returns the samples (B, H, W, 3) f32."""
        sched = self.schedule
        T = sched.num_timesteps
        if not 1 <= num_steps <= T:
            raise ValueError(f"num_steps must be in [1, {T}], got {num_steps}")
        ts = ddim_timesteps(T, num_steps)
        ts_prev = np.append(ts[1:], -1)
        y_cond, y_t, mask, angle = self._start(y_cond, view_count, angle,
                                               y_t, generator)
        for i, (t, t_prev) in enumerate(zip(ts, ts_prev)):
            with tracing.span("sampler.step"):
                gamma_t = sched.gammas[t]
                gamma_prev = (sched.gammas[t_prev] if t_prev >= 0
                              else _f32(1.0))
                eps = self._eps(y_cond, y_t, t, mask, angle, packed_idx)
                y0 = self._x0(y_t, eps, t)
                # re-derive eps from the clipped y0, as ancestral
                # sampling does
                eps = ((y_t - float(np.sqrt(gamma_t)) * y0)
                       / float(np.sqrt(_f32(1.0) - gamma_t)))
                sigma = _f32(eta) * np.sqrt(
                    (_f32(1.0) - gamma_prev) / (_f32(1.0) - gamma_t)
                    * (_f32(1.0) - gamma_t / gamma_prev))
                dir_coef = np.sqrt(np.maximum(
                    _f32(1.0) - gamma_prev - sigma ** 2, _f32(0.0)))
                y_next = (float(np.sqrt(gamma_prev)) * y0
                          + float(dir_coef) * eps)
                if t_prev >= 0 and sigma != 0:
                    y_next = y_next + float(sigma) * self._noise(
                        noise, i, y_t, generator)
                y_t = y_next
        return y_t

    @torch.no_grad()
    def generate_dpm(self, y_cond, view_count, angle, num_steps: int = 20,
                     y_t=None, generator: Optional[torch.Generator] = None,
                     grid: str = "lambda", sde: bool = False,
                     noise: Optional[Sequence[torch.Tensor]] = None,
                     packed_idx=None):
        """DPM-Solver++(2M) in the x0 parameterization (JAX
        ``generate_dpm``): the probability-flow ODE, or with ``sde`` its
        SDE variant with per-step noise (``noise[i]`` replaces the draw of
        step i; ``packed_idx`` runs the UNet on packed rows).  The last
        step jumps to the clean prediction.
        Returns the samples (B, H, W, 3) f32."""
        sched = self.schedule
        if not 2 <= num_steps <= sched.num_timesteps:
            raise ValueError(f"num_steps must be in [2, "
                             f"{sched.num_timesteps}], got {num_steps}")
        ts = dpm_timesteps(sched.gammas, num_steps, grid)
        ts_next = np.append(ts[1:], -1)
        y_cond, y, mask, angle = self._start(y_cond, view_count, angle,
                                             y_t, generator)
        x0_prev, h_prev = None, _f32(1.0)
        for i, (t, t_next) in enumerate(zip(ts, ts_next)):
            with tracing.span("sampler.step"):
                x0 = self._x0(y, self._eps(y_cond, y, t, mask, angle,
                                           packed_idx), t)
                g_cur = sched.gammas[t]
                g_next = sched.gammas[max(t_next, 0)]
                hh = _lam(g_next) - _lam(g_cur)
                if x0_prev is None:  # first step: first order
                    d = x0
                else:
                    c = hh / (_f32(2.0) * h_prev)
                    d = float(_f32(1.0) + c) * x0 - float(c) * x0_prev
                sigma_cur = np.sqrt(_f32(1.0) - g_cur)
                sigma_next = np.sqrt(_f32(1.0) - g_next)
                alpha_next = np.sqrt(g_next)
                if t_next < 0:
                    y = x0
                elif sde:
                    decay = np.exp(-hh)
                    mix = -np.expm1(_f32(-2.0) * hh)  # 1 - e^{-2h}
                    z = self._noise(noise, i, y, generator)
                    y = (float(sigma_next / sigma_cur * decay) * y
                         + float(alpha_next * mix) * d
                         + float(sigma_next * np.sqrt(mix)) * z)
                else:
                    y = (float(sigma_next / sigma_cur) * y
                         - float(alpha_next * np.expm1(-hh)) * d)
                x0_prev, h_prev = x0, hh
        return y
