"""The training step of the port (counterpart of the train step of
``viewfusion_tpu/training/trainer.py``).

``Trainer.train_step(batch)`` takes one host batch in the layout the JAX
trainer's ``_host_prep`` builds (``target``, ``cond``, ``angle``,
``view_count`` and, for the packed objective, ``sample_idx`` and
``view_idx``; images uint8 or float), computes the loss and every
parameter gradient, and makes one Adam update with optax's semantics:

  * ``torch.optim.Adam`` with b1 0.9, b2 0.999, eps 1e-8;
  * before update i the learning rate is ``lr_schedule(i)``, where i
    counts the updates already made (optax evaluates the schedule at its
    count before incrementing it), so under warmup the first update is
    exactly zero;
  * EMA shadow parameters ``decay * e + (1 - decay) * p`` after the
    update, when ``ema_decay > 0``;
  * with ``grad_accum = K`` the batch arrays carry a leading K axis of
    microbatches, and the update uses the sum of the K microbatch
    gradients divided by K (the loss likewise).

Parameters stay f32 (master weights); the UNet casts them to the compute
dtype per call.  The host helpers below are numpy copies of the JAX
trainer's, equal bit for bit: the stratified view-count multiset, the
packed row indices and the salted per-step counts.

Generation (the JAX trainer's sampler entry points) runs on the EMA
shadow when there is one (``_infer_model``) and picks the sampler from
``tpu.sampler``: the reference's ancestral chain (``ddpm``, in
``tpu.chain_segments`` segments), DDIM or DPM-Solver++ (``dpm``,
``dpm_sde``), on packed UNet rows when the batch carries them.  The JAX
trainer's ``(seed + 23, salt)`` key becomes a ``torch.Generator`` seeded
from both (:func:`salted_generator`).
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional

import numpy as np
import torch

from viewfusion_tpu_torch.config import Config
from viewfusion_tpu_torch.models.view_fusion import (GenerateOutput,
                                                     ViewFusion)
from viewfusion_tpu_torch.training.schedulers import lr_schedule

__all__ = ["Trainer", "norm_img", "stratified_count_multiset",
           "packed_indices", "global_packed_counts", "salted_generator"]


def norm_img(x: torch.Tensor) -> torch.Tensor:
    """uint8 images -> float32 in [0, 1] (the same IEEE divide as the JAX
    trainer's ``_norm_img``); float passes through."""
    if x.dtype == torch.uint8:
        return x.float() / 255.0
    return x


def stratified_count_multiset(b: int, max_views: int) -> np.ndarray:
    """The packed path's per-batch view-count multiset: each of
    1..max_views floor(b / max_views) times, the remainder filled by
    end-paired values (1, max_views, 2, max_views - 1, ...) so that the
    mean stays (max_views + 1) / 2 and sum(counts) is the same every
    batch."""
    counts = np.resize(np.arange(1, max_views + 1), b)
    r = b % max_views
    if r:
        lo, hi = 1, max_views
        tail = []
        while len(tail) < r:
            if r - len(tail) == 1:
                tail.append((max_views + 2) // 2)  # round(mean)
                break
            tail.append(lo)
            tail.append(hi)
            lo, hi = lo + 1, hi - 1
        counts[-r:] = tail
    return counts


def packed_indices(view_count: np.ndarray):
    """The valid (sample, view) pairs, (R,) int32 each, for loss_packed."""
    sample_idx = np.repeat(np.arange(len(view_count)), view_count)
    view_idx = np.concatenate([np.arange(v) for v in view_count])
    return sample_idx.astype(np.int32), view_idx.astype(np.int32)


def global_packed_counts(seed: int, salt: int, batch: int, max_views: int):
    """The packed batch's view counts and row indices, a function of
    (seed, salt) alone: the stratified multiset shuffled by a generator
    seeded ``[seed, 0x9E37, salt]``, with salt ``it * K + k`` for
    microbatch k of step it (single process).  Returns (counts (B,),
    sample_idx, view_idx)."""
    rng = np.random.default_rng([seed, 0x9E37, salt])
    counts = stratified_count_multiset(batch, max_views)
    rng.shuffle(counts)
    return (counts,) + packed_indices(counts)


def salted_generator(seed: int, salt: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from both ``seed`` and ``salt``
    (the counterpart of ``fold_in(PRNGKey(seed), salt)``)."""
    state = np.random.SeedSequence([seed, salt]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(state))


class Trainer:
    """The model, its Adam state, the EMA shadow and the step count.

    ``device`` is ``"cuda"`` unless the caller asks for the CPU; on the
    CPU the kernel wrappers run their plain versions.  The UNet starts
    from ``state_dict`` when given, else from a fresh flax-like init
    seeded by ``seed`` (default ``config.train.seed``), which also seeds
    the generator of the training draws."""

    def __init__(self, config: Config, device="cuda",
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 seed: Optional[int] = None):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer: no CUDA device; pass device='cpu' "
                               "to train on the CPU")
        tc = config.train
        seed = tc.seed if seed is None else seed
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.model = ViewFusion.from_config(config)
        if state_dict is not None:
            self.model.unet.load_state_dict(state_dict)
        self.model.unet.to(device).train()
        self.config, self.device = config, device
        self.params = list(self.model.unet.parameters())
        self.lr_fn = lr_schedule(peak_lr=tc.peak_lr, peak_it=tc.lr_warmup,
                                 decay_rate=tc.decay_rate,
                                 decay_it=tc.decay_it)
        self.optimizer = torch.optim.Adam(self.params, lr=0.0,
                                          betas=(0.9, 0.999), eps=1e-8)
        # the EMA shadow is a second UNet, so that generation can run on
        # it (_infer_model); self.ema lists its parameters
        self.ema, self.ema_model = None, None
        if tc.ema_decay > 0:
            shadow = copy.deepcopy(self.model.unet).requires_grad_(False)
            self.ema = list(shadow.parameters())
            m = self.model
            self.ema_model = ViewFusion(
                shadow, m.schedule, weighting_train=m.weighting_train,
                weighting_inference=m.weighting_inference)
        self.step = 0  # updates made
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self.cond_key = "relative_cond" if config.relative else "cond"
        self.angle_key = "relative_angle" if config.relative else "angle"

    def _put(self, a) -> torch.Tensor:
        if not isinstance(a, torch.Tensor):
            a = np.ascontiguousarray(a)
            a = torch.from_numpy(a if a.flags.writeable else a.copy())
        return a.to(self.device)

    def _microbatch_loss(self, mb: Dict[str, Any], noise, sample_gammas):
        put = self._put
        args = (norm_img(put(mb["target"])), norm_img(put(mb[self.cond_key])),
                put(mb["view_count"]).long(),
                put(mb[self.angle_key]).float().reshape(-1))
        kw = dict(noise=None if noise is None else put(noise).float(),
                  sample_gammas=(None if sample_gammas is None
                                 else put(sample_gammas).float()),
                  generator=self.generator)
        if self.config.train.packed_views:
            return self.model.loss_packed(
                *args, put(mb["sample_idx"]).long(),
                put(mb["view_idx"]).long(), **kw)
        return self.model.loss(*args, **kw)

    def train_step(self, batch: Dict[str, Any], noise=None,
                   sample_gammas=None) -> torch.Tensor:
        """One optimizer update on ``batch`` (see the module docstring).
        ``noise`` (B, H, W, 3) and ``sample_gammas`` (B,), with the same
        leading K axis as the batch under grad accumulation, replace the
        training draws.  Returns the (mean) loss, a detached f32 scalar
        on the device."""
        n_micro = self.config.train.grad_accum
        self.optimizer.zero_grad(set_to_none=True)
        total = None
        for k in range(n_micro):
            pick = (lambda a: a) if n_micro == 1 else \
                (lambda a: None if a is None else a[k])
            loss = self._microbatch_loss(
                {key: pick(v) for key, v in batch.items()}, pick(noise),
                pick(sample_gammas))
            loss.backward()
            total = loss.detach() if total is None else total + loss.detach()
        if n_micro > 1:
            for p in self.params:
                p.grad.div_(n_micro)
        self.apply_update()
        return total / n_micro if n_micro > 1 else total

    @torch.no_grad()
    def apply_update(self) -> None:
        """One Adam update (and EMA) from the gradients in ``.grad``."""
        lr = self.lr_fn(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        if self.ema is not None:
            decay = self.config.train.ema_decay
            torch._foreach_mul_(self.ema, decay)
            torch._foreach_add_(self.ema,
                                torch._foreach_mul(self.params, 1.0 - decay))
        self.step += 1

    # ------------------------------------------------------------------
    # generation (the JAX trainer's sampler entry points)
    # ------------------------------------------------------------------
    @property
    def _infer_model(self) -> ViewFusion:
        """The model generation runs: the EMA shadow when enabled."""
        return self.ema_model if self.ema_model is not None else self.model

    def _eval_samples(self, generator: torch.Generator,
                      batch: Dict[str, Any]) -> torch.Tensor:
        """Eval-time generation on a host batch (``cond``, ``view_count``,
        ``angle`` and, for packed rows, ``sample_idx``/``view_idx``): the
        reference's ancestral chain by default (``tpu.sampler: ddpm``, in
        ``tpu.chain_segments`` segments, no frame capture), DDIM, or
        DPM-Solver++.  Returns the samples (B, H, W, 3) f32 on the
        device."""
        put, tc = self._put, self.config.train
        cond = norm_img(put(batch[self.cond_key]))
        vc = put(batch["view_count"]).long()
        angle = put(batch[self.angle_key]).float().reshape(-1)
        packed_idx = None
        if "sample_idx" in batch:
            packed_idx = (put(batch["sample_idx"]).long(),
                          put(batch["view_idx"]).long())
        if tc.sampler != "ddpm":
            return self._fast_sample(generator, cond, vc, angle, packed_idx)
        return self._generate_segmented(
            generator, cond, vc, angle, tc.chain_segments,
            packed_idx=packed_idx, capture_aux=False).generated_samples

    def _fast_sample(self, generator, cond, view_count, angle,
                     packed_idx=None) -> torch.Tensor:
        """DDIM (``tpu.sampler: ddim``) or DPM-Solver++ (``dpm``,
        ``dpm_sde``) with the config's step counts."""
        tc, model = self.config.train, self._infer_model
        if tc.sampler == "ddim":
            return model.generate_ddim(
                cond, view_count, angle, num_steps=tc.ddim_steps,
                eta=tc.ddim_eta, generator=generator, packed_idx=packed_idx)
        return model.generate_dpm(
            cond, view_count, angle, num_steps=tc.dpm_steps,
            sde=tc.sampler == "dpm_sde", generator=generator,
            packed_idx=packed_idx)

    def _gen_inputs(self, cond, view_count, angle, key_salt: int):
        """Shared generation prologue: the ``(seed + 23, salt)`` generator
        and the inputs on the device, so the same salt gives the same
        chain through every sampler."""
        gen = salted_generator(self.config.train.seed + 23, key_salt,
                               self.device)
        return (gen, norm_img(self._put(cond)),
                self._put(view_count).long(),
                self._put(angle).float().reshape(-1))

    def _generate_np(self, cond, view_count, angle,
                     key_salt: int = 0) -> GenerateOutput:
        """The ancestral chain with frame capture (``tpu.chain_segments``
        segments), numpy in and out."""
        gen, cond, view_count, angle = self._gen_inputs(
            cond, view_count, angle, key_salt)
        out = self._generate_segmented(gen, cond, view_count, angle,
                                       self.config.train.chain_segments)
        return GenerateOutput(*(None if a is None else a.cpu().numpy()
                                for a in out))

    def _sample_only_np(self, cond, view_count, angle,
                        key_salt: int = 0) -> np.ndarray:
        """Final samples through the configured sampler (``tpu.sampler``),
        numpy in and out."""
        if self.config.train.sampler == "ddpm":
            return self._generate_np(cond, view_count, angle,
                                     key_salt=key_salt).generated_samples
        return self._fast_sample(*self._gen_inputs(
            cond, view_count, angle, key_salt)).cpu().numpy()

    def _generate_segmented(self, generator, cond, view_count, angle,
                            segs: int, packed_idx=None,
                            capture_aux: bool = True) -> GenerateOutput:
        """The ancestral chain as ``segs`` segments of about T / segs
        steps (``tpu.chain_segments``): the same steps and draws as one
        ``generate`` call, which is what one segment is."""
        model = self._infer_model
        sample_num = self.config.train.sample_num
        T = model.schedule.num_timesteps
        carry = model.init_chain(cond, view_count, sample_num=sample_num,
                                 capture_aux=capture_aux, generator=generator)
        bounds = np.linspace(T, 0, segs + 1).round().astype(int)
        for hi, lo in zip(bounds[:-1], bounds[1:]):
            carry = model.chain_segment(
                carry, range(int(hi) - 1, int(lo) - 1, -1), cond,
                view_count, angle, sample_num=sample_num,
                packed_idx=packed_idx)
        return model.finalize_chain(carry)
