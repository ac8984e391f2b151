"""The training step and the experiment loop of the port (counterpart of
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
dtype per call.  Host batches reach the card by ``to_device``'s pinned copy.

More than one process (``torchrun``; ``parallel/mesh.py`` says how the
ranks form a ``data x view`` grid): each rank is given its rows of the
global batch.  The UNet runs under ``DistributedDataParallel``
(``broadcast_buffers=False``; every microbatch but the last of a
``grad_accum`` step inside ``no_sync``), so the gradients are averaged
over all ranks; ``self.model.unet`` stays the bare module, and its names
are the ones checkpoints, the EMA and the converters see.  Every rank
draws t, u and the noise for the global batch from ``self.generator``
(the same seed everywhere) and keeps its rows, so a W-rank step equals
the one-process step at the same global batch up to summation order.
With ``tpu.mesh_view > 1`` the ranks of a view group split their data
rank's UNet rows and gather the outputs with autograd (``_ViewSplit``);
each composes and takes the loss of the whole slice, the gather's
backward multiplies each rank's gradient by ``view``, and DDP's mean
over ``data * view`` ranks leaves the mean over the data ranks.  The
returned loss is the mean over all ranks.  ``tpu.shard_opt_state``
partitions Adam's m and v over the data group (``parallel/zero1.py``).

Dropout (``dropout > 0``) is on in the dense loss only, as in JAX, with
masks from ``self.generator`` (one process) or a generator of the rank's
own, seeded from it, the step and the rank (more than one).

The host helpers below are numpy copies of the JAX trainer's, equal bit
for bit: the stratified view-count multiset, the packed row indices and
the salted per-step counts.

Generation (the JAX trainer's sampler entry points) runs on the EMA
shadow when there is one (``_infer_model``) and picks the sampler from
``tpu.sampler``: the reference's ancestral chain (``ddpm``, in
``tpu.chain_segments`` segments), DDIM or DPM-Solver++ (``dpm``,
``dpm_sde``), on packed UNet rows when the batch carries them.  The JAX
trainer's ``(seed + 23, salt)`` key becomes a ``torch.Generator`` seeded
from both (:func:`salted_generator`).

:class:`Experiment` is the JAX ``Experiment`` on this ``Trainer``: the
run dir, the checkpoint files of the JAX layout, the data streams, the
train loop with its checkpoint, log and validation gates, eval with the
best-model files, and the inference modes.
"""

from __future__ import annotations

import contextlib
import copy
import datetime
import os
import queue
import signal
import sys
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from viewfusion_tpu_torch import tracing
from viewfusion_tpu_torch.config import Config, load_config
from viewfusion_tpu_torch.data.nmr import Batcher, create_nmr_stream, prefetch
from viewfusion_tpu_torch.models.view_fusion import (GenerateOutput,
                                                     RowSlice, ViewFusion)
from viewfusion_tpu_torch.ops.metrics import compute_psnr, compute_ssim
from viewfusion_tpu_torch.parallel.collectives import all_gather
from viewfusion_tpu_torch.parallel.mesh import (MeshSpec, RankGrid,
                                                initialize_distributed,
                                                make_mesh)
from viewfusion_tpu_torch.parallel.zero1 import Zero1Adam
from viewfusion_tpu_torch.training import fused_feed
from viewfusion_tpu_torch.training.checkpoint import Checkpoint
from viewfusion_tpu_torch.training.logging import MetricLogger
from viewfusion_tpu_torch.training.schedulers import lr_schedule
from viewfusion_tpu_torch.utils.convert import (jax_layout_axes,
                                                load_trainer_state,
                                                trainer_state_to_jax)
from viewfusion_tpu_torch.utils.device import to_device
from viewfusion_tpu_torch.utils.image import make_grid, save_png, to_uint8

__all__ = ["Trainer", "Experiment", "ExperimentArgs", "norm_img",
           "stratified_count_multiset", "packed_indices",
           "global_packed_counts", "salted_generator"]


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


def global_packed_counts(seed: int, salt: int, batch: int, max_views: int,
                         host_id: int = 0, num_hosts: int = 1):
    """The packed batch's view counts and row indices, a function of
    (seed, salt) alone: the stratified multiset of the global batch
    (``batch * num_hosts`` samples) shuffled by a generator seeded
    ``[seed, 0x9E37, salt]``, with salt ``it * K + k`` for microbatch k
    of step it.  Returns (counts, sample_idx, view_idx) of host
    ``host_id``'s ``batch`` samples ``[h * batch, (h + 1) * batch)``; the
    row indices enumerate this host's samples."""
    rng = np.random.default_rng([seed, 0x9E37, salt])
    counts = stratified_count_multiset(batch * num_hosts, max_views)
    rng.shuffle(counts)
    local = counts[host_id * batch:(host_id + 1) * batch]
    return (local,) + packed_indices(local)


def salted_generator(seed: int, salt: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from both ``seed`` and ``salt``
    (the counterpart of ``fold_in(PRNGKey(seed), salt)``)."""
    state = np.random.SeedSequence([seed, salt]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(state))


class _ViewSplit:
    """The denoiser on this rank's share of the view group's rows: the
    rows, padded to a multiple of ``view`` with copies of the last, are
    split in rank order; the outputs are gathered back, with autograd,
    and the padding cut."""

    def __init__(self, denoiser, grid: RankGrid):
        self.denoiser, self.grid = denoiser, grid

    def __call__(self, x, angle, level, **kw):
        r, g = x.shape[0], self.grid
        per = -(-r // g.view)
        idx = torch.arange(g.view_rank * per, (g.view_rank + 1) * per,
                           device=x.device).clamp_(max=r - 1)
        out = self.denoiser(x[idx], angle[idx], level[idx], **kw)
        return all_gather(out, g.view_group)[:r]


class Trainer:
    """The model, its Adam state, the EMA shadow and the step count.

    ``device`` is ``"cuda"`` unless the caller asks for the CPU; on the
    CPU the kernel wrappers run their plain versions.  The UNet starts
    from ``state_dict`` when given, else from a fresh flax-like init
    seeded by ``seed`` (default ``config.train.seed``), which also seeds
    the generator of the training draws.  Under an initialised process
    group, ``mesh`` (default: the grid of ``tpu.mesh_data`` and
    ``tpu.mesh_view``) places this rank, and ``train_step`` takes the
    rank's rows of each batch."""

    def __init__(self, config: Config, device="cuda",
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 seed: Optional[int] = None,
                 mesh: Optional[RankGrid] = None):
        with tracing.span("setup.model"):
            device = torch.device(device)
            if device.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError("Trainer: no CUDA device; pass "
                                   "device='cpu' to train on the CPU")
            tc = config.train
            seed = tc.seed if seed is None else seed
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(seed)
                self.model = ViewFusion.from_config(config)
            if state_dict is not None:
                self.model.unet.load_state_dict(state_dict)
            self.model.unet.to(device).train()
            self.config, self.device = config, device
            self.mesh = mesh if mesh is not None else make_mesh(
                MeshSpec(tc.mesh_data, tc.mesh_view),
                batch_rows=config.data.batch_size // tc.grad_accum)
            # what the train step calls: DDP (and the view split) over the
            # bare UNet under a process group, else the UNet itself
            self._ddp = self._denoiser = None
            if dist.is_initialized():
                self._ddp = self._denoiser = DistributedDataParallel(
                    self.model.unet, broadcast_buffers=False)
                if self.mesh.view > 1:
                    self._denoiser = _ViewSplit(self._ddp, self.mesh)
            self.params = list(self.model.unet.parameters())
            self.lr_fn = lr_schedule(peak_lr=tc.peak_lr, peak_it=tc.lr_warmup,
                                     decay_rate=tc.decay_rate,
                                     decay_it=tc.decay_it)
            self.zero1 = None
            if tc.shard_opt_state:
                named = list(self.model.unet.named_parameters())
                self.zero1 = Zero1Adam(named, jax_layout_axes(
                    [n for n, _ in named]), self.mesh)
                self.optimizer = self.zero1.optimizer
            else:
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

    def _microbatch_loss(self, mb: Dict[str, torch.Tensor], noise,
                         sample_gammas, masks=None):
        if "img" in mb:  # the fused feed: slices and a same-size bitcast
            mb = fused_feed.unpack_batch(mb)
        target = norm_img(mb["target"])
        args = (target, norm_img(mb[self.cond_key]),
                mb["view_count"].long(),
                mb[self.angle_key].float().reshape(-1))
        mesh = self.mesh
        if mesh.data > 1 and noise is None and sample_gammas is None:
            # the global batch's draws, this rank's rows
            b, lo = target.shape[0], mesh.data_rank * target.shape[0]
            noise, sample_gammas = (d[lo:lo + b] for d in
                                    self.model.training_draws(
                                        (b * mesh.data,) + target.shape[1:],
                                        self.generator, self.device))
        kw = dict(noise=None if noise is None else noise.float(),
                  sample_gammas=(None if sample_gammas is None
                                 else sample_gammas.float()),
                  generator=self.generator, denoiser=self._denoiser)
        if self.config.train.packed_views:
            return self.model.loss_packed(
                *args, mb["sample_idx"].long(), mb["view_idx"].long(), **kw)
        if getattr(self.model.unet, "dropout", 0.0) > 0:
            kw["dropout"] = masks if masks is not None else self._dropout_gen
        return self.model.loss(*args, **kw)

    def train_step(self, batch: Dict[str, Any], noise=None,
                   sample_gammas=None, masks=None) -> torch.Tensor:
        """One optimizer update on ``batch`` (see the module docstring).
        ``noise`` (B, H, W, 3) and ``sample_gammas`` (B,), with the same
        leading K axis as the batch under grad accumulation, replace the
        training draws; ``masks`` (by module name, see
        ``models/unet.py``) replaces the dense loss's dropout draws.
        Under grad accumulation a batch value may also be a list of the
        K microbatches' arrays (packed rows differ in length between a
        rank's microbatches).  Returns the (mean) loss over all ranks, a
        detached f32 scalar on the device.  The step is a ``train.step``
        span keyed by the updates made before it, its phases spans under
        it."""
        with tracing.span("train.step", key=self.step):
            n_micro = self.config.train.grad_accum
            for p in self.params:
                p.grad = None
            self._dropout_gen = self.generator
            if (self.mesh.world > 1
                    and getattr(self.model.unet, "dropout", 0) > 0):
                state = np.random.SeedSequence(
                    [self.generator.initial_seed(), self.step,
                     self.mesh.rank])
                self._dropout_gen = torch.Generator(device=self.device)
                self._dropout_gen.manual_seed(int(state.generate_state(1)[0]))
            total = None
            for k in range(n_micro):
                pick = (lambda a: a) if n_micro == 1 else \
                    (lambda a: None if a is None else a[k])
                last = k == n_micro - 1
                with (self._ddp.no_sync() if self._ddp is not None and not last
                      else contextlib.nullcontext()):
                    with tracing.span("train.h2d"):
                        mb, mb_noise, mb_gammas = to_device(
                            ({key: pick(v) for key, v in batch.items()},
                             pick(noise), pick(sample_gammas)), self.device)
                    with tracing.span("train.forward"):
                        loss = self._microbatch_loss(mb, mb_noise, mb_gammas,
                                                     pick(masks))
                    with tracing.span("train.backward"):
                        loss.backward()
                total = (loss.detach() if total is None
                         else total + loss.detach())
            if n_micro > 1:
                for p in self.params:
                    p.grad.div_(n_micro)
                total = total / n_micro
            self.apply_update()
            if self.mesh.world > 1:
                with tracing.span("train.allreduce"):
                    dist.all_reduce(total)
                    total /= self.mesh.world
            return total

    @torch.no_grad()
    def apply_update(self) -> None:
        """One Adam update (and EMA) from the gradients in ``.grad``."""
        lr = self.lr_fn(self.step)
        with tracing.span("train.optimizer"):
            if self.zero1 is not None:
                self.zero1.step(lr)
            else:
                for group in self.optimizer.param_groups:
                    group["lr"] = lr
                self.optimizer.step()
        if self.ema is not None:
            with tracing.span("train.ema"):
                decay = self.config.train.ema_decay
                torch._foreach_mul_(self.ema, decay)
                torch._foreach_add_(self.ema, torch._foreach_mul(
                    self.params, 1.0 - decay))
        self.step += 1

    def adam_moments(self):
        """Adam's m and v, whole, by parameter name: (exp_avg, exp_avg_sq)
        dicts, zeros before the first update.  Under ZeRO-1 they are
        gathered over the data group: every rank must call it."""
        if self.zero1 is not None:
            return self.zero1.full_moments()
        st = self.optimizer.state
        named = list(self.model.unet.named_parameters())
        return tuple({n: st[p][key] if p in st else torch.zeros_like(p)
                      for n, p in named} for key in ("exp_avg", "exp_avg_sq"))

    @torch.no_grad()
    def load_adam_moments(self, count: int, mu: Dict[str, torch.Tensor],
                          nu: Dict[str, torch.Tensor]) -> None:
        """Set Adam's state to whole m and v after ``count`` updates (a
        fresh state at 0); under ZeRO-1 this rank keeps its slices."""
        if self.zero1 is not None:
            self.zero1.load_moments(count, mu, nu)
            return
        st = self.optimizer.state
        st.clear()
        if count > 0:
            for name, p in self.model.unet.named_parameters():
                st[p] = {"step": torch.tensor(float(count)),
                         "exp_avg": mu[name].to(p.device),
                         "exp_avg_sq": nu[name].to(p.device)}

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
        tc = self.config.train
        keys = [self.cond_key, "view_count", self.angle_key]
        keys += [k for k in ("sample_idx", "view_idx") if k in batch]
        dev = to_device({k: batch[k] for k in keys}, self.device)
        cond = norm_img(dev[self.cond_key])
        vc = dev["view_count"].long()
        angle = dev[self.angle_key].float().reshape(-1)
        packed_idx = ((dev["sample_idx"].long(), dev["view_idx"].long())
                      if "sample_idx" in dev else None)
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
        cond, view_count, angle = to_device((cond, view_count, angle),
                                            self.device)
        return (gen, norm_img(cond), view_count.long(),
                angle.float().reshape(-1))

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


# ----------------------------------------------------------------------
# The experiment loop (counterpart of the JAX ``Experiment``)
# ----------------------------------------------------------------------
_STATE_FIELDS = ("params", "opt_state", "step", "ema_params")


@dataclass
class ExperimentArgs:
    """The CLI's flags (``cli.py``); ``device`` is ``"cuda"`` unless the
    caller asks for the CPU."""

    config: Optional[str] = None
    src: Optional[str] = None
    train: bool = False
    eval: bool = False
    resume: bool = False
    inference: bool = False
    wandb: bool = False
    autoregressive: bool = False
    generate_gifs: bool = False
    extrapolate: bool = False
    gpu: bool = False  # accepted for the reference CLI; see ``device``
    device: str = "cuda"


def _stack(micro: List[Dict[str, np.ndarray]]) -> Dict[str, Any]:
    """K microbatches on a leading axis; a key whose arrays differ in
    shape (a rank's packed rows) stays a list of the K arrays."""
    return {k: (np.stack([m[k] for m in micro])
                if len({m[k].shape for m in micro}) == 1
                else [m[k] for m in micro]) for k in micro[0]}


class Experiment:
    """Train / eval / inference over a run dir, as the JAX ``Experiment``
    does, on the port's :class:`Trainer`.

    The run dir (``./logs/<time>-<config name>`` for ``-t``, else ``-s``)
    holds ``config.yaml``, the rolling ``model.msgpack``, the
    ``best_model_{ssim,psnr,all}.msgpack`` files, ``metrics.jsonl`` and
    the images and GIFs: the JAX package's layout and file formats, so
    either package continues the other's run.  ``-t``/``-r`` load
    ``model.msgpack``, ``-e``/``-i`` load ``best_model_all.msgpack``.

    More than one process (``torchrun``): the ranks form the trainer's
    ``data x view`` grid.  Rank 0 names the run dir and alone writes
    files and talks to wandb; each data rank reads its ``1 / data`` of
    the shards and trains on ``batch_size // data`` samples; the eval
    sums are added over the data group; the vis grid and the ``-i``
    modes run on rank 0 while the others wait; a SIGTERM on any rank
    stops every rank at the same step.  Every collective is issued from
    the main thread, in the same order on every rank."""

    def __init__(self, args, log_root: str = "./logs"):
        self.args = args
        self.log_dict: Dict[str, Any] = {}
        device = initialize_distributed(args.device)
        new_run = not (args.inference or args.resume or args.eval)
        if not new_run:
            if args.src is None:
                raise ValueError(
                    "Source directory (-s, --src) must be provided.")
            self.out_dir = str(Path(args.src))
            exp_name = os.path.basename(os.path.normpath(args.src))
            self.config = load_config(os.path.join(args.src, "config.yaml"))
        else:
            self.config = load_config(args.config)
        cfg = self.config
        if cfg.train.fused_feed and (not cfg.train.packed_views
                                     or cfg.relative):
            raise ValueError(
                "tpu.fused_feed requires tpu.packed_views and absolute "
                "conditioning (training/fused_feed.py)")
        self.trainer = Trainer(cfg, device=device)
        self.device = self.trainer.device
        self.mesh = mesh = self.trainer.mesh
        self.is_host0 = mesh.is_host0
        if new_run:  # rank 0's clock names the run dir
            now = [datetime.datetime.now().strftime("%Y-%m-%dT%H-%M-%S")]
            if mesh.world > 1:
                dist.broadcast_object_list(now, src=0,
                                           group=mesh.host_group)
            config_name = os.path.splitext(os.path.basename(args.config))[0]
            exp_name = "-".join((now[0], config_name))
            self.out_dir = os.path.join(log_root, exp_name)
        self.exp_name = exp_name
        # as JAX seeds with seed + process_index: the ranks of one view
        # group share their data rank's draws
        self.rng = np.random.default_rng(cfg.train.seed + mesh.data_rank)
        self.max_views = cfg.data.max_views
        self.relative = cfg.relative
        self.cond_key = self.trainer.cond_key
        self.angle_key = self.trainer.angle_key
        self.last_profile = None  # (profiler, wall seconds, steps)
        self._prof = None
        self._init_model()
        self._init_dataloaders()
        self.logger = MetricLogger(self.out_dir, use_wandb=args.wandb,
                                   run_id=self.run_id, exp_name=exp_name,
                                   config=cfg.raw, is_host0=self.is_host0)
        self.run_id = self.logger.run_id

    # ------------------------------------------------------------------
    def _init_model(self) -> None:
        cfg = self.config
        self.checkpoint = Checkpoint(self.out_dir, config_yaml=cfg.to_yaml(),
                                     is_host0=self.is_host0)
        if self.args.train or self.args.resume:
            ckpt_name = "model.msgpack"
        else:
            ckpt_name = "best_model_all.msgpack"
        load_dict: Dict[str, Any] = {}
        if not self.checkpoint.exists(ckpt_name) and (
                self.args.eval or self.args.inference) and not self.args.train:
            raise FileNotFoundError(
                f"{ckpt_name} not found in {self.out_dir}; run training "
                "first or point -s at a run with a best checkpoint")
        if self.checkpoint.exists(ckpt_name):
            template = dict.fromkeys(_STATE_FIELDS)
            state, load_dict = self.checkpoint.load(ckpt_name, template)
            try:
                load_trainer_state(
                    self.trainer, state,
                    [f for f in _STATE_FIELDS
                     if f not in self.checkpoint.last_missing])
            except (KeyError, ValueError):
                # the fields do not fit this model (e.g. an EMA config
                # reading a run saved without EMA): params alone, with a
                # fresh optimizer state, as the JAX Experiment does
                load_trainer_state(self.trainer, state, ["params"])
            if self.is_host0:
                print(f"Loaded checkpoint {ckpt_name}.")
        self.it = load_dict.get("it", -1)
        self.time_elapsed = load_dict.get("t", 0.0)
        self.run_id = load_dict.get("run_id", None)
        self.best_metrics = {"ssim": load_dict.get("ssim", -np.inf),
                             "psnr": load_dict.get("psnr", -np.inf)}

    def _save_ckpt(self, filename: str, **extra) -> None:
        """Save the trainer's state, through the async writer unless
        ``tpu.async_checkpoint`` is off.  Every rank calls it: the state
        is gathered whole (ZeRO-1) before rank 0 alone writes."""
        state = trainer_state_to_jax(self.trainer)
        if self.config.train.async_checkpoint:
            self.checkpoint.save_async(filename, state, **extra)
        else:
            self.checkpoint.save(filename, state, **extra)

    # ------------------------------------------------------------------
    def _init_dataloaders(self) -> None:
        cfg, mesh = self.config, self.mesh
        # each data rank reads 1/data of the shards and its rows of the
        # batch; the ranks of a view group read the same
        hosts = dict(host_id=mesh.data_rank, num_hosts=mesh.data)
        self.local_batch_size = cfg.data.batch_size // mesh.data
        n_micro = cfg.train.grad_accum
        if self.local_batch_size % n_micro:
            raise ValueError(
                f"tpu.grad_accum={n_micro} must divide the per-rank "
                f"batch {self.local_batch_size} "
                f"(data.batch_size // {mesh.data} data ranks)")
        self.micro_batch_size = self.local_batch_size // n_micro
        seed = cfg.train.seed
        native_threads = cfg.train.native_threads
        if ("native_threads" not in cfg.raw.get("tpu", {})
                and cfg.data.num_workers > 1):
            native_threads = cfg.data.num_workers
            if self.is_host0:
                print(f"data.num_workers={cfg.data.num_workers} -> "
                        f"{native_threads} native decode threads")
        out_dtype = np.uint8 if cfg.train.u8_feed else np.float32
        keys = ["target", self.cond_key, self.angle_key]

        self.train_loader: Optional[Iterator] = None
        self.train_stream = None
        if self.args.train:
            self.train_stream = create_nmr_stream(
                cfg.data.train, shuffle_buffer=1000, seed=seed, **hosts,
                resample=True, relative=self.relative,
                native=cfg.train.native_loader,
                native_threads=native_threads, needed_keys=keys,
                n_cond_views=self.max_views, out_dtype=out_dtype)
            self.train_loader = prefetch(
                iter(Batcher(self.train_stream, self.micro_batch_size,
                             n_cond_views=self.max_views, keys=keys)),
                depth=2 * n_micro)

        self.epoch_size = max(1, cfg.data.test.size // self.local_batch_size)
        exact = cfg.train.eval_exact_epoch
        if exact and mesh.data > 1:
            raise ValueError(
                "tpu.eval_exact_epoch requires a single process: per-host "
                "shard subsets drain at different batch counts, which "
                "would deadlock the global-array eval collectives")

        def val_loader():
            stream = create_nmr_stream(
                cfg.data.test, shuffle_buffer=0, seed=seed + 1, **hosts,
                resample=not exact, relative=self.relative,
                native=cfg.train.native_loader,
                native_threads=native_threads, needed_keys=keys,
                n_cond_views=self.max_views, out_dtype=out_dtype)
            it = iter(Batcher(stream, self.local_batch_size,
                              n_cond_views=self.max_views, keys=keys,
                              pad_final=exact))
            if exact:  # one pass over the shards, each sample once
                yield from it
            else:  # the first epoch_size batches of the resampled stream
                for _ in range(self.epoch_size):
                    yield next(it)

        self.val_loader = val_loader
        # tpu.eval_train_split: a held-in pass over the train shards with
        # test-time sample semantics, logged as ssim_train/psnr_train
        self.train_eval_loader = None
        if cfg.train.eval_train_split and self.args.train:
            def train_eval_loader():
                stream = create_nmr_stream(
                    cfg.data.train, shuffle_buffer=0, seed=seed + 3, **hosts,
                    resample=True, relative=self.relative,
                    process_mode="test", native=cfg.train.native_loader,
                    native_threads=native_threads, needed_keys=keys,
                    n_cond_views=self.max_views, out_dtype=out_dtype)
                it = iter(Batcher(stream, self.local_batch_size,
                                  n_cond_views=self.max_views, keys=keys))
                for _ in range(self.epoch_size):
                    yield next(it)

            self.train_eval_loader = train_eval_loader
        # the fixed 12-sample visualization batch, drawn once
        vis_stream = create_nmr_stream(
            cfg.data.test, shuffle_buffer=0, seed=seed + 2, resample=True,
            relative=self.relative, native=cfg.train.native_loader,
            native_threads=native_threads)
        self.val_vis_data = next(iter(Batcher(vis_stream, batch_size=12)))

    # ------------------------------------------------------------------
    def _host_prep(self, batch: Dict[str, np.ndarray],
                   view_count: np.ndarray, packed_idx=None,
                   fused: bool = False) -> Dict[str, np.ndarray]:
        prepped = {
            "target": batch["target"],
            self.cond_key: batch[self.cond_key],
            self.angle_key: np.asarray(batch[self.angle_key]).reshape(-1),
            "view_count": view_count.astype(np.int32),
        }
        if "eval_mask" in batch:
            prepped["eval_mask"] = batch["eval_mask"]
        if packed_idx is not None:
            prepped["sample_idx"], prepped["view_idx"] = packed_idx
        if fused:  # 3 host-to-device copies instead of 6 (tpu.fused_feed)
            prepped = fused_feed.pack_batch(prepped)
        return prepped

    def _sample_view_count(self, n: int) -> np.ndarray:
        """view_count ~ U{1..max_views} per sample."""
        return self.rng.integers(1, self.max_views + 1, (n,))

    def _packed_counts(self, salt: int, batch: Optional[int] = None):
        """This data rank's counts of the global packed batch of salt
        ``salt`` (``batch`` samples per rank, default the per-rank
        batch) and its own packed rows."""
        return global_packed_counts(
            self.config.train.seed, salt,
            self.local_batch_size if batch is None else batch,
            self.max_views, self.mesh.data_rank, self.mesh.data)

    def _device_feed(self, first_it: int, depth: int = 2):
        """Packed path: a thread derives each step's view counts (a
        function of (seed, it) alone), assembles the batch and sends it
        to the device on its own stream, keeping ``depth`` steps ahead;
        the consumer waits on the copy's event before using it."""
        q: "queue.Queue" = queue.Queue(maxsize=depth)
        stop = object()
        cuda = self.device.type == "cuda"
        side = torch.cuda.Stream(self.device) if cuda else None
        n_micro = self.config.train.grad_accum
        fused = self.config.train.fused_feed

        def worker():
            it = first_it
            try:
                micro = []
                for batch in self.train_loader:
                    vc, si, vi = self._packed_counts(
                        it * n_micro + len(micro), self.micro_batch_size)
                    micro.append(self._host_prep(batch, vc, (si, vi),
                                                 fused=fused))
                    if len(micro) < n_micro:
                        continue
                    host = micro[0] if n_micro == 1 else _stack(micro)
                    dev = to_device(host, self.device, side)
                    event = None
                    if cuda:
                        event = torch.cuda.Event()
                        event.record(side)
                    q.put((dev, event))
                    micro = []
                    it += 1
                q.put(stop)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                q.put(e)

        threading.Thread(target=worker, daemon=True,
                         name="device-feed").start()
        it = first_it
        while True:
            with tracing.span("experiment.feed_wait", key=it):
                item = q.get()
            it += 1
            if item is stop:
                return
            if isinstance(item, BaseException):
                raise item
            batch, event = item
            if event is not None:
                main = torch.cuda.current_stream(self.device)
                main.wait_event(event)
                for v in batch.values():  # freed only after main's use
                    for t in (v if isinstance(v, list) else [v]):
                        t.record_stream(main)
            yield batch

    # ------------------------------------------------------------------
    def train(self) -> None:
        summary_best = self.logger.best_metric_summary()
        if summary_best is not None:
            self.best_metrics.update(summary_best)
        # SIGTERM asks for a final rolling checkpoint at the next step
        self._stop_requested = False

        def _request_stop(signum, frame):
            self._stop_requested = True

        try:
            prev_handler = signal.signal(signal.SIGTERM, _request_stop)
        except ValueError:  # not the main thread
            prev_handler = None
        try:
            self._train_loop(self.config.train)
        finally:
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)
            # queued saves reach the disk on any exit; a writer error is
            # swallowed only while another exception unwinds
            unwinding = sys.exc_info()[0] is not None
            try:
                self.checkpoint.flush()
            except RuntimeError:
                if not unwinding:
                    raise

    def _profile(self, cfg) -> None:
        """Start or stop ``torch.profiler`` at ``tpu.profile_from`` and
        ``profile_from + profile_steps``; the trace goes to
        ``<run>/profile``."""
        if cfg.profile_steps <= 0 or not self.is_host0:
            return
        if self.it == cfg.profile_from:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
            self._prof_t0 = time.perf_counter()
        elif (self.it == cfg.profile_from + cfg.profile_steps
              and self._prof is not None):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            wall = time.perf_counter() - self._prof_t0
            self._prof.stop()
            path = os.path.join(self.out_dir, "profile")
            os.makedirs(path, exist_ok=True)
            self._prof.export_chrome_trace(
                os.path.join(path, f"trace-{cfg.profile_from}.json"))
            self.last_profile = (self._prof, wall, cfg.profile_steps)
            self._prof = None
            print(f"Profiler trace written to {path}")

    def _stop_agreed(self) -> bool:
        """Whether any rank got SIGTERM: one all_reduce(MAX) of the flag
        on the host group per step, so every rank stops (and gathers the
        stop save) at the same step."""
        if self.mesh.world == 1:
            return self._stop_requested
        flag = torch.tensor([int(self._stop_requested)])
        dist.all_reduce(flag, op=dist.ReduceOp.MAX,
                        group=self.mesh.host_group)
        return bool(flag.item())

    def _barrier(self) -> None:
        if self.mesh.world > 1:
            dist.barrier(group=self.mesh.host_group)

    def _train_loop(self, cfg) -> None:
        acc_loss: List[torch.Tensor] = []
        last_log = [time.perf_counter(), self.it]
        feed = self._device_feed(self.it + 1) if cfg.packed_views else None
        gen = self.trainer.generator
        while True:
            for batch in (feed if feed is not None else self.train_loader):
                self.it += 1
                # "it" labels the last completed step: the rolling save
                # comes after the step, so it matches the updates made
                checkpoint_extra = {
                    "it": self.it, "t": self.time_elapsed,
                    "run_id": self.run_id,
                    **{k: float(v) for k, v in self.best_metrics.items()}}
                self._checkpoint_extra = checkpoint_extra
                if self._stop_agreed():
                    print("SIGTERM received: checkpointing and exiting.")
                    self._save_ckpt("model.msgpack", **{
                        **checkpoint_extra, "it": self.it - 1})
                    self.checkpoint.flush()
                    return
                if (self.it >= cfg.validate_from and cfg.validate_every > 0
                        and (self.it - cfg.validate_from)
                        % cfg.validate_every == 0):
                    self.eval()
                    self.inference()
                self._profile(cfg)

                t0 = time.perf_counter()
                if cfg.packed_views:
                    step_batch = batch  # prepared by _device_feed
                else:  # host arrays, which train_step copies to the device
                    group = [batch]
                    try:
                        for _ in range(cfg.grad_accum - 1):
                            group.append(next(self.train_loader))
                    except StopIteration:
                        return  # the stream ended inside a group
                    micro = [self._host_prep(
                        b, self._sample_view_count(b["target"].shape[0]))
                        for b in group]
                    step_batch = micro[0] if len(micro) == 1 else _stack(micro)
                # the draws of step it are a function of (seed, it), so a
                # resumed run draws as an unbroken one would
                gen.manual_seed(int(np.random.SeedSequence(
                    [cfg.seed, self.it]).generate_state(1)[0]))
                acc_loss.append(self.trainer.train_step(step_batch))
                self.time_elapsed += time.perf_counter() - t0

                if (cfg.checkpoint_every > 0
                        and self.it % cfg.checkpoint_every == 0
                        and self.it > 0):
                    self._save_ckpt("model.msgpack", **{
                        **checkpoint_extra, "t": self.time_elapsed})
                if cfg.log_every > 0 and self.it % cfg.log_every == 0:
                    mean_loss = (torch.stack(acc_loss).mean().item()
                                 if acc_loss else 0.0)
                    acc_loss.clear()
                    now = time.perf_counter()
                    sps = (self.it - last_log[1]) / max(now - last_log[0],
                                                        1e-9)
                    last_log[:] = [now, self.it]
                    self.log_dict.update(
                        t=self.time_elapsed,
                        lr=float(self.trainer.lr_fn(self.it)),
                        loss=mean_loss, steps_per_sec=sps)
                    self.logger.log(self.log_dict, self.it)
                    self.log_dict = {}
                if self.it >= cfg.max_it:
                    print("Maximum iteration count reached.")
                    self._save_ckpt("model.msgpack",
                                    **self._checkpoint_extra)
                    self.checkpoint.flush()
                    return

    # ------------------------------------------------------------------
    def _eval_pass(self, loader, salt_base: int, dump: bool,
                   key_base: int = 0):
        """One metric pass over ``loader``: full generation, then masked
        SSIM/PSNR sums, added over the data group.  Each rank draws the
        chain's noise for the global batch and keeps its rows.  Returns
        (ssim, psnr, sample_count)."""
        tc, mesh = self.config.train, self.mesh
        ssims, psnrs, weights = [], [], []
        packed = tc.packed_views and not tc.eval_iid_counts
        for val_batch in loader():
            k = len(ssims)
            if packed:
                vc, si, vi = self._packed_counts(salt_base + k)
                host = self._host_prep(val_batch, vc, (si, vi))
            else:
                host = self._host_prep(val_batch, self._sample_view_count(
                    val_batch["target"].shape[0]))
            batch = to_device(host, self.device)
            gen = salted_generator(tc.seed + 17, key_base + k, self.device)
            if mesh.data > 1:
                b = val_batch["target"].shape[0]
                gen = RowSlice(gen, b * mesh.data, mesh.data_rank * b)
            with torch.no_grad():
                out = self.trainer._eval_samples(gen, batch)
                target = norm_img(batch["target"])
                mask = batch.get("eval_mask")
                if mask is None:
                    mask = torch.ones(out.shape[0], device=self.device)
                ssims.append(torch.sum(compute_ssim(out, target) * mask))
                psnrs.append(torch.sum(compute_psnr(out, target) * mask))
                weights.append(torch.sum(mask))
            if dump and tc.eval_dump_images and self.is_host0:
                if mesh.world > 1:
                    print("eval_dump_images skipped: arrays span "
                          "non-addressable devices on multi-host")
                else:
                    self._dump_eval_images(out, target, k,
                                           mask=mask.cpu().numpy())
        sums = torch.stack([torch.stack(v).sum()
                            for v in (ssims, psnrs, weights)])
        if mesh.data_group is not None:
            dist.all_reduce(sums, group=mesh.data_group)
        ssim, psnr = (sums[:2] / sums[2]).tolist()
        return ssim, psnr, float(sums[2])

    def eval(self) -> None:
        """Full-generation metric eval and the best-model files."""
        print("Running metric evaluation...")
        with tracing.span("eval.pass", key=self.it):
            ssim, psnr, count = self._eval_pass(
                self.val_loader, salt_base=1_000_000_000, dump=True)
        self.last_eval_count = count
        self.log_dict["ssim"] = ssim
        self.log_dict["psnr"] = psnr
        print(f"eval: ssim={ssim:.4f} psnr={psnr:.2f} (n={int(count)})")
        if self.train_eval_loader is not None:
            tr_ssim, tr_psnr, tr_n = self._eval_pass(
                self.train_eval_loader, salt_base=2_000_000_000,
                dump=False, key_base=1_000_000)
            self.log_dict["ssim_train"] = tr_ssim
            self.log_dict["psnr_train"] = tr_psnr
            print(f"eval[train-split]: ssim={tr_ssim:.4f} "
                  f"psnr={tr_psnr:.2f} (n={int(tr_n)})")
        if self.args.train:
            best_cnt = 0
            extra = getattr(self, "_checkpoint_extra", {"it": self.it})
            if ssim > self.best_metrics["ssim"]:
                best_cnt += 1
                self.best_metrics["ssim"] = ssim
                extra.update(ssim=ssim)
                self._save_ckpt("best_model_ssim.msgpack", **extra)
            if psnr > self.best_metrics["psnr"]:
                best_cnt += 1
                self.best_metrics["psnr"] = psnr
                extra.update(psnr=psnr)
                self._save_ckpt("best_model_psnr.msgpack", **extra)
            if best_cnt == 2:
                self._save_ckpt("best_model_all.msgpack", **extra)
        self.checkpoint.flush()
        if not self.args.train:
            # a standalone -e leaves its record in metrics.jsonl
            self.logger.log(self.log_dict, max(self.it, 0))
            self.log_dict = {}

    def _dump_eval_images(self, gen, target, batch_idx: int,
                          mask=None) -> None:
        """Generated/target PNG pairs for offline metrics."""
        root = os.path.join(self.out_dir, f"images-{max(self.it, 0)}")
        gdir, tdir = os.path.join(root, "generated"), os.path.join(
            root, "target")
        os.makedirs(gdir, exist_ok=True)
        os.makedirs(tdir, exist_ok=True)
        gen, target = gen.cpu().numpy(), target.cpu().numpy()
        for i in range(gen.shape[0]):
            if mask is not None and mask[i] == 0.0:
                continue  # exact-epoch padding row
            stem = f"{batch_idx:04d}-{i:04d}.png"
            save_png(np.clip(gen[i], 0, 1), os.path.join(gdir, stem))
            save_png(target[i], os.path.join(tdir, stem))

    # ------------------------------------------------------------------
    def inference(self) -> None:
        """The vis grid during training; -ex/-ar/-gif under -i."""
        if self.args.train:
            self._train_vis_grid()
        elif self.args.inference:
            if self.args.extrapolate:
                self.extrapolate()
            if self.is_host0:  # one rank generates; the rest wait
                if self.args.autoregressive:
                    self.autoregressive()
                if self.args.generate_gifs:
                    self.generate_gif()
            self._barrier()
        self.logger.log(self.log_dict, max(self.it, 0))
        self.log_dict = {}

    def _grid_output(self, ret_arr, target, cond, view_count,
                     name: str) -> None:
        """Denoising frames | target | conditioning views, a row each."""
        vmax = int(np.max(view_count))
        mask = (np.arange(vmax)[None, :] < view_count[:, None]).astype(
            np.float32)
        cond_rgb = cond[..., -3:]  # relative mode: the last 3 channels
        cond_padded = cond_rgb[:, :vmax] * mask[:, :, None, None, None]
        output = np.concatenate((np.clip(ret_arr, 0, 1), target[:, None],
                                 cond_padded), axis=1)
        b, s = output.shape[:2]
        grid = make_grid(output.reshape(b * s, *output.shape[2:]), nrow=s,
                         scale_each=True)
        self.logger.log_image(name, grid, max(self.it, 0),
                              caption="Denoising steps, Target, Input View")

    def _train_vis_grid(self) -> None:
        batch = self.val_vis_data
        cond = batch[self.cond_key][:, :self.max_views]
        angle = np.asarray(batch[self.angle_key]).reshape(-1)
        target = batch["target"]
        # every rank draws, so the ranks of a view group keep one stream
        view_count = self._sample_view_count(target.shape[0])
        if self.is_host0:
            out = self.trainer._generate_np(cond, view_count, angle)
            self._grid_output(out.ret_arr, target, cond, view_count,
                              "output")
        self._barrier()

    def extrapolate(self) -> None:
        """view_count ~ U{max_views+1 .. 23}: more views than training."""
        print("Running extrapolate image generation...")
        batch = self.val_vis_data
        target, cond = batch["target"], batch["cond"]
        angle = np.asarray(batch["angle"]).reshape(-1)
        view_count = self._sample_extrapolate_counts(target.shape[0],
                                                     cond.shape[1])
        if self.is_host0:
            out = self.trainer._generate_np(cond, view_count, angle,
                                            key_salt=1)
            self._grid_output(out.ret_arr, target, cond, view_count,
                              "extrapolate")

    def _sample_extrapolate_counts(self, n: int, total: int) -> np.ndarray:
        """U{max_views+1 .. total}, ``total`` the stored cond views."""
        return self.rng.integers(self.max_views + 1, total + 1, (n,))

    def autoregressive(self) -> None:
        """A 24-view orbit generated in sequence, each view joining the
        conditioning set of the next (a static (1, 24, ...) buffer with a
        growing view count)."""
        print("Running autoregressive generation...")
        total = self.config.data.total_views
        all_views = np.asarray(self.val_vis_data["all_views"])[10:11]
        h, w = all_views.shape[2:4]
        cond = np.zeros((1, total, h, w, 3), np.float32)
        cond[:, 0] = all_views[:, 0]
        cond_list, sample_list = [], []
        for count in range(1, total + 1):
            angle = np.asarray([2 * np.pi / total * count], np.float32)
            sample = self.trainer._sample_only_np(
                cond, np.asarray([count]), angle, key_salt=100 + count)[0]
            if count < total:
                cond[:, count] = sample
            cond_list.append(cond[0, :count].copy())
            sample_list.append(sample)
        frames = []
        for count, (conds, sample) in enumerate(
                zip(cond_list, sample_list), start=1):
            padded = np.ones((total, h, w, 3), np.float32)
            padded[:count] = np.clip(conds, 0, 1)
            row = np.concatenate([padded, np.clip(sample, 0, 1)[None]], 0)
            frames.append(to_uint8(make_grid(row, nrow=total + 1)))
        self.logger.log_image("autoregressive_single", frames[0],
                              max(self.it, 0))
        self.logger.log_video("autoregressive_animated", frames,
                              max(self.it, 0))

    def generate_gif(self) -> None:
        """An orbit animation with each view's weight maps."""
        print("Running animation sequence generation...")
        obj = 10
        total = self.config.data.total_views
        views = np.asarray(self.val_vis_data["all_views"])  # (12,24,H,W,3)
        angles = np.asarray([2 * np.pi / total * i for i in range(total)],
                            np.float32)
        target = views[obj]
        cond_views = np.stack([views[obj, ::4]] * total, axis=0)
        view_counts = np.full((total,), cond_views.shape[1])
        out = self.trainer._generate_np(cond_views, view_counts, angles,
                                        key_salt=2)
        ret, weights = out.ret_arr, out.weight_arr
        if weights is None:
            raise ValueError(
                "generate_gif needs weighting_inference=True (no weight "
                "maps in the no-weighting ablation)")
        n_cond = cond_views.shape[1]
        frames = []
        for i in range(total):
            rows = np.concatenate([weights[i], cond_views[i][None]], axis=0)
            gen_col = np.clip(ret[i][:, None], 0, 1)
            rows = np.concatenate([rows, gen_col], axis=1)
            target_row = np.stack([target[i]] * (n_cond + 1))[None]
            rows = np.concatenate([rows, target_row], axis=0)
            s, v = rows.shape[:2]
            grid = make_grid(rows.transpose(1, 0, 2, 3, 4).reshape(
                v * s, *rows.shape[2:]), nrow=s, pad_value=0.9)
            frames.append(to_uint8(grid))
        self.logger.log_video("weights_animated", frames, max(self.it, 0))
