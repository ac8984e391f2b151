#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of ViewFusion on one NVIDIA GPU.

    python3 chip_smoke.py          # every phase
    python3 chip_smoke.py --adm    # phases 1, 2 and 28
    python3 chip_smoke.py --k5     # phases 1, 2, 29 and 28 (shortcut)

Phases (any failure raises and exits non-zero without the final line):
  1. device: the card's name and power limit (nvidia-smi); CUDA present;
  2. build: the CUDA kernels from viewfusion_tpu_torch/csrc (nvcc, sm_90a);
  3. K1 GroupNorm(+SiLU) at every GroupNorm site of the paper UNet, found
     by hooks on the model, at the serving batch of 8 x 6 views, against
     its plain version, with times, two calls equal bit for bit, and each
     site's plan (cluster size, rows staged of rows per block, and the
     clusters the card holds at once);
  4. K3 attention at every attention site of the paper UNet, the same way,
     with each site's share of its bound and its ratio to SDPA;
  5. the full-width paper UNet in bf16 with the kernels against the same
     UNet with the plain versions patched in;
  6. serving, the main path: ViewFusionService at the paper config with
     seeded random weights answers DDIM and DPM requests from threads;
     the kernels' launch counters must rise by exactly the per-forward
     site counts times the UNet forwards served;
  7. a small chain on the card against the same chain on the CPU;
  8. K2 GroupNorm(+SiLU) backward at every GroupNorm site of the paper
     UNet at the training batch (R = 98 rows: the stratified view counts
     of configs/small-tpu-1.yaml's batch of 28), bf16 and f32, against
     its plain version, with times, each site's plan, and the autograd
     backward of F.silu(F.group_norm(x)) as the library yardstick;
  9. one full-width bf16 packed training step (loss and every parameter
     gradient) through the kernels against the same step with the plain
     versions patched in;
 10. training, the second main path: the Trainer takes TRAIN_STEPS steps
     at small-tpu-1 from seeded weights and seeded batches in the
     loader's layout; the launch counters must rise by exactly the
     per-forward GroupNorm and attention site counts per step (K1 and K2
     once per GroupNorm site, K3 once per attention site); ms per step,
     peak memory and one profiled step;
 11. two tiny f32 train steps on the card against the same steps on the
     CPU;
 12. K4, the 3x3 conv weight gradient, at every stride-1 3x3 conv site of
     the paper UNet at R = 98 rows (bf16 at every site, f32 at the
     largest and at a Cin = 6 one) against its plain version, with times,
     the bound and weight-only cuDNN (aten.convolution_backward) as the
     library yardstick (each site's ratio to it), and the step's conv
     work recomputed from hooks;
 13. the conv3x3 op: one full-width bf16 packed training step with every
     stride-1 3x3 conv routed through conv3x3(impl="kernel") against the
     same step unpatched: the same loss, exactly one K4 launch per conv;
 14. ancestral sampling, the third main path: K1 (timed, with its plans)
     and K3 (untimed) against their plain versions at the GroupNorm and
     attention sites of this path's 28 packed rows; then the Trainer at
     the paper config
     evaluates a batch of 8 (28 packed rows) with the reference's
     T = 2000 step chain (tpu.sampler ddpm) in 4 segments; the counters
     must rise by exactly the per-forward site counts times T;
 15. a tiny f32 ancestral chain with frame capture on the card against
     the CPU, and a segmented chain on the card against one call;
 16. the experiment loop at the paper's width, the fourth main path,
     through ``cli.main`` in-process: synthetic shards at 64 px in a
     temporary directory, configs/small-tpu-1.yaml read with the port's
     YAML reader and cut to 30 steps (an eval at 30, DDIM 20 steps,
     EMA 0.999); -t (with vis grids and the best-model files), -r from
     it = 30, -e, -i -ex -ar -gif, and the run dir served over HTTP from
     its EMA shadow; the counters must rise by exactly 69 K1 and 8 K3
     launches per UNet forward and 69 K2 launches per training step over
     the phase; the stream's reader (native and codec readers compared),
     the loop's ms per step against phase 10's Trainer, one synchronous
     save and one load of model.msgpack, each eval pass, and the device's
     idle share of a profiled loop step;
 17. K3 at the DiT's sites (configs/dit-small-tpu-4.yaml: hidden 384,
     depth 12, 6 heads of 64, 256 tokens, bf16): (48 x 6, 256, 64) and
     (98 x 6, 256, 64), q, k and v the planes of one (3, B, S, hd) copy as
     MHAttention hands them over, against the plain version, timed with
     SDPA and the byte bound;
 18. DiT serving, the fifth main path: ViewFusionService on a DiT run
     dir written by write_run_dir (seeded weights, zero-init layers
     perturbed) answers 24 requests x 6 views with DDIM 50 in three
     batches of 8; exactly 12 K3 launches per DiT forward; a profiled
     forward;
 19. DiT training, the sixth: the Trainer takes TRAIN_STEPS steps at
     batch 28 (the 4-chip batch of 112 cut to one card's 28: R = 98),
     without and with tpu.remat (12 and 24 K3 launches per step), ms per
     step, peak memory, a profiled step; two tiny f32 DiT train steps on
     the card against the CPU;
 20. the DiT ancestral chain, the seventh: one 100-step segment of the
     T = 2000 chain at 28 packed rows, exactly 12 K3 launches per step,
     ms per step and the device's busy share;
 21. the offline tools: LPIPS (seeded random VGG16 weights) on 28 pairs
     at 64 px, card against CPU; compute_metrics over a PNG dump on the
     card against the CPU;
 22. the experiment loop on the DiT: cli.main -t at
     configs/dit-small-tpu-4.yaml (batch 28) for 10 steps with an eval
     and an ancestral vis grid at it = 10, then -e, on synthetic 64 px
     shards; exactly 12 K3 launches per DiT forward over the phase, and
     model.msgpack holds the DiT's tree.  After phase 22, K3 is held
     against its plain version at every (B, S, C) that phases 18-22 gave
     it on the card (recorded by a wrapper around the DiT's call), the
     errors joining K3's in the kernels line;
 dropout: one dense f32 training step at small-tpu-1's widths (batch 2:
     12 UNet rows) with dropout 0.1 on the card, its masks drawn from the
     Trainer's generator, against the same step on the CPU with those
     masks fed in;
 23. more than one process, the eighth main path: ``cli.main -t`` and
     an eval pass under ``python -m torch.distributed.run
     --nproc_per_node=1`` (this script as each rank: ``--rank-child``)
     at configs/small-tpu-1.yaml
     for 10 steps with tpu.shard_opt_state and tpu.fused_feed on
     synthetic 64 px shards: NCCL, DDP, ZeRO-1 at data 1, the fused feed,
     a checkpoint holding the whole Adam tree and an eval; the loop's ms
     per step against phase 16's;
 24. four ranks sharing the card (gloo over CUDA tensors) at
     configs/small-tpu-4.yaml's published batch of 112 (28 per rank):
     (a) three Trainer steps fed the global batches that one process on
     the card steps through at R = 392, drawing from the same generator,
     with replicated Adam and with ZeRO-1; (b) the same at tpu.mesh_view
     2 (data 2 x view 2) with ZeRO-1; losses, first gradients and the
     parameters after each update against the one process, the ranks'
     parameters equal, per-rank peak memory and Adam bytes; (c)
     ``cli.main -t`` and an eval pass on four ranks for 4 steps with ZeRO-1, a
     checkpoint and an eval.  On a machine with two or more cards, (a)
     also runs with NCCL and one rank per card.  Every rank prints its
     K1-K3 launch counts and the UNet row counts it ran; the counts must
     match its forwards and steps, join the kernels line's launches, and
     K1-K3 are held against their plain versions at every per-rank row
     count.  A rank that fails, hangs past its timeout or disagrees
     fails the phase.
 25. the published-weights path, the ninth: phase 5's weights saved as
     the reference's best_model_all.pt (denoise_fn.* beside the schedule
     buffers of T = 2000, Adam moments, an int it, a numpy-float ssim and
     a 0-d tensor psnr), converted by ``python -m
     viewfusion_tpu_torch.utils.torch_convert`` in a fresh interpreter
     with a config from configs/small-tpu-4.yaml (published widths, no
     EMA, an eval of two batches of 112 at DDIM 20 on synthetic 64 px
     shards); the run dir's f32 weights equal phase 5's bit for bit;
     ViewFusionService on the run dir serves two requests, one a batch
     (DDIM 50), equal bit for bit to a service on the unconverted
     weights fed the same requests, then 24 requests (three full
     batches) timed; then ``cli.main(["-s", run dir, "-e"])``; exactly
     69 K1 and 8 K3 launches per UNet forward over the service and the
     eval, and K1 and K3 held against their plain versions at every row
     count those forwards ran at (the eval's 392 packed rows too);
 26. the input formats, the tenth: tests/torch_port_formats/'s YAML 1.1
     config (a directive, ``---``, anchors merged with ``<<``, flow
     collections, block scalars, a folded string) read with load_config
     equals configs/small-tpu-4.yaml's Config, written into a run dir of
     phase 5's weights by Config.to_yaml and read back to the same tree;
     every view fixture (8-bit, 4-bit palette, 16-bit and Adam7 PNG,
     baseline and progressive JPEG, lossy, lossless and alpha WebP, GIF,
     4-bit BMP and LZW TIFF; three views each) decoded on the card's host
     equals Pillow's decode in expected.npz; one ViewFusionService on that
     run dir behind make_server answers one HTTP request per format (its
     three views, DDIM 20) with a 64 x 64 image; an unrecognised view gets
     HTTP 400 saying so; exactly 69 K1 and 8 K3 launches per UNet
     forward; each format's host decode ms per view; compute_metrics on
     the card over the JPEG fixtures equals it over their expected arrays
     as PNGs.
 27. the served UNet forward replayed as a CUDA graph: a
     ViewFusionService at the paper config on phase 5's weights; its
     DDIM 50 warm-up captures the forward at the served 8 x 6 rows
     exactly once (unet.graph_captures 1, then 48 replays); two full
     batches, every forward of which is a replay (the ``graphed``
     attribute of each ``unet.forward`` span), with exactly 69 K1 and 8
     K3 launches per forward; these launches are counted apart from the
     other paths'.  (Every path above that samples without autograd
     replays its forwards the same way; their counts are unchanged.)
 28. the ADM denoiser (viewfusion_tpu_torch/configs/adm-imagenet-64.yaml:
     192 channels, mults 1/2/3/4, attention at 32/16/8 px in heads of 64)
     at one card's batch of 32 (R = 112 packed rows): its GroupNorm and
     attention sites found by hooks on the model (95 and 22, 36 of the
     GroupNorms AdaGN with a (B, C) affine); K1 and K2 at every distinct
     GroupNorm shape, each with a (B, C) and a (C,) affine, against their
     plain versions, timed with the plain versions and the byte bound,
     with each plan (several stage only part of a block); the totals per
     forward and per step, all sites and the AdaGN sites alone; K3 at the
     three attention sites, timed; then the Trainer takes a warm-up step
     and one step with the launch counters zeroed just before it, which
     must read one K1 and one K2 launch per GroupNorm site (one with a
     (B, C) affine per AdaGN), one K3 and one K5 launch per attention site
     and no closed-form backward; a profiled step, its device time by
     kernel family and the device time of the kernels under the attention
     backward's autograd node (``_Attention.backward``);
 29. K5, the fused attention backward for heads of 64, at every attention
     site of the DiT (R = 98: (588, 256, 64) x 12) and the ADM (R = 112:
     (672, 1024, 64) x 7, (1008, 256, 64) x 7, (1344, 64, 64) x 8) with an
     upstream gradient of bf16 values and a general f32 one, against the
     closed form and an f64 closed form, two calls equal bit for bit;
     timed with its bound, the closed form and the autograd backward of
     F.scaled_dot_product_attention (the library yardstick, never called
     by the port); K3's forward at the ADM's sites; one counted training
     step of the DiT (12 K5 launches, 0 closed-form backwards) and of the
     paper UNet (0 and 8: single heads of 192 and 320 channels).
The last lines are the card's name and power limit, one JSON object with
the kernels' numbers, and ``{"ok": true, "device": {...}}``.

Tolerances: bf16 outputs within one bf16 ulp of the output scale (both
sides round one f32 value; the sums run in another order); saved
statistics within rtol 1e-4; f32 attention outputs within 1e-4 abs
(f32 sums over the keys in another order); the bf16 UNet within 2e-2
relative L2 (bf16 rounding flips from the GroupNorm and attention
outputs, carried through ~60 layers); the f32 chain within 1e-4.  K2:
f32 dx within 1e-5 of its scale, the dscale/dbias partials within 1e-4
of their scale (f32 sums of L terms in another order), two calls equal
bit for bit.  The bf16 training step: loss within 1e-2 relative and the
gradient (all parameters as one vector) within 5e-2 relative L2 (the
forward's 1e-2 flips, carried back through the same layers).  The tiny
f32 train steps: losses, gradients, parameters and EMA within 1e-4.  K4:
within 1e-5 of the result's scale times sqrt(R*H*W / 4096) (f32 sums of
exact products in another order), two calls equal bit for bit.  The
conv3x3 step: the loss equal bit for bit (the same forward), each conv
weight gradient within 1e-2 relative L2 of cuDNN's (rounded to bf16, one
ulp is 3.9e-3), all gradients within 5e-2.  The tiny ancestral chain:
samples, frames, logits and weights within 1e-4; segmented equal to one
call bit for bit.  The tiny f32 DiT steps and the dropout step: phase
11's 1e-4.  Phase 24 against one process (bf16; the ranks run other row
subsets and sum in another order): losses within 1e-2 relative and the
first gradients within 5e-2 relative L2 (phase 9's bounds), each
parameter within twice the learning rates summed so far (Adam moves an
element by at most about lr a step, and rounding-noise gradients can
flip its sign), the parameter updates within 0.5 relative L2 (a rank
whose ZeRO-1 slices did not arrive would be near 1), and the ranks'
parameters equal bit for bit.  LPIPS card
against CPU within 1e-4 relative (f32 sums over 13 conv layers in another
order, TF32 off); compute_metrics PSNR within 1e-6 relative, SSIM within
1e-6, LPIPS within 1e-4 relative.  Phase 25: the converted run dir's
f32 weights equal the .pt's bit for bit, and so do its served images the
unconverted weights' (the same requests and seeds on one card); K1 and
K3 at the path's row counts (the eval's packed rows too) within the
bounds above.  Phase 26: every fixture's decode equal to Pillow's bit for
bit and compute_metrics equal (the decoders are exact).  Phase 29: K5's
error against f64 no larger than twice the closed form's plus one bf16
ulp of the output's scale, and within two bf16 ulps of the closed form
(both round an f32 value to bf16 once).
"""

from __future__ import annotations

import base64
import contextlib
import io
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from viewfusion_tpu_torch import _native, tracing
from viewfusion_tpu_torch.config import Config
from viewfusion_tpu_torch.models import unet as unet_module
from viewfusion_tpu_torch.models.unet import GroupNormAct, SelfAttention, UNet
from viewfusion_tpu_torch.models.view_fusion import ViewFusion
from viewfusion_tpu_torch.ops.attention import (
    _Attention, attention_backward, spatial_self_attention,
    spatial_self_attention_backward, spatial_self_attention_reference)
from viewfusion_tpu_torch.ops.conv_wgrad import (conv3x3, conv3x3_wgrad,
                                                 conv3x3_wgrad_reference)
from viewfusion_tpu_torch.ops.groupnorm import (
    group_norm_act, group_norm_act_backward,
    group_norm_act_backward_reference, group_norm_act_reference,
    group_norm_active_clusters, group_norm_plan)
from viewfusion_tpu_torch import cli
from viewfusion_tpu_torch.config import dump_yaml, load_config, parse_yaml
from viewfusion_tpu_torch.data import native_loader
from viewfusion_tpu_torch.data.nmr import decode_views_u8
from viewfusion_tpu_torch.data.synthetic import make_synthetic_shards
from viewfusion_tpu_torch.data.tario import iter_tar_samples
from viewfusion_tpu_torch.models import dit as dit_module
from viewfusion_tpu_torch.models.adm import ADM, AdaGroupNorm
from viewfusion_tpu_torch.models.dit import DiT, MHAttention
from viewfusion_tpu_torch.ops.lpips import load_lpips
from viewfusion_tpu_torch.ops.schedules import DiffusionSchedule
from viewfusion_tpu_torch.parallel.mesh import (initialize_distributed,
                                                shard_batch)
from viewfusion_tpu_torch.serving import (ViewFusionService, make_server,
                                          write_run_dir)
from viewfusion_tpu_torch.utils import compute_metrics
from viewfusion_tpu_torch.training.checkpoint import Checkpoint
from viewfusion_tpu_torch.training.trainer import (Trainer,
                                                   global_packed_counts,
                                                   norm_img, packed_indices)
from viewfusion_tpu_torch.utils.convert import (load_trainer_state,
                                                trainer_state_to_jax,
                                                unet_state_dict_from_jax)
from viewfusion_tpu_torch.utils.device import to_device
from viewfusion_tpu_torch.data.synthetic import render_views_shaded
from viewfusion_tpu_torch.utils.image import decode_image
from viewfusion_tpu_torch.utils.png import decode_png, encode_png
from viewfusion_tpu_torch.utils.torch_convert import SCHEDULE_BUFFERS

# configs/small-tpu-4.yaml, the fields the serving path reads (kept in
# code: the card's machine may have no PyYAML)
PAPER_CONFIG = {
    "model": {
        "denoise_net": "unet",
        "view_fusion_params": {"beta_schedule": {
            "train": {"schedule": "linear", "num_timesteps": 2000,
                      "linear_start": 1.0e-06, "linear_end": 0.01},
            "test": {"schedule": "linear", "num_timesteps": 1000,
                     "linear_start": 0.0001, "linear_end": 0.09},
        }},
        "denoise_net_params": {
            "image_size": 64, "in_channel": 6, "out_channel": 6,
            "inner_channel": 64, "res_blocks": 3, "attn_res": [16],
            "channel_mults": [1, 2, 3, 5],
        },
    },
    "data": {"params": {"max_views": 6, "batch_size": 112}},
    "tpu": {"packed_views": True, "compute_dtype": "bfloat16"},
}
# a small config for the card-against-CPU chain (tests/conftest.py sizes)
TINY_UNET = {"image_size": 8, "in_channel": 6, "out_channel": 6,
             "inner_channel": 8, "norm_groups": 4, "res_blocks": 1,
             "attn_res": [4], "channel_mults": [1, 2]}

SEED = 0
BATCH, MAX_VIEWS = 8, 6
ROWS = BATCH * MAX_VIEWS        # UNet rows per serving batch
TRAIN_BATCH = 28                # configs/small-tpu-1.yaml
TRAIN_ROWS = 98                 # sum of stratified_count_multiset(28, 6)
TRAIN_STEPS = 6                 # Trainer steps; the first is timed apart
DDIM_STEPS, DPM_STEPS = 50, 20
# the ancestral eval batch: the stratified view counts of a batch of 8
# (1, 2, 3, 4, 5, 6, 1, 6 shuffled: 28 packed rows), the active schedule's
# T = 2000 steps in segments
ANCESTRAL_BATCH = 8
ANCESTRAL_SEGMENTS = 4
HBM_BYTES_PER_S = 3.35e12       # H100 SXM
# peak rate by input type: bf16 on the tensor cores (dense); f32 outside
# them (the f32 math of these kernels)
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}


def say(*parts) -> None:
    print(*parts, flush=True)


def forwards_since(mark: int) -> int:
    """The UNet forwards (``unet.forward`` spans) begun after ``mark``."""
    return len(tracing.spans("unet.forward", after=mark))


def span_summary(mark: int) -> str:
    """Each span name recorded after ``mark``: its count and median ms."""
    by = {}
    for sp in tracing.spans(after=mark):
        by.setdefault(sp.name, []).append(sp.seconds * 1e3)
    return ", ".join(f"{name} {len(v)} x {np.median(v):.3f} ms"
                     for name, v in sorted(by.items()))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, iters: int = 20) -> float:
    """Device time of one call: ``iters`` calls captured into a CUDA graph
    and replayed between CUDA events, so the host's per-call cost
    (Python, allocation, launch) is not in the number.  Inputs that fit
    the 50 MB L2 stay there from one call to the next."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (3 * iters)


def call_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Time of one eager call, host included: CUDA events around
    ``iters`` back-to-back calls (the device idles whenever the host is
    slower than the kernel)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, ops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bf16_ulp(scale: float) -> float:
    return 2.0 ** (np.floor(np.log2(max(scale, 1e-30))) - 7)


def add_site(tot, count, ms, plain_ms, lib_ms, bms, nbytes, err) -> None:
    """Add one site, ``count`` times per forward, to a kernel's totals."""
    if count:
        tot["ms"] += count * ms
        tot["plain_ms"] += count * plain_ms
        tot["library_ms"] += count * lib_ms
        tot["bound_ms"] += count * bms
        tot["bound_bytes_ms"] += count * (nbytes / HBM_BYTES_PER_S * 1e3)
        tot["max_abs_err"] = max(tot["max_abs_err"], err)


def train_config(**tpu) -> Config:
    """configs/small-tpu-1.yaml: the paper model on one chip (batch 28);
    it differs from small-tpu-4.yaml in the batch size alone."""
    raw = json.loads(json.dumps(PAPER_CONFIG))
    raw["data"]["params"]["batch_size"] = TRAIN_BATCH
    raw["tpu"].update(tpu)
    return Config.from_dict(raw)


def train_batch(cfg, it: int, rng) -> dict:
    """One host batch in the loader's layout (uint8 images), with the
    packed view counts of step ``it`` (salt = it)."""
    b, n, hw = cfg.data.batch_size, cfg.data.max_views, \
        cfg.denoiser.image_size
    counts, si, vi = global_packed_counts(cfg.train.seed, it, b, n)
    return {"target": rng.integers(0, 256, (b, hw, hw, 3), dtype=np.uint8),
            "cond": rng.integers(0, 256, (b, n, hw, hw, 3), dtype=np.uint8),
            "angle": rng.uniform(0, 2 * np.pi, b).astype(np.float32),
            "view_count": counts.astype(np.int32), "sample_idx": si,
            "view_idx": vi}


def paper_unet(device) -> UNet:
    cfg = Config.from_dict(PAPER_CONFIG)
    torch.manual_seed(SEED)
    unet = UNet(cfg.unet, dtype=torch.bfloat16)
    unet_module.cast_matmul_weights_(unet.to(device).eval(), torch.bfloat16)
    return unet


def unet_inputs(rows: int, cfg, device, seed: int = SEED):
    g = torch.Generator(device=device).manual_seed(seed)
    hw = cfg.image_size
    x = torch.randn((rows, hw, hw, cfg.in_channel), generator=g,
                    device=device)
    angle = torch.rand((rows,), generator=g, device=device) * 6.28
    level = torch.rand((rows,), generator=g, device=device)
    return x, angle, level


def sites(unet: UNet, rows: int, device):
    """(L, C, act) GroupNorm sites and (S, C) attention sites of one
    forward, with their counts, read by hooks on the model."""
    gn, attn = Counter(), Counter()
    hooks = [m.register_forward_pre_hook(
        lambda m, a: gn.update([(a[0].shape[2] * a[0].shape[3],
                                 a[0].shape[1], m.act)]))
        for m in unet.modules() if isinstance(m, GroupNormAct)]
    hooks += [m.register_forward_pre_hook(
        lambda m, a: attn.update([(a[0].shape[2] * a[0].shape[3],
                                   a[0].shape[1])]))
        for m in unet.modules() if isinstance(m, SelfAttention)]
    with torch.inference_mode():
        unet(*unet_inputs(rows, unet.config, device))
    for h in hooks:
        h.remove()
    return gn, attn


def plan_note(x, backward: bool = False) -> str:
    """K1's (or K2's) plan for the (B, L, C) tensor x: cluster size, rows
    staged of rows per block, and how many such clusters the card holds
    at once."""
    b, l, c = x.shape
    plan = group_norm_plan(b, l, c, x.element_size(), 2 if backward else 1,
                           _native.sm_count(x.device))
    active = group_norm_active_clusters(plan, x.dtype, backward=backward)
    return (f"plan: cluster {plan.cluster}, {plan.rows_staged}/"
            f"{plan.rows_per_block} rows staged, {plan.threads} threads, "
            f"{plan.smem} B, {active} clusters at once")


def check_group_norm(gn_sites, groups: int, device, rows: int = ROWS,
                     timed: bool = True) -> dict:
    """K1 against its plain version at each site at ``rows`` rows (bf16,
    plus one f32 shape), two calls equal bit for bit; per-forward totals
    weight each site by its count.  ``timed=False`` checks without
    timing."""
    g = torch.Generator(device=device).manual_seed(SEED + 1)
    tot = dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms",
                         "bound_bytes_ms", "max_abs_err"), 0.0)
    f32_site = max(gn_sites)
    cases = [(site, torch.bfloat16, n) for site, n in sorted(gn_sites.items())]
    cases.append((f32_site, torch.float32, 0))  # checked, not in totals
    for (l, c, act), dtype, count in cases:
        x = (torch.randn((rows, l, c), generator=g, device=device) * 1.5
             + 0.5).to(dtype)
        scale = torch.randn((c,), generator=g, device=device) * 0.5 + 1.0
        bias = torch.randn((c,), generator=g, device=device) * 0.5
        kw = dict(groups=groups, act=act)
        y, mean, rstd = group_norm_act(x, scale, bias, return_stats=True,
                                       **kw)
        again = group_norm_act(x, scale, bias, return_stats=True, **kw)
        y_r, mean_r, rstd_r = group_norm_act_reference(x, scale, bias, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip((y, mean, rstd), again)):
            raise AssertionError(f"K1 {(l, c, act)} {dtype}: two calls differ")
        err = (y.float() - y_r.float()).abs().max().item()
        tol = (bf16_ulp(y_r.float().abs().max().item())
               if dtype == torch.bfloat16 else 1e-5)
        if not err <= tol:
            raise AssertionError(f"K1 {(l, c, act)} {dtype}: err {err} > {tol}")
        torch.testing.assert_close(mean, mean_r, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(rstd, rstd_r, rtol=1e-4, atol=1e-5)
        if not timed:
            say(f"K1 L={l} C={c} act={act} {str(dtype)[6:]} at {rows} rows:"
                f" err {err:.3g} (tol {tol:.3g}); {plan_note(x)}")
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            continue

        x4 = x.view(rows, int(l ** 0.5), -1, c).permute(0, 3, 1, 2)
        w_lib, b_lib = scale.to(dtype), bias.to(dtype)

        def library():
            out = F.group_norm(x4, groups, w_lib, b_lib, 1e-5)
            return F.silu(out) if act == "silu" else out

        ms = device_ms(lambda: group_norm_act(x, scale, bias, **kw))
        eager_ms = call_ms(lambda: group_norm_act(x, scale, bias, **kw))
        plain_ms = device_ms(lambda: group_norm_act_reference(
            x, scale, bias, **kw))
        lib_ms = device_ms(library)
        nbytes = 2 * x.numel() * x.element_size() + 2 * c * 4 \
            + 2 * rows * groups * 4
        bms, by = bound_ms(nbytes, 10 * x.numel(), torch.float32)
        say(f"K1 L={l} C={c} act={act} {str(dtype)[6:]} x{count}: "
            f"err {err:.3g} (tol {tol:.3g}) kernel {ms * 1e3:.1f} us "
            f"(eager call {eager_ms * 1e3:.1f} us) plain "
            f"{plain_ms * 1e3:.1f} us library {lib_ms * 1e3:.1f} us "
            f"bound {bms * 1e3:.1f} us ({by}) = {bms / ms:.0%} of bound; "
            f"{plan_note(x)}")
        add_site(tot, count, ms, plain_ms, lib_ms, bms, nbytes, err)
    return tot


def check_attention(attn_sites, device, rows: int = ROWS,
                    timed: bool = True, heads: bool = False) -> dict:
    """K3 against its plain version at each site at ``rows`` rows: q, k, v
    column slices of one (B, S, 3C) qkv buffer, as the UNet hands them
    over, or with ``heads`` the three planes of one (3, B, S, C) copy, as
    the DiT's MHAttention does (B = samples x heads).  ``timed=False``
    checks without timing."""
    g = torch.Generator(device=device).manual_seed(SEED + 2)
    tot = dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms",
                         "bound_bytes_ms", "max_abs_err"), 0.0)
    cases = [(site, torch.bfloat16, n) for site, n in sorted(attn_sites.items())]
    cases.append((max(attn_sites), torch.float32, 0))
    for (s, c), dtype, count in cases:
        if heads:
            q, k, v = torch.randn((3, rows, s, c), generator=g,
                                  device=device).to(dtype)
        else:
            qkv = torch.randn((rows, s, 3 * c), generator=g,
                              device=device).to(dtype)
            q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
        scale = 1.0 / c ** 0.5
        out = spatial_self_attention(q, k, v, scale)
        ref = spatial_self_attention_reference(q, k, v, scale)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        if not err <= 1e-4:
            raise AssertionError(f"K3 {(s, c)} {dtype}: err {err} > 1e-4")
        if not timed:
            say(f"K3 S={s} C={c} {str(dtype)[6:]} at {rows} rows: err "
                f"{err:.3g}")
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            continue
        q4, k4, v4 = (t.view(rows, 1, s, c) for t in (q, k, v))
        ms = device_ms(lambda: spatial_self_attention(q, k, v, scale))
        eager_ms = call_ms(lambda: spatial_self_attention(q, k, v, scale))
        plain_ms = device_ms(
            lambda: spatial_self_attention_reference(q, k, v, scale))
        lib_ms = device_ms(
            lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale))
        nbytes = 3 * q.numel() * q.element_size() + out.numel() * 4
        bms, by = bound_ms(nbytes, 4 * rows * s * s * c, dtype)
        say(f"K3 S={s} C={c} {str(dtype)[6:]} x{count}: err {err:.3g} "
            f"kernel {ms * 1e3:.1f} us (eager call {eager_ms * 1e3:.1f} us) "
            f"plain {plain_ms * 1e3:.1f} us library {lib_ms * 1e3:.1f} us "
            f"bound {bms * 1e3:.1f} us ({by})"
            f" = {bms / ms:.0%} of bound; kernel / SDPA {ms / lib_ms:.2f}")
        add_site(tot, count, ms, plain_ms, lib_ms, bms, nbytes, err)
    return tot


def _plain_unet_ops():
    """Patch the plain versions into the UNet's namespace (autograd then
    differentiates the plain ops); returns the restore function."""
    saved = unet_module.group_norm_act, unet_module.spatial_self_attention
    unet_module.group_norm_act = \
        lambda *a, **kw: group_norm_act_reference(*a, **kw)[0]
    unet_module.spatial_self_attention = spatial_self_attention_reference

    def restore():
        unet_module.group_norm_act, \
            unet_module.spatial_self_attention = saved
    return restore


def check_full_unet(unet: UNet, device) -> None:
    """The paper UNet with the kernels against itself with the plain
    versions patched into the module's namespace."""
    inputs = unet_inputs(ROWS, unet.config, device, seed=SEED + 3)
    with torch.inference_mode():
        t0 = time.perf_counter()
        got = unet(*inputs)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        restore = _plain_unet_ops()
        try:
            want = unet(*inputs)
        finally:
            restore()
    rel = ((got - want).norm() / want.norm()).item()
    say(f"UNet {ROWS}x64x64 bf16, kernels vs plain: rel L2 {rel:.3g}, max "
        f"abs {(got - want).abs().max().item():.3g} of "
        f"{want.abs().max().item():.3g}; forward {ms:.1f} ms (wall)")
    if not (torch.isfinite(got).all() and rel <= 2e-2):
        raise AssertionError(f"full UNet disagrees: rel L2 {rel}")


def profile_forward(unet: UNet, device) -> None:
    """Where one UNet forward at the serving batch spends its time:
    device time by kernel family from torch.profiler, against the wall
    time of the forward (the rest is the device waiting on the host)."""
    from torch.profiler import ProfilerActivity, profile

    inputs = unet_inputs(ROWS, unet.config, device, seed=SEED + 4)
    with torch.inference_mode():
        unet(*inputs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        unet(*inputs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            unet(*inputs)
            torch.cuda.synchronize()
    report_profile(prof, f"one UNet forward at {ROWS} rows", wall_ms)


def kernel_family(name: str) -> str:
    """The family a device kernel's name puts it in (``report_profile``)."""
    low = name.lower()
    return ("K2 groupnorm bwd" if "gn_bwd" in low else
            "K1 groupnorm" if "gn_" in low else
            "K3 attention" if "attn_fwd" in low else
            "K5 attention bwd" if "attn_bwd" in low else
            ("conv/gemm f32" if any(t in low for t in (
                "sgemm", "f32f32", "ffma")) else "conv/gemm")
            if any(w in low for w in (
                "conv", "gemm", "xmma", "cutlass", "cudnn", "sm90",
                "nvjet"))
            else "optimizer" if any(w in low for w in (
                "multi_tensor", "foreach", "adam"))
            else "other")


def report_profile(prof, what: str, wall_ms: float) -> float:
    """Device time by kernel family from a torch.profiler run, against
    the wall time of the work it traced; returns the device time (ms).
    cuBLAS's Hopper GEMMs are ``nvjet_*``; the f32 ones on the CUDA
    cores (``*sgemm*``, ``*f32f32*``, ``*ffma*``: with TF32 off, the
    attention backward's) are counted apart as "conv/gemm f32".
    Ranges that code annotates (torch.optim's ``Optimizer.step#Adam.step``)
    span kernels and are left out; kernel names may contain ``#``
    themselves (``{lambda(float)#1}``)."""
    from torch.autograd import DeviceType

    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("Optimizer.")]
    dev_us = {e.key: getattr(e, "self_device_time_total", 0) for e in kernels}
    total_ms = sum(dev_us.values()) / 1e3
    if not total_ms:
        say(f"profile of {what}: torch.profiler saw no device time "
            f"(not measured)")
        return 0.0
    fam = Counter()
    for name, us in dev_us.items():
        fam[kernel_family(name)] += us / 1e3
    say(f"profile of {what}: wall {wall_ms:.2f} ms, device busy "
        f"{total_ms:.2f} ms ({total_ms / wall_ms:.0%}), "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in fam.most_common()))
    for name, us in sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]:
        say(f"  {us / 1e3:7.3f} ms  {name[:90]}")
    return total_ms


def serve_requests(service: ViewFusionService, rng) -> list:
    """12 DDIM requests with 1-6 views and 2 DPM requests, from threads."""
    hw = service.image_size
    jobs = [(1 + i % 6, DDIM_STEPS, "ddim") for i in range(12)]
    jobs += [(3, DPM_STEPS, "dpm"), (5, DPM_STEPS, "dpm")]
    results = [None] * len(jobs)

    def call(i, n, steps, sampler):
        cond = rng[i].uniform(0, 1, (n, hw, hw, 3)).astype(np.float32)
        t0 = time.perf_counter()
        img = service.submit(cond, angle=0.5 * i, steps=steps,
                             sampler=sampler)
        results[i] = (img, time.perf_counter() - t0, sampler)

    threads = [threading.Thread(target=call, args=(i, *job))
               for i, job in enumerate(jobs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    if any(r is None for r in results):
        raise AssertionError("a request did not complete")
    return results


def check_chain_against_cpu(device) -> None:
    """A small f32 DDIM chain (eta=1, noise fed) through the kernels on
    the card against the plain versions on the CPU."""
    raw = json.loads(json.dumps(PAPER_CONFIG))
    raw["model"]["denoise_net_params"] = TINY_UNET
    raw["model"]["view_fusion_params"]["beta_schedule"]["train"][
        "num_timesteps"] = 20
    raw["tpu"]["compute_dtype"] = "float32"
    cfg = Config.from_dict(raw)
    rng = np.random.default_rng(SEED)
    b, n, hw = 3, 3, 8
    y_cond = torch.from_numpy(rng.uniform(0, 1, (b, n, hw, hw, 3)).astype(
        np.float32))
    counts = torch.tensor([1, 3, 2])
    angle = torch.from_numpy(rng.uniform(0, 6, b).astype(np.float32))
    y_t = torch.from_numpy(rng.normal(size=(b, hw, hw, 3)).astype(np.float32))
    noise = [torch.from_numpy(rng.normal(size=(b, hw, hw, 3)).astype(
        np.float32)) for _ in range(10)]
    outs = []
    for dev in ("cpu", device):
        torch.manual_seed(SEED)
        model = ViewFusion.from_config(cfg)
        model.unet.to(dev).eval()
        outs.append(model.generate_ddim(
            y_cond.to(dev), counts.to(dev), angle.to(dev), num_steps=10,
            y_t=y_t.to(dev), noise=noise).cpu())
    err = (outs[0] - outs[1]).abs().max().item()
    say(f"tiny f32 DDIM chain, card vs CPU: max abs {err:.3g}")
    if not err <= 1e-4:
        raise AssertionError(f"card chain disagrees with the CPU: {err}")


def check_group_norm_backward(gn_sites, groups: int, device,
                              rows: int = TRAIN_ROWS) -> dict:
    """K2 against its plain version at each GroupNorm site of the paper
    UNet at ``rows`` rows (the training batch), from K1's saved
    statistics: bf16 (timed where the site's count is not 0) and f32 at
    every site, plus the other act at the largest site.  Per-step totals
    weight each site by its count in one backward."""
    g = torch.Generator(device=device).manual_seed(SEED + 5)
    tot = dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms",
                         "bound_bytes_ms", "max_abs_err"), 0.0)
    big = max(gn_sites)
    other = (big[0], big[1], "none" if big[2] == "silu" else "silu")
    cases = [(site, dtype, n if dtype == torch.bfloat16 else 0)
             for site, n in sorted(gn_sites.items())
             for dtype in (torch.bfloat16, torch.float32)]
    cases += [(other, torch.bfloat16, 0), (other, torch.float32, 0)]
    for (l, c, act), dtype, count in cases:
        x = (torch.randn((rows, l, c), generator=g, device=device)
             * 1.5 + 0.5).to(dtype)
        gy = torch.randn((rows, l, c), generator=g,
                         device=device).to(dtype)
        scale = torch.randn((c,), generator=g, device=device) * 0.5 + 1.0
        bias = torch.randn((c,), generator=g, device=device) * 0.5
        kw = dict(groups=groups, act=act)
        _, mean, rstd = group_norm_act(x, scale, bias, return_stats=True,
                                       **kw)
        args = (x, gy, scale, bias, mean, rstd)
        out = group_norm_act_backward(*args, **kw)
        again = group_norm_act_backward(*args, **kw)
        ref = group_norm_act_backward_reference(*args, **kw)
        torch.cuda.synchronize()
        err = (out[0].float() - ref[0].float()).abs().max().item()
        scale_dx = ref[0].float().abs().max().item()
        tol = (bf16_ulp(scale_dx) if dtype == torch.bfloat16
               else 1e-5 * scale_dx)
        perr = max((a - b).abs().max().item() / b.abs().max().item()
                   for a, b in zip(out[1:], ref[1:]))
        if not (err <= tol and perr <= 1e-4):
            raise AssertionError(f"K2 {(l, c, act)} {dtype}: dx err {err} "
                                 f"(tol {tol}), partials rel err {perr}")
        if not all(torch.equal(a, b) for a, b in zip(out, again)):
            raise AssertionError(f"K2 {(l, c, act)} {dtype}: two calls differ")
        name = f"K2 L={l} C={c} act={act} {str(dtype)[6:]} x{count}"
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        if not count:
            say(f"{name}: dx err {err:.3g} (tol {tol:.3g}), partials rel "
                f"err {perr:.3g}, repeatable; {plan_note(x, backward=True)}")
            continue
        # the backward autograd runs for F.silu(F.group_norm(x4)) on
        # contiguous NCHW tensors: its two ATen ops, called directly (the
        # autograd engine's own thread cannot be captured into the timing
        # graph)
        h = int(round(l ** 0.5))
        x4 = x.view(TRAIN_ROWS, h, h, c).permute(0, 3, 1, 2).contiguous()
        g4 = gy.view(TRAIN_ROWS, h, h, c).permute(0, 3, 1, 2).contiguous()
        w_lib, b_lib = scale.to(dtype), bias.to(dtype)
        y4, mean4, rstd4 = torch.ops.aten.native_group_norm(
            x4, w_lib, b_lib, TRAIN_ROWS, c, l, groups, 1e-5)

        def library():
            gz = torch.ops.aten.silu_backward(g4, y4) if act == "silu" \
                else g4
            return torch.ops.aten.native_group_norm_backward(
                gz, x4, mean4, rstd4, w_lib, TRAIN_ROWS, c, l, groups,
                [True, True, True])

        ms = device_ms(lambda: group_norm_act_backward(*args, **kw))
        eager_ms = call_ms(lambda: group_norm_act_backward(*args, **kw))
        plain_ms = device_ms(
            lambda: group_norm_act_backward_reference(*args, **kw))
        lib_ms = device_ms(library)
        nbytes = (3 * x.numel() * x.element_size() + 2 * c * 4
                  + 2 * TRAIN_ROWS * groups * 4 + 2 * TRAIN_ROWS * c * 4)
        bms, by = bound_ms(nbytes, 16 * x.numel(), torch.float32)
        say(f"{name}: dx err {err:.3g} (tol {tol:.3g}) partials rel err "
            f"{perr:.3g} kernel {ms * 1e3:.1f} us (eager call "
            f"{eager_ms * 1e3:.1f} us) plain {plain_ms * 1e3:.1f} us "
            f"library {lib_ms * 1e3:.1f} us bound {bms * 1e3:.1f} us ({by})"
            f" = {bms / ms:.0%} of bound; {plan_note(x, backward=True)}")
        add_site(tot, count, ms, plain_ms, lib_ms, bms, nbytes, err)
    return tot


def packed_train_step(device):
    """The paper model at small-tpu-1 from seeded weights, and a function
    that takes one full-width bf16 packed training step on a seeded batch
    with fed draws: returns (model, names, step); step() gives the loss
    and every parameter gradient."""
    cfg = train_config()
    torch.manual_seed(SEED)
    model = ViewFusion.from_config(cfg)
    model.unet.to(device).train()
    rng = np.random.default_rng(SEED + 6)
    host = train_batch(cfg, 0, rng)
    put = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    b, hw = cfg.data.batch_size, cfg.unet.image_size
    args = (norm_img(put(host["target"])), norm_img(put(host["cond"])),
            put(host["view_count"]).long(), put(host["angle"]),
            put(host["sample_idx"]).long(), put(host["view_idx"]).long())
    noise = put(rng.normal(size=(b, hw, hw, 3)).astype(np.float32))
    gammas = put(rng.uniform(0.01, 0.99, b).astype(np.float32))
    names, params = zip(*model.unet.named_parameters())

    def step():
        loss = model.loss_packed(*args, noise=noise, sample_gammas=gammas)
        return loss.detach(), torch.autograd.grad(loss, params)

    return model, names, step


def check_train_step(device) -> None:
    """One full-width bf16 packed training step at small-tpu-1 (loss and
    every parameter gradient) through the kernels, against the same step
    with the plain versions, on the same batch and draws."""
    _, names, step = packed_train_step(device)
    loss_k, grads_k = step()
    torch.cuda.synchronize()
    restore = _plain_unet_ops()
    try:
        loss_p, grads_p = step()
    finally:
        restore()
    rel_loss = abs((loss_k - loss_p).item()) / abs(loss_p.item())
    flat = [torch.cat([t.float().flatten() for t in gs])
            for gs in (grads_k, grads_p)]
    rel = ((flat[0] - flat[1]).norm() / flat[1].norm()).item()
    rels = [((gk.float() - gp.float()).norm()
             / gp.float().norm().clamp_min(1e-30)).item()
            for gk, gp in zip(grads_k, grads_p)]
    worst = max(range(len(rels)), key=rels.__getitem__)
    say(f"bf16 train step at {TRAIN_ROWS} rows, kernels vs plain: loss "
        f"{loss_k.item():.6f} vs {loss_p.item():.6f} (rel {rel_loss:.3g}), "
        f"gradient rel L2 {rel:.3g}, worst tensor {rels[worst]:.3g} "
        f"({names[worst]})")
    if not (torch.isfinite(flat[0]).all() and rel_loss <= 1e-2
            and rel <= 5e-2):
        raise AssertionError(f"train step disagrees: loss rel {rel_loss}, "
                             f"gradient rel L2 {rel}")


def run_trainer(device, k1_sites: int, k3_sites: int) -> dict:
    """Training, a main path: the Trainer at small-tpu-1 from seeded
    weights takes TRAIN_STEPS steps on seeded batches; counters must
    rise by exactly the site counts per step.  Returns the launches."""
    from torch.profiler import ProfilerActivity, profile

    cfg = train_config()
    trainer = Trainer(cfg, device=device, seed=SEED)
    rng = np.random.default_rng(SEED + 7)
    batches = [train_batch(cfg, it, rng) for it in range(TRAIN_STEPS + 1)]
    start = [p.detach().clone() for p in trainer.params]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    group_norm_act.launches = group_norm_act_backward.launches = 0
    spatial_self_attention.launches = 0
    group_norm_act_backward.grad_copies = 0
    mark = tracing.mark()
    losses, times = [], []
    for it in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(trainer.train_step(batches[it]).item())
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {"k1": group_norm_act.launches,
                "k2": group_norm_act_backward.launches,
                "k3": spatial_self_attention.launches}
    copies = group_norm_act_backward.grad_copies
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = forwards_since(mark)
    say(f"train step spans: {span_summary(mark)}")
    want = {"k1": k1_sites * steps, "k2": k1_sites * steps,
            "k3": k3_sites * steps}
    if steps != TRAIN_STEPS or launches != want:
        raise AssertionError(f"training launch counters {launches} != {want}"
                             f" ({steps} UNet forwards)")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    moved = sum(not torch.equal(a, b) for a, b in zip(trainer.params, start))
    if not moved:
        raise AssertionError("no parameter changed in training")
    steady = sorted(times[1:])
    say(f"Trainer small-tpu-1, {TRAIN_ROWS} rows bf16: losses "
        + " ".join(f"{v:.5f}" for v in losses)
        + f"; ms per step: first {times[0]:.1f}, then "
        + " ".join(f"{t:.1f}" for t in times[1:])
        + f" (median {steady[len(steady) // 2]:.1f}); peak memory "
        f"{peak_gb:.2f} GiB; {moved}/{len(start)} parameter tensors moved;"
        f" {copies} upstream gradients copied to rows before K2")
    say(f"launches on the training path: K1 {launches['k1']}, K2 "
        f"{launches['k2']}, K3 {launches['k3']} over {steps} steps")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.train_step(batches[TRAIN_STEPS]).item()
    busy = report_profile(prof, f"one training step at {TRAIN_ROWS} rows",
                          (time.perf_counter() - t0) * 1e3)
    median = steady[len(steady) // 2]
    say(f"device busy {busy:.2f} ms against the unprofiled median step "
        f"{median:.1f} ms: {busy / median:.0%} (the profiler slows the "
        f"host, not the kernels)")
    return launches, median


def check_train_against_cpu(device) -> None:
    """Two tiny f32 train steps (packed, EMA, warmup: the first update is
    zero) on the card against the same steps on the CPU, from the same
    state with the same batches and fed draws."""
    raw = json.loads(json.dumps(PAPER_CONFIG))
    raw["model"]["denoise_net_params"] = TINY_UNET
    raw["model"]["view_fusion_params"]["beta_schedule"]["train"][
        "num_timesteps"] = 20
    raw["data"]["params"].update(batch_size=4, max_views=3)
    raw["tpu"].update(compute_dtype="float32", ema_decay=0.9, lr_warmup=1,
                      peak_lr=1e-5)
    cfg = Config.from_dict(raw)
    torch.manual_seed(SEED)
    state = UNet(cfg.unet).state_dict()
    train_against_cpu(device, cfg, state, "tiny f32 train steps")


def train_against_cpu(device, cfg: Config, state: dict, what: str) -> None:
    """Two train steps of ``cfg`` from ``state`` on the card against the
    same steps on the CPU: losses, parameters, gradients and EMA within
    1e-4 (gradients: of their scale)."""
    rng = np.random.default_rng(SEED + 8)
    batches = [train_batch(cfg, it, rng) for it in range(2)]
    draws = [(rng.normal(size=(4, 8, 8, 3)).astype(np.float32),
              rng.uniform(0.05, 0.95, 4).astype(np.float32))
             for _ in range(2)]
    runs = []
    for dev in ("cpu", device):
        tr = Trainer(cfg, device=dev, state_dict=state)
        losses = [tr.train_step(b, noise=n, sample_gammas=g).item()
                  for b, (n, g) in zip(batches, draws)]
        runs.append((losses, [[t.detach().cpu() for t in ts] for ts in (
            tr.params, [p.grad for p in tr.params], tr.ema)]))
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(runs[1][0],
                                                       runs[0][0]))
    errs = [max((a - b).abs().max().item() for a, b in zip(got, want))
            for got, want in zip(runs[1][1], runs[0][1])]
    gmax = max(g.abs().max().item() for g in runs[0][1][1])
    say(f"{what}, card vs CPU: loss rel {loss_err:.3g}, "
        f"params {errs[0]:.3g}, gradients {errs[1]:.3g} (of {gmax:.3g}), "
        f"EMA {errs[2]:.3g}")
    if not (loss_err <= 1e-4 and errs[0] <= 1e-4 and errs[1] <= 1e-4 * gmax
            and errs[2] <= 1e-4):
        raise AssertionError(f"{what}: card disagrees with the CPU")


def is_conv3x3(m) -> bool:
    """A stride-1 SAME 3x3 conv of the UNet: the convs K4 can serve."""
    return (isinstance(m, unet_module.Conv2d) and m.kernel_size == (3, 3)
            and m.stride == (1, 1) and m.padding == (1, 1))


def conv_sites(unet: UNet, rows: int, device) -> Counter:
    """(H, W, Cin, Cout) of every stride-1 3x3 conv of one forward at
    ``rows`` rows, with their counts, read by hooks on the model."""
    found = Counter()
    hooks = [m.register_forward_pre_hook(
        lambda m, a: found.update([(a[0].shape[2], a[0].shape[3],
                                    a[0].shape[1], m.out_channels)]))
        for m in unet.modules() if is_conv3x3(m)]
    with torch.inference_mode():
        unet(*unet_inputs(rows, unet.config, device))
    for h in hooks:
        h.remove()
    return found


def check_conv_wgrad(sites, device) -> dict:
    """K4 against its plain version at every stride-1 3x3 conv site of the
    paper UNet at the training batch (R = 98 rows): bf16 at every site
    (timed), f32 at the largest site and at a Cin = 6 one.  Per-step
    totals weight each site by its count in one backward."""
    g = torch.Generator(device=device).manual_seed(SEED + 9)
    tot = dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms",
                         "bound_bytes_ms", "max_abs_err"), 0.0)
    ops = lambda s: 2 * 9 * TRAIN_ROWS * s[0] * s[1] * s[2] * s[3]  # noqa
    big = max(sites, key=ops)
    ragged = min(sites, key=lambda s: s[2])
    cases = [(site, torch.bfloat16, n) for site, n in sorted(sites.items())]
    cases += [(big, torch.float32, 0), (ragged, torch.float32, 0)]
    step_ops = step_bytes = 0.0
    for (h, w, cin, cout), dtype, count in cases:
        x = torch.randn((TRAIN_ROWS, h, w, cin), generator=g,
                        device=device).to(dtype)
        gy = torch.randn((TRAIN_ROWS, h, w, cout), generator=g,
                         device=device).to(dtype)
        out = conv3x3_wgrad(x, gy)
        again = conv3x3_wgrad(x, gy)
        ref = conv3x3_wgrad_reference(x, gy)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        scale = ref.abs().max().item()
        tol = 1e-5 * max(1.0, (TRAIN_ROWS * h * w / 4096) ** 0.5) * scale
        name = f"K4 H={h} W={w} Cin={cin} Cout={cout} {str(dtype)[6:]} x{count}"
        if not err <= tol:
            raise AssertionError(f"{name}: err {err} > {tol}")
        if not torch.equal(out, again):
            raise AssertionError(f"{name}: two calls differ")
        if not count:
            say(f"{name}: err {err:.3g} (tol {tol:.3g}), repeatable")
            continue
        x4, g4 = x.permute(0, 3, 1, 2), gy.permute(0, 3, 1, 2)
        w4 = torch.empty((cout, cin, 3, 3), device=device, dtype=dtype)

        def library():
            return torch.ops.aten.convolution_backward(
                g4, x4, w4, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                [False, True, False])[1]

        ms = device_ms(lambda: conv3x3_wgrad(x, gy))
        eager_ms = call_ms(lambda: conv3x3_wgrad(x, gy))
        plain_ms = device_ms(lambda: conv3x3_wgrad_reference(x, gy))
        lib_ms = device_ms(library)
        lib_err = (library().float().permute(2, 3, 1, 0) - ref).abs().max()
        nbytes = (x.numel() + gy.numel()) * x.element_size() + ref.numel() * 4
        bms, by = bound_ms(nbytes, ops((h, w, cin, cout)), dtype)
        step_ops += count * ops((h, w, cin, cout))
        step_bytes += count * nbytes
        say(f"{name}: err {err:.3g} (tol {tol:.3g}) kernel {ms * 1e3:.1f} us "
            f"(eager call {eager_ms * 1e3:.1f} us) plain "
            f"{plain_ms * 1e3:.1f} us library {lib_ms * 1e3:.1f} us (bf16 "
            f"dW, max abs diff {lib_err.item():.3g} of {scale:.3g}) bound "
            f"{bms * 1e3:.1f} us ({by}) = {bms / ms:.0%} of bound; "
            f"kernel / cuDNN {ms / lib_ms:.2f}")
        add_site(tot, count, ms, plain_ms, lib_ms, bms, nbytes, err)
    say(f"K4 work per training step at {TRAIN_ROWS} rows: "
        f"{sum(sites.values())} conv sites ({len(sites)} distinct), "
        f"{step_ops / 1e12:.3f} TFLOP = {step_ops / 989e12 * 1e3:.3f} ms at "
        f"989 TF/s; {step_bytes / 1e9:.3f} GB = "
        f"{step_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms at 3.35 TB/s")
    return tot


def route_convs(unet: UNet, impl: str):
    """Route every stride-1 3x3 conv of ``unet`` through ``conv3x3`` (the
    same F.conv2d forward; the weight gradient by ``impl``); returns the
    patched modules and the restore function."""
    convs = [m for m in unet.modules() if is_conv3x3(m)]

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return conv3x3(x, self.weight.to(x.dtype), b, impl=impl)

    for m in convs:
        m.forward = forward.__get__(m)

    def restore():
        for m in convs:
            del m.forward
    return convs, restore


def check_conv3x3_step(device, n_sites: int) -> int:
    """One full-width bf16 packed training step with every stride-1 3x3
    conv routed through conv3x3(impl="kernel") against the same step
    unpatched (cuDNN's weight gradients): the same loss bit for bit, K4
    launched once per conv, each conv weight gradient within 1e-2
    relative L2 (the reference is rounded to bf16: one ulp is 2^-8 =
    3.9e-3 relative), all gradients within phase 9's 5e-2.  Returns the
    launches."""
    model, names, step = packed_train_step(device)
    loss_u, grads_u = step()
    convs, restore = route_convs(model.unet, "kernel")
    conv3x3_wgrad.launches = 0
    conv3x3.input_copies = conv3x3.grad_copies = 0
    try:
        loss_k, grads_k = step()
        torch.cuda.synchronize()
    finally:
        restore()
    launches = conv3x3_wgrad.launches
    if not (len(convs) == n_sites and launches == n_sites):
        raise AssertionError(f"conv3x3 step: {launches} K4 launches for "
                             f"{len(convs)} convs, {n_sites} sites")
    if not torch.equal(loss_k, loss_u):
        raise AssertionError(f"conv3x3 step: loss {loss_k.item()} != "
                             f"{loss_u.item()}")
    index = {n: i for i, n in enumerate(names)}
    conv_names = {f"{n}.weight" for n, m in model.unet.named_modules()
                  if m in convs}
    rels = {n: ((grads_k[index[n]].float() - grads_u[index[n]].float()).norm()
                / grads_u[index[n]].float().norm()).item()
            for n in conv_names}
    worst = max(rels, key=rels.get)
    flat = [torch.cat([t.float().flatten() for t in gs])
            for gs in (grads_k, grads_u)]
    rel = ((flat[0] - flat[1]).norm() / flat[1].norm()).item()
    say(f"bf16 train step at {TRAIN_ROWS} rows with {len(convs)} convs "
        f"through conv3x3(impl='kernel'): loss equal ({loss_k.item():.6f}), "
        f"{launches} K4 launches, conv weight gradients against cuDNN's: "
        f"worst rel L2 {rels[worst]:.3g} ({worst}), median "
        f"{sorted(rels.values())[len(rels) // 2]:.3g}; all gradients rel L2 "
        f"{rel:.3g}; {conv3x3.input_copies} inputs and "
        f"{conv3x3.grad_copies} upstream gradients copied to NHWC rows")
    if not (rels[worst] <= 1e-2 and rel <= 5e-2
            and torch.isfinite(flat[0]).all()):
        raise AssertionError(f"conv3x3 step: conv gradient rel L2 "
                             f"{rels[worst]}, all gradients {rel}")
    return launches


def run_ancestral(device, k1_sites: int, k3_sites: int) -> dict:
    """The reference's ancestral chain, the third main path: the Trainer at
    the paper config (seeded weights) evaluates a batch of ANCESTRAL_BATCH
    at the stratified view counts (R = 28 packed rows) with tpu.sampler
    ddpm, the T = 2000 steps of the active schedule in ANCESTRAL_SEGMENTS
    segments.  K1 (timed) and K3 are first held against their plain
    versions at the sites and row count of this path; then the counters
    must rise by exactly the site counts per step.  Returns the launches,
    the kernels' errors at this path's sites and K1's per-forward totals
    there."""
    cfg = train_config(chain_segments=ANCESTRAL_SEGMENTS)
    trainer = Trainer(cfg, device=device, seed=SEED)
    model = trainer._infer_model
    T = model.schedule.num_timesteps
    rng = np.random.default_rng(SEED + 10)
    n, hw = cfg.data.max_views, cfg.unet.image_size
    counts, si, vi = global_packed_counts(cfg.train.seed, 0, ANCESTRAL_BATCH,
                                          n)
    batch = {"cond": rng.integers(0, 256, (len(counts), n, hw, hw, 3),
                                  dtype=np.uint8),
             "view_count": counts.astype(np.int32), "sample_idx": si,
             "view_idx": vi,
             "angle": rng.uniform(0, 2 * np.pi, len(counts)).astype(
                 np.float32)}
    gn_sites, attn_sites = sites(model.unet, len(si), device)
    if (sum(gn_sites.values()), sum(attn_sites.values())) != (k1_sites,
                                                              k3_sites):
        raise AssertionError(f"sites at {len(si)} rows differ: {gn_sites}, "
                             f"{attn_sites}")
    k1 = check_group_norm(gn_sites, cfg.unet.norm_groups, device,
                          rows=len(si))
    k1["rows"] = len(si)
    say(f"K1 per forward at {len(si)} rows: kernel {k1['ms']:.4f} ms, plain "
        f"{k1['plain_ms']:.4f} ms, library {k1['library_ms']:.4f} ms, bound "
        f"{k1['bound_ms']:.4f} ms")
    errs = {"k1": k1["max_abs_err"],
            "k3": check_attention(attn_sites, device, rows=len(si),
                                  timed=False)["max_abs_err"]}
    gen =trainer._gen_inputs(batch["cond"], counts, batch["angle"], 0)[0]
    torch.cuda.synchronize()
    group_norm_act.launches = spatial_self_attention.launches = 0
    mark = tracing.mark()
    t0 = time.perf_counter()
    out = trainer._eval_samples(gen, batch)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = {"k1": group_norm_act.launches,
                "k3": spatial_self_attention.launches}
    steps = forwards_since(mark)
    if steps != T or launches != {"k1": k1_sites * T, "k3": k3_sites * T}:
        raise AssertionError(f"ancestral launch counters {launches} over "
                             f"{steps} steps != sites x {T}")
    if not (out.shape == (len(counts), hw, hw, 3)
            and torch.isfinite(out).all()):
        raise AssertionError(f"bad ancestral output {tuple(out.shape)}")
    say(f"ancestral chain (ddpm, T={T}, {ANCESTRAL_SEGMENTS} segments), "
        f"batch of {len(counts)} at view counts {counts.tolist()} "
        f"({len(si)} packed rows), bf16: {sec:.2f} s per batch = "
        f"{sec / T * 1e3:.2f} ms per step on {card_line()}; samples in "
        f"[{out.min().item():.3f}, {out.max().item():.3f}]")
    say(f"launches on the ancestral path: K1 {launches['k1']}, K3 "
        f"{launches['k3']} over {steps} steps")
    profile_chain(trainer, batch)
    return launches, errs, k1


def profile_chain(trainer: Trainer, batch: dict, steps: int = 10) -> None:
    """Device time of ``steps`` ancestral steps at the eval batch against
    their wall time (the rest is the device waiting on the host)."""
    from torch.profiler import ProfilerActivity, profile

    model = trainer._infer_model
    gen, cond, vc, angle = trainer._gen_inputs(
        batch["cond"], batch["view_count"], batch["angle"], 1)
    idx = tuple(a.long() for a in to_device(
        (batch["sample_idx"], batch["view_idx"]), trainer.device))
    carry = model.init_chain(cond, vc, trainer.config.train.sample_num,
                             capture_aux=False, generator=gen)
    segment = lambda ts: model.chain_segment(  # noqa: E731
        carry, ts, cond, vc, angle, trainer.config.train.sample_num, idx)
    segment(range(2 * steps - 1, steps - 1, -1))  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        segment(range(steps - 1, -1, -1))
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    busy = report_profile(prof, f"{steps} ancestral steps at "
                          f"{len(idx[0])} rows", wall)
    say(f"ancestral step: device busy {busy / steps:.2f} ms of "
        f"{wall / steps:.2f} ms wall (profiled)")


def check_ancestral_against_cpu(device) -> None:
    """A tiny f32 ancestral chain with frame, logit and weight capture on
    the card against the same chain on the CPU (fed y_T and draws), and a
    3-segment chain on the card against one generate() call on the card
    (generator draws), bit for bit."""
    raw = json.loads(json.dumps(PAPER_CONFIG))
    raw["model"]["denoise_net_params"] = TINY_UNET
    raw["model"]["view_fusion_params"]["beta_schedule"]["train"][
        "num_timesteps"] = 20
    raw["tpu"]["compute_dtype"] = "float32"
    cfg = Config.from_dict(raw)
    rng = np.random.default_rng(SEED + 11)
    b, n, hw, T, sample_num = 3, 3, 8, 20, 4
    y_cond = torch.from_numpy(rng.uniform(0, 1, (b, n, hw, hw, 3)).astype(
        np.float32))
    counts = torch.tensor([1, 3, 2])
    angle = torch.from_numpy(rng.uniform(0, 6, b).astype(np.float32))
    y_t = torch.from_numpy(rng.normal(size=(b, hw, hw, 3)).astype(np.float32))
    noise = [torch.from_numpy(rng.normal(size=(b, hw, hw, 3)).astype(
        np.float32)) for _ in range(T)]
    outs, models = [], []
    for dev in ("cpu", device):
        torch.manual_seed(SEED)
        model = ViewFusion.from_config(cfg)
        model.unet.to(dev).eval()
        models.append(model)
        args = (y_cond.to(dev), counts.to(dev), angle.to(dev))
        outs.append(model.generate(*args, y_t=y_t.to(dev),
                                   sample_num=sample_num, noise=noise))
    errs = {name: (a.cpu() - b_.cpu()).abs().max().item()
            for name, a, b_ in zip(outs[0]._fields, outs[1], outs[0])}
    say("tiny f32 ancestral chain with capture, card vs CPU: "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    if not max(errs.values()) <= 1e-4:
        raise AssertionError(f"card ancestral chain disagrees: {errs}")
    model = models[1]
    args = (y_cond.to(device), counts.to(device), angle.to(device))
    gen = lambda: torch.Generator(device=device).manual_seed(SEED)  # noqa
    one = model.generate(*args, sample_num=sample_num, generator=gen())
    carry = model.init_chain(args[0], args[1], sample_num, generator=gen())
    for hi, lo in ((20, 13), (13, 6), (6, 0)):
        carry = model.chain_segment(carry, range(hi - 1, lo - 1, -1), *args,
                                    sample_num=sample_num)
    seg = model.finalize_chain(carry)
    if not all(torch.equal(a, b_) for a, b_ in zip(one, seg)):
        raise AssertionError("segmented chain on the card differs from one "
                             "generate() call")
    say("tiny 3-segment ancestral chain on the card equals one generate() "
        "call bit for bit")


EXP_OBJECTS = 64          # per split: 4 shards of 16, ~19 MB at 64 px
EXP_MAX_IT, EXP_RESUME_IT = 30, 35
EXP_FIELDS = ["params", "opt_state", "step", "ema_params"]


def experiment_config(data_dir: str, source: str = "configs/small-tpu-1.yaml",
                      phase: int = 16, **changes) -> str:
    """``source`` through the port's YAML reader, cut to a short run on the
    phase's shards (phase 16: 30 steps of configs/small-tpu-1.yaml);
    ``changes`` ("model__max_it": 10, ...) replace fields.  Writes it
    beside the shards and returns its path.  The model's widths stay as
    published."""
    raw = parse_yaml(Path(source).read_text())
    defaults = {"model.max_it": EXP_MAX_IT, "model.checkpoint_every": 10,
                "model.log_every": 5, "model.validate_from": 20,
                "model.validate_every": 10,
                "data.params.test.params.size": 56, "tpu.sampler": "ddim",
                "tpu.ddim_steps": 20, "tpu.ema_decay": 0.999,
                "tpu.profile_from": 12, "tpu.profile_steps": 2}
    changes = {**defaults,
               **{k.replace("__", "."): v for k, v in changes.items()}}
    for split in ("train", "test", "validation"):
        changes[f"data.params.{split}.params.path"] = data_dir
    for key, value in changes.items():
        node = raw
        *path, last = key.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = value
    say(f"phase {phase} config: {source} with "
        + ", ".join(f"{k}={v}" for k, v in changes.items()
                    if not k.endswith(".path"))
        + f", data paths -> the phase's shards")
    path = os.path.join(data_dir, f"{Path(source).stem}-phase{phase}.yaml")
    with open(path, "w") as f:
        f.write(dump_yaml(raw))
    return path


def compare_readers(data_dir: str) -> str:
    """The native reader against the codec on one train shard."""
    if not native_loader.native_available():
        return (f"the native loader did not build, so the codec read the "
                f"shards: {native_loader.build_error()}")
    shard = os.path.join(data_dir, "NMR-train-00.tar")
    reader = native_loader.NativeShardReader([shard], resample=False)
    native = {key: views for views, key in reader}
    reader.close()
    codec = {s["__key__"]: decode_views_u8(s)
             for s in iter_tar_samples(shard)}
    if native.keys() != codec.keys() or not all(
            np.array_equal(native[k], codec[k]) for k in codec):
        raise AssertionError("the native reader and the codec disagree")
    return (f"native and codec readers equal on {len(codec)} objects of "
            f"{os.path.basename(shard)}")


def _post(port: int, body: dict):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def serve_run_dir(run: str, device) -> int:
    """ViewFusionService on the run dir answers two base64-PNG requests
    over HTTP, from the EMA shadow; returns its UNet forwards."""
    mark = tracing.mark()
    service = ViewFusionService(run, batch_size=2, default_steps=20,
                                device=device)
    state, _ = Checkpoint(run).load("best_model_all.msgpack",
                                    dict.fromkeys(EXP_FIELDS))
    # a GroupNorm scale: f32 in the service, moved by Adam, not by EMA yet
    key = "final_conv.block.0.weight"
    served = service.model.unet.state_dict()[key].cpu()
    for field, same in (("ema_params", True), ("params", False)):
        w = unet_state_dict_from_jax(state[field])[key]
        if torch.equal(served, w) != same:
            raise AssertionError(f"the service does not serve the EMA "
                                 f"shadow ({field})")
    httpd = make_server(service, host="127.0.0.1", port=0)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    rng = np.random.default_rng(SEED + 16)
    hw = service.image_size
    try:
        for i in range(2):
            views = [base64.b64encode(encode_png(rng.integers(
                0, 256, (hw, hw, 3), dtype=np.uint8))).decode()
                for _ in range(1 + 2 * i)]
            code, out = _post(httpd.server_address[1], {
                "views": views, "angle": 0.7 * i, "steps": 20})
            if code != 200:
                raise AssertionError(f"HTTP {code} {out}")
            img = decode_png(base64.b64decode(out["image"]))
            if img.shape != (hw, hw, 3):
                raise AssertionError(f"bad served image {img.shape}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(30)
    say(f"served run dir spans: {span_summary(mark)}")
    return forwards_since(mark)


def run_experiment(k1_sites: int, k3_sites: int, trainer_ms: float):
    """The experiment loop, a main path: cli.main -t, -r, -e and -i on
    a run dir in a temporary directory, then the run dir served.  Returns
    the launches of the phase and the loop's median ms per step."""
    cwd = os.getcwd()
    tmp = tempfile.TemporaryDirectory(prefix="vf-phase16-")
    try:
        data = os.path.join(tmp.name, "data")
        t0 = time.perf_counter()
        for mode, seed in (("train", 1), ("test", 2)):
            make_synthetic_shards(data, mode, num_objects=EXP_OBJECTS,
                                  num_shards=4, image_size=64, seed=seed,
                                  family="shaded")
        mb = sum(f.stat().st_size for f in Path(data).iterdir()) / 2 ** 20
        say(f"phase 16 shards: {2 * EXP_OBJECTS} objects x 24 views at 64 "
            f"px, {mb:.1f} MB, written in {time.perf_counter() - t0:.1f} s")
        # one eval, at 30: the vis grid's 2000-step chain is the phase's
        # longest part
        cfg_path = experiment_config(data, model__validate_from=30)
        group_norm_act.launches = group_norm_act_backward.launches = 0
        spatial_self_attention.launches = 0
        forwards, steps, exps = 0, 0, []

        def drive(argv):
            nonlocal forwards, steps
            mark = tracing.mark()
            exp = cli.main(argv)
            forwards += forwards_since(mark)
            exps.append(exp)
            return exp

        os.chdir(tmp.name)
        t0 = time.perf_counter()
        train_mark = tracing.mark()
        exp = drive(["-c", cfg_path, "-t"])
        train_s = time.perf_counter() - t0
        run = os.path.abspath(exp.out_dir)
        steps += exp.trainer.step
        records = [json.loads(line) for line in open(
            os.path.join(run, "metrics.jsonl"))]
        losses = {r["it"]: r["loss"] for r in records if "loss" in r}
        evals = {r["it"]: (r["ssim"], r["psnr"]) for r in records
                 if "ssim" in r}
        missing = [n for n in ("config.yaml", "model.msgpack",
                               "best_model_ssim.msgpack",
                               "best_model_psnr.msgpack",
                               "best_model_all.msgpack", "output-30.png")
                   if not os.path.exists(os.path.join(run, n))]
        if (missing or sorted(losses) != list(range(0, EXP_MAX_IT + 1, 5))
                or not all(np.isfinite(v) for v in losses.values())
                or sorted(evals) != [30] or exp.it != EXP_MAX_IT):
            raise AssertionError(f"-t run dir: missing {missing}, losses "
                                 f"{losses}, evals {evals}, it {exp.it}")
        say(f"-t: {exp.trainer.step} steps in {train_s:.1f} s (an eval and "
            f"its vis grid), reader {exp.train_stream.reader}; losses "
            + " ".join(f"{k}:{v:.5f}" for k, v in sorted(losses.items()))
            + "; eval " + ", ".join(f"it {k}: ssim {a:.4f} psnr {b:.2f}"
                                    for k, (a, b) in sorted(evals.items())))
        say(compare_readers(data))
        step_ends = [sp.end / 1e9 for sp in
                     tracing.spans("train.step", after=train_mark)]
        eval_seconds = [sp.seconds for sp in
                        tracing.spans("eval.pass", after=train_mark)]
        say(f"-t spans: {span_summary(train_mark)}")
        gaps = np.diff(step_ends)[1:10] * 1e3  # steps 2..10
        loop_ms = float(np.median(gaps))
        busy = 0.0
        if exp.last_profile is not None:
            prof, wall, n = exp.last_profile
            busy = report_profile(prof, f"{n} loop steps at {TRAIN_ROWS} "
                                  "rows", wall * 1e3) / n
            say(f"loop step: device busy {busy:.2f} ms of "
                f"{wall * 1e3 / n:.1f} ms wall per profiled step, idle "
                f"{1 - busy * n / (wall * 1e3):.0%}")

        # one synchronous save and one load of model.msgpack
        tr = exp.trainer
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exp.checkpoint.save("model.msgpack", trainer_state_to_jax(tr),
                            **exp._checkpoint_extra)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(os.path.join(run, "model.msgpack")) / 1e6
        t0 = time.perf_counter()
        state, _ = exp.checkpoint.load("model.msgpack",
                                       dict.fromkeys(EXP_FIELDS))
        read_s = time.perf_counter() - t0
        before = [p.detach().clone() for p in tr.params]
        load_trainer_state(tr, state)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        if not all(torch.equal(a, b) for a, b in zip(before, tr.params)):
            raise AssertionError("model.msgpack did not load back exactly")
        say(f"timing on {card_line()}: loop median {loop_ms:.1f} ms per "
            f"step (steps 2-10) against the Trainer's {trainer_ms:.1f} ms "
            f"(phase 10); model.msgpack {size:.0f} MB: save {save_s:.2f} s "
            f"(sync), load {load_s:.2f} s ({read_s:.2f} s read and "
            f"decode); eval passes "
            + ", ".join(f"{v:.2f} s" for v in eval_seconds)
            + f"; idle share {(1 - busy / loop_ms) if busy else 0:.0%} of "
            "the loop's median step")
        del exp, state, before, tr
        exps.clear()
        torch.cuda.empty_cache()

        # -r from it = 30 with max_it raised in the snapshot
        snap = os.path.join(run, "config.yaml")
        raw = parse_yaml(Path(snap).read_text())
        raw["model"]["max_it"] = EXP_RESUME_IT
        Path(snap).write_text(dump_yaml(raw))
        exp = drive(["-s", run, "-r", "-t"])
        new = [json.loads(line)["it"] for line in open(
            os.path.join(run, "metrics.jsonl"))][len(records):]
        if (exp.it, exp.trainer.step, new) != (
                EXP_RESUME_IT, EXP_RESUME_IT + 1, [EXP_RESUME_IT]):
            raise AssertionError(f"resume: it {exp.it}, step "
                                 f"{exp.trainer.step}, new records {new}")
        steps += EXP_RESUME_IT - EXP_MAX_IT
        say(f"-r: continued from it {EXP_MAX_IT} to {exp.it} (updates "
            f"{exp.trainer.step})")
        exps.clear()
        del exp
        torch.cuda.empty_cache()

        eval_mark = tracing.mark()
        exp = drive(["-s", run, "-e"])
        last = json.loads(open(os.path.join(run, "metrics.jsonl"))
                          .readlines()[-1])
        if not {"ssim", "psnr"} <= set(last):
            raise AssertionError(f"-e logged {last}")
        eval_pass = tracing.spans("eval.pass", after=eval_mark)[0]
        say(f"-e: ssim {last['ssim']:.4f} psnr {last['psnr']:.2f} in "
            f"{eval_pass.seconds:.2f} s")
        exps.clear()
        del exp

        t0 = time.perf_counter()
        exp = drive(["-s", run, "-i", "-ex", "-ar", "-gif"])
        it = max(exp.it, 0)
        made = [f"extrapolate-{it}.png", f"autoregressive_single-{it}.png",
                f"autoregressive_animated-{it}.gif",
                f"weights_animated-{it}.gif"]
        if not all(os.path.exists(os.path.join(run, n)) for n in made):
            raise AssertionError(f"-i left {sorted(os.listdir(run))}")
        say(f"-i -ex -ar -gif: {', '.join(made)} in "
            f"{time.perf_counter() - t0:.1f} s")
        exps.clear()
        del exp
        torch.cuda.empty_cache()

        forwards += serve_run_dir(run, torch.device("cuda"))
        torch.cuda.synchronize()
        launches = {"k1": group_norm_act.launches,
                    "k2": group_norm_act_backward.launches,
                    "k3": spatial_self_attention.launches}
        want = {"k1": k1_sites * forwards, "k2": k1_sites * steps,
                "k3": k3_sites * forwards}
        if launches != want:
            raise AssertionError(f"experiment launch counters {launches} "
                                 f"!= {want} ({forwards} UNet forwards, "
                                 f"{steps} training steps)")
        say(f"launches on the experiment path: K1 {launches['k1']}, K2 "
            f"{launches['k2']}, K3 {launches['k3']} over {forwards} UNet "
            f"forwards and {steps} training steps")
        return launches, loop_ms
    finally:
        os.chdir(cwd)
        tmp.cleanup()


# ----------------------------------------------------------------------
# phases 17-22: the DiT denoiser family and the offline tools
# ----------------------------------------------------------------------
DIT_CONFIG = "configs/dit-small-tpu-4.yaml"
DIT_CHAIN_STEPS = 100     # one segment of the T = 2000 chain
# tests/test_dit.py's CFG: the card-against-CPU step
TINY_DIT = {"image_size": 8, "in_channel": 6, "out_channel": 6,
            "patch_size": 2, "hidden_size": 32, "depth": 2, "num_heads": 2}
LPIPS_PAIRS = 28
DIT_REQUESTS = 3 * BATCH  # three serving batches: one is too short to time


def dit_config(**tpu) -> Config:
    """configs/dit-small-tpu-4.yaml through the port's YAML reader at its
    published widths; the batch of 112 on 4 chips cut to the per-chip 28
    (R = 98 packed rows), as small-tpu-1 is to small-tpu-4."""
    raw = parse_yaml(Path(DIT_CONFIG).read_text())
    raw["data"]["params"]["batch_size"] = TRAIN_BATCH
    raw.setdefault("tpu", {}).update(tpu)
    return Config.from_dict(raw)


def dit_weights(cfg: Config, sigma: float = 0.02) -> dict:
    """Seeded f32 weights of a fresh DiT (flax's init) with every
    zero-init tensor (the adaLN, final_adaLN and unpatchify kernels, every
    bias) drawn from N(0, sigma^2): a fresh DiT is the zero map."""
    torch.manual_seed(SEED)
    dit = ViewFusion.from_config(cfg).unet
    g = torch.Generator().manual_seed(SEED + 20)
    return {k: (v.float() if v.any()
                else torch.randn(v.shape, generator=g) * sigma)
            for k, v in dit.state_dict().items()}


def dit_sites(cfg: Config, rows: int) -> Counter:
    """(B * heads, S, hd) of the DiT's K3 calls per forward at ``rows``."""
    d = cfg.denoiser
    tokens = (d.image_size // d.patch_size) ** 2
    return Counter({(rows * d.num_heads, tokens,
                     d.hidden_size // d.num_heads): d.depth})


def check_attention_dit(cfg: Config, device) -> dict:
    """Phase 17: K3 at the DiT's sites, at the serving (48) and the
    training (98) rows, against its plain version, timed with SDPA and
    the bound; returns the per-forward totals at each row count."""
    out = {}
    for rows in (ROWS, TRAIN_ROWS):
        (b, s, c), n = next(iter(dit_sites(cfg, rows).items()))
        say(f"DiT K3 site at {rows} rows: ({b}, {s}, {c}) x{n} per forward "
            f"on {card_line()}")
        out[rows] = check_attention(Counter({(s, c): n}), device, rows=b,
                                    heads=True)
        out[rows]["rows"] = rows
    return out


def run_dit_serving(cfg: Config, weights: dict, device, k3_sites: int):
    """Phase 18: ViewFusionService on a DiT run dir written by
    write_run_dir answers DIT_REQUESTS requests x 6 views with DDIM 50,
    in batches of 8; the K3 counter must rise by exactly its per-forward
    sites per forward.  Returns the launches and the served images."""
    tmp = tempfile.TemporaryDirectory(prefix="vf-dit-")
    try:
        write_run_dir(tmp.name, cfg, weights)
        service = ViewFusionService(tmp.name, batch_size=BATCH,
                                    max_views=MAX_VIEWS,
                                    default_steps=DDIM_STEPS, device=device)
    finally:
        tmp.cleanup()
    if not isinstance(service.model.unet, DiT):
        raise AssertionError("the DiT run dir did not build a DiT")
    t0 = time.perf_counter()
    service.warmup([DDIM_STEPS], sampler="ddim")
    say(f"DiT warmup (ddim {DDIM_STEPS} steps): "
        f"{time.perf_counter() - t0:.1f} s")
    rng = [np.random.default_rng(SEED + 30 + i) for i in range(DIT_REQUESTS)]
    hw = service.image_size
    results = [None] * DIT_REQUESTS

    def call(i):
        cond = rng[i].uniform(0, 1, (MAX_VIEWS, hw, hw, 3)).astype(
            np.float32)
        t0 = time.perf_counter()
        img = service.submit(cond, angle=0.5 * i, steps=DDIM_STEPS,
                             sampler="ddim")
        results[i] = (img, time.perf_counter() - t0)

    service.batch_log.clear()
    torch.cuda.synchronize()
    spatial_self_attention.launches = 0
    mark = tracing.mark()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=call, args=(i,))
               for i in range(DIT_REQUESTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = spatial_self_attention.launches
    forwards = forwards_since(mark)
    if any(r is None for r in results):
        raise AssertionError("a DiT request did not complete")
    for img, _ in results:
        if not (img.shape == (hw, hw, 3) and np.isfinite(img).all()
                and img.min() >= 0.0 and img.max() <= 1.0):
            raise AssertionError(f"bad DiT output {img.shape}")
    if forwards == 0 or launches != k3_sites * forwards:
        raise AssertionError(f"DiT serving: K3 launches {launches} != "
                             f"{k3_sites} x {forwards} forwards")
    lat = sorted(r[1] for r in results)
    say(f"DiT served {DIT_REQUESTS} requests x {MAX_VIEWS} views, DDIM "
        f"{DDIM_STEPS}, in {wall:.2f} s = {DIT_REQUESTS / wall:.2f} views/s, "
        f"request latency p50 {lat[len(lat) // 2]:.2f} s max {lat[-1]:.2f}"
        f" s on {card_line()}")
    for steps, sampler, n, sec in service.batch_log:
        say(f"  batch {sampler} {steps} steps, {n} requests: "
            f"{sec * 1e3:.0f} ms ({sec * 1e3 / steps:.2f} ms per step, "
            f"{n / sec:.2f} views/s)")
    say(f"launches on the DiT serving path: K3 {launches} over {forwards} "
        f"DiT forwards ({launches // forwards} per forward)")

    from torch.profiler import ProfilerActivity, profile

    dit = service.model.unet
    inputs = unet_inputs(ROWS, dit.config, device, seed=SEED + 31)
    with torch.inference_mode():
        dit(*inputs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dit(*inputs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            dit(*inputs)
            torch.cuda.synchronize()
    report_profile(prof, f"one DiT forward at {ROWS} rows", wall_ms)
    images = [r[0] for r in results]
    del service, dit
    torch.cuda.empty_cache()
    return launches, images


def run_dit_trainer(weights: dict, device,
                    k3_sites: int) -> tuple[dict, dict]:
    """Phase 19: the Trainer on the DiT takes TRAIN_STEPS steps at batch
    28 (R = 98) from the seeded weights, without and with tpu.remat; K3
    must launch exactly its sites per forward, and again in the backward
    under remat, and K5 once per site in each backward, with no
    closed-form attention backward (heads of 64).  Returns K3's and K5's
    launches of both runs."""
    from torch.profiler import ProfilerActivity, profile

    launches, k5 = {}, {}
    for remat in (False, True):
        cfg = dit_config(remat=remat)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()  # what earlier phases hold
        trainer = Trainer(cfg, device=device, state_dict=weights, seed=SEED)
        rng = np.random.default_rng(SEED + 21)
        batches = [train_batch(cfg, it, rng) for it in range(TRAIN_STEPS + 1)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        spatial_self_attention.launches = attention_backward.launches = 0
        _Attention.closed_form_calls = 0
        mark = tracing.mark()
        losses, times = [], []
        for it in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            losses.append(trainer.train_step(batches[it]).item())
            times.append((time.perf_counter() - t0) * 1e3)
        n = spatial_self_attention.launches
        steps = forwards_since(mark)
        want = k3_sites * steps * (2 if remat else 1)
        if steps != TRAIN_STEPS or n != want:
            raise AssertionError(f"DiT training (remat {remat}): K3 "
                                 f"launches {n} != {want} over {steps} steps")
        n5, closed = attention_backward.launches, _Attention.closed_form_calls
        if (n5, closed) != (k3_sites * steps, 0):
            raise AssertionError(
                f"DiT training (remat {remat}): K5 launches {n5} and closed-"
                f"form backwards {closed} != {k3_sites * steps} and 0 over "
                f"{steps} steps")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"non-finite DiT loss: {losses}")
        peak = torch.cuda.max_memory_allocated()
        steady = sorted(times[1:])
        median = steady[len(steady) // 2]
        say(f"DiT Trainer, batch {TRAIN_BATCH} ({TRAIN_ROWS} rows) bf16, "
            f"remat {remat}: losses "
            + " ".join(f"{v:.5f}" for v in losses)
            + f"; ms per step: first {times[0]:.1f}, then "
            + " ".join(f"{t:.1f}" for t in times[1:])
            + f" (median {median:.1f}); peak memory "
            f"{(peak - base) / 2 ** 30:.2f} GiB above the "
            f"{base / 2 ** 30:.2f} GiB earlier phases hold; K3 {n}, K5 {n5} "
            f"launches over {steps} steps; on {card_line()}")
        path = "dit_training_remat" if remat else "dit_training"
        launches[path], k5[path] = n, n5
        if not remat:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                trainer.train_step(batches[TRAIN_STEPS]).item()
            busy = report_profile(
                prof, f"one DiT training step at {TRAIN_ROWS} rows",
                (time.perf_counter() - t0) * 1e3)
            say(f"DiT step: device busy {busy:.2f} ms against the "
                f"unprofiled median {median:.1f} ms: {busy / median:.0%}")
        del trainer
        torch.cuda.empty_cache()
    return launches, k5


def check_dit_train_against_cpu(device) -> None:
    """Phase 19: two tiny f32 DiT train steps on the card against the
    CPU, from perturbed weights (a fresh DiT is the zero map)."""
    raw = parse_yaml(Path(DIT_CONFIG).read_text())
    raw["model"]["denoise_net_params"] = TINY_DIT
    raw["model"]["view_fusion_params"]["beta_schedule"]["train"][
        "num_timesteps"] = 20
    raw["data"]["params"].update(batch_size=4, max_views=3)
    raw["tpu"].update(compute_dtype="float32", ema_decay=0.9, lr_warmup=1,
                      peak_lr=1e-5)
    cfg = Config.from_dict(raw)
    train_against_cpu(device, cfg, dit_weights(cfg, sigma=0.1),
                      "tiny f32 DiT train steps")


def run_dit_ancestral(weights: dict, device, k3_sites: int) -> int:
    """Phase 20: one DIT_CHAIN_STEPS-step segment of the T = 2000
    ancestral chain on the DiT at 28 packed rows (the stratified view
    counts of a batch of 8); K3 must launch exactly its sites per step.
    Returns the launches."""
    cfg = dit_config()
    trainer = Trainer(cfg, device=device, state_dict=weights, seed=SEED)
    model = trainer._infer_model
    T = model.schedule.num_timesteps
    n, hw = cfg.data.max_views, cfg.denoiser.image_size
    rng = np.random.default_rng(SEED + 22)
    counts, si, vi = global_packed_counts(cfg.train.seed, 0, ANCESTRAL_BATCH,
                                          n)
    batch = {"cond": rng.integers(0, 256, (len(counts), n, hw, hw, 3),
                                  dtype=np.uint8),
             "view_count": counts.astype(np.int32), "sample_idx": si,
             "view_idx": vi,
             "angle": rng.uniform(0, 2 * np.pi, len(counts)).astype(
                 np.float32)}
    gen, cond, vc, angle = trainer._gen_inputs(
        batch["cond"], batch["view_count"], batch["angle"], 0)
    idx = tuple(a.long() for a in to_device((si, vi), trainer.device))
    sample_num = cfg.train.sample_num
    carry = model.init_chain(cond, vc, sample_num, capture_aux=False,
                             generator=gen)
    torch.cuda.synchronize()
    spatial_self_attention.launches = 0
    mark = tracing.mark()
    t0 = time.perf_counter()
    carry = model.chain_segment(
        carry, range(T - 1, T - 1 - DIT_CHAIN_STEPS, -1), cond, vc, angle,
        sample_num, idx)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches, steps = spatial_self_attention.launches, forwards_since(mark)
    if steps != DIT_CHAIN_STEPS or launches != k3_sites * steps:
        raise AssertionError(f"DiT ancestral: K3 launches {launches} over "
                             f"{steps} steps != {k3_sites} per step")
    if not torch.isfinite(carry.y_t).all():
        raise AssertionError("non-finite DiT chain state")
    say(f"DiT ancestral segment: {DIT_CHAIN_STEPS} of T={T} steps at "
        f"{len(si)} packed rows (view counts {counts.tolist()}), bf16: "
        f"{sec:.2f} s = {sec / steps * 1e3:.2f} ms per step on "
        f"{card_line()}; K3 {launches} launches")
    profile_chain(trainer, batch)
    del trainer
    torch.cuda.empty_cache()
    return launches


def random_lpips_weights(path: str) -> None:
    """VGG16-shaped seeded random LPIPS weights in the converter's .npz
    layout (HWIO convs, (1, 1, C, 1) non-negative heads)."""
    rng = np.random.default_rng(SEED + 23)
    out, cin, idx = {}, 3, 0
    stages = [(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)]
    for n_convs, ch in stages:
        for _ in range(n_convs):
            out[f"conv{idx}_w"] = (rng.standard_normal((3, 3, cin, ch))
                                   * np.sqrt(2 / (9 * cin))).astype(
                                       np.float32)
            out[f"conv{idx}_b"] = (rng.standard_normal(ch) * 0.01).astype(
                np.float32)
            cin, idx = ch, idx + 1
    for s, (_, ch) in enumerate(stages):
        out[f"lin{s}_w"] = np.abs(rng.standard_normal((1, 1, ch, 1))).astype(
            np.float32) / ch
    np.savez(path, **out)


def check_offline_tools(device, served: list) -> None:
    """Phase 21: LPIPS with seeded random weights on LPIPS_PAIRS pairs at
    64 px, card against CPU (within 1e-4 relative: f32 sums of 13 conv
    layers in another order, TF32 off); then compute_metrics over a PNG
    dump (the DiT's served images and seeded pairs) on the card against
    the CPU: PSNR within 1e-6 relative, SSIM within 1e-6, LPIPS 1e-4
    relative."""
    tmp = tempfile.TemporaryDirectory(prefix="vf-offline-")
    try:
        w = os.path.join(tmp.name, "lpips_random.npz")
        random_lpips_weights(w)
        rng = np.random.default_rng(SEED + 24)
        x = rng.uniform(-1, 1, (LPIPS_PAIRS, 64, 64, 3)).astype(np.float32)
        y = np.clip(x + rng.normal(0, 0.2, x.shape), -1, 1).astype(
            np.float32)
        card_fn = load_lpips(w, device=device)
        xd, yd = (torch.from_numpy(a).to(device) for a in (x, y))
        got = card_fn(xd, yd).cpu()
        want = load_lpips(w, device="cpu")(x, y)
        rel = ((got - want).abs() / want.abs()).max().item()
        ms = call_ms(lambda: card_fn(xd, yd), iters=5, warmup=1)
        say(f"LPIPS (VGG16, random weights) on {LPIPS_PAIRS} pairs at 64 "
            f"px, card vs CPU: max rel {rel:.3g}; {ms:.2f} ms per call on "
            f"{card_line()}")
        if not (got.shape == (LPIPS_PAIRS,) and rel <= 1e-4):
            raise AssertionError(f"LPIPS on the card disagrees: {rel}")
        gen, tgt = os.path.join(tmp.name, "gen"), os.path.join(tmp.name,
                                                               "tgt")
        os.makedirs(gen)
        os.makedirs(tgt)
        pairs = [(img, np.clip(img + rng.normal(0, 0.05, img.shape), 0, 1))
                 for img in served]
        pairs += [((a + 1) / 2, (b + 1) / 2) for a, b in zip(x, y)]
        for i, (a, b) in enumerate(pairs):
            for d, img in ((gen, a), (tgt, b)):
                Path(d, f"{i:04d}.png").write_bytes(encode_png(
                    np.round(np.clip(img, 0, 1) * 255).astype(np.uint8)))
        t0 = time.perf_counter()
        card = compute_metrics.main(["--generated", gen, "--target", tgt,
                                     "--lpips-weights", w, "--batch-size",
                                     "16"])
        sec = time.perf_counter() - t0
        cpu = compute_metrics.compute_folder_metrics(
            gen, tgt, batch_size=16, lpips_weights=w, device="cpu")
        errs = {"psnr": abs(card["psnr"] - cpu["psnr"]) / abs(cpu["psnr"]),
                "ssim": abs(card["ssim"] - cpu["ssim"]),
                "lpips": abs(card["lpips"] - cpu["lpips"]) / cpu["lpips"]}
        say(f"compute_metrics over {card['count']} PNG pairs on the card in "
            f"{sec:.2f} s: psnr {card['psnr']:.4f} ssim {card['ssim']:.4f} "
            f"lpips {card['lpips']:.5f}; against the CPU: "
            + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
        if not (card["count"] == len(pairs) and errs["psnr"] <= 1e-6
                and errs["ssim"] <= 1e-6 and errs["lpips"] <= 1e-4):
            raise AssertionError(f"compute_metrics on the card disagrees "
                                 f"with the CPU: {errs}")
    finally:
        tmp.cleanup()


DIT_EXP_OBJECTS = 32      # per split: 4 shards of 8 at 64 px
DIT_EXP_MAX_IT = 10


def run_dit_experiment(k3_sites: int) -> int:
    """Phase 22: the experiment loop on the DiT through ``cli.main``:
    -t at configs/dit-small-tpu-4.yaml (batch 28) for DIT_EXP_MAX_IT
    steps with an eval and a vis grid at the last, then -e on its run
    dir, on synthetic 64 px shards; K3 must launch exactly its sites per
    DiT forward over the phase, and model.msgpack must hold the DiT's
    tree.  Returns the launches."""
    cwd = os.getcwd()
    tmp = tempfile.TemporaryDirectory(prefix="vf-phase22-")
    try:
        data = os.path.join(tmp.name, "data")
        for mode, seed in (("train", 3), ("test", 4)):
            make_synthetic_shards(data, mode, num_objects=DIT_EXP_OBJECTS,
                                  num_shards=4, image_size=64, seed=seed,
                                  family="shaded")
        cfg_path = experiment_config(
            data, DIT_CONFIG, 22, model__max_it=DIT_EXP_MAX_IT,
            model__validate_from=DIT_EXP_MAX_IT,
            model__validate_every=DIT_EXP_MAX_IT,
            data__params__batch_size=TRAIN_BATCH,
            data__params__test__params__size=TRAIN_BATCH,
            tpu__profile_steps=0)
        cfg_path = os.path.abspath(cfg_path)
        want_keys = set(DiT(dit_config().denoiser).state_dict())
        spatial_self_attention.launches = 0
        forwards = 0

        def drive(argv) -> str:
            nonlocal forwards
            mark = tracing.mark()
            exp = cli.main(argv)
            if not isinstance(exp.trainer.model.unet, DiT):
                raise AssertionError("the CLI did not build a DiT")
            forwards += forwards_since(mark)
            return os.path.abspath(exp.out_dir)

        os.chdir(tmp.name)
        t0 = time.perf_counter()
        run = drive(["-c", cfg_path, "-t"])
        drive(["-s", run, "-e"])
        sec = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = spatial_self_attention.launches
        records = [json.loads(line) for line in open(
            os.path.join(run, "metrics.jsonl"))]
        losses = {r["it"]: r["loss"] for r in records if "loss" in r}
        evals = [(r["it"], r["ssim"], r["psnr"]) for r in records
                 if "ssim" in r]
        missing = [n for n in ("model.msgpack", "best_model_all.msgpack",
                               f"output-{DIT_EXP_MAX_IT}.png")
                   if not os.path.exists(os.path.join(run, n))]
        state, _ = Checkpoint(run).load("model.msgpack",
                                        dict.fromkeys(EXP_FIELDS))
        keys = set(unet_state_dict_from_jax(state["params"]))
        if (missing or sorted(losses) != [0, 5, 10] or len(evals) != 2
                or not all(np.isfinite(v) for v in losses.values())
                or keys != want_keys or launches != k3_sites * forwards):
            raise AssertionError(
                f"DiT experiment: missing {missing}, losses {losses}, evals "
                f"{evals}, DiT tree {keys == want_keys}, K3 {launches} for "
                f"{forwards} forwards")
        say(f"DiT -t ({DIT_EXP_MAX_IT + 1} steps, an eval and an ancestral "
            f"vis grid) and -e through cli.main in {sec:.1f} s; losses "
            + " ".join(f"{k}:{v:.5f}" for k, v in sorted(losses.items()))
            + "; evals " + ", ".join(f"it {i}: ssim {a:.4f} psnr {b:.2f}"
                                     for i, a, b in evals)
            + f"; model.msgpack holds the DiT's {len(keys)} tensors; K3 "
            f"{launches} launches over {forwards} DiT forwards on "
            f"{card_line()}")
        return launches
    finally:
        os.chdir(cwd)
        tmp.cleanup()


@contextlib.contextmanager
def dit_k3_shapes(shapes: dict, path: str):
    """Record the (B, S, C) and dtype of every K3 call that the DiT makes
    on the card while the block runs, under ``path``; the wrapper's own
    counter still counts each launch."""
    real = dit_module.spatial_self_attention

    def recording(q, k, v, scale):
        if q.is_cuda:
            shapes.setdefault((tuple(q.shape), q.dtype), set()).add(path)
        return real(q, k, v, scale)

    dit_module.spatial_self_attention = recording
    try:
        yield
    finally:
        dit_module.spatial_self_attention = real


def run_dit_phases(device) -> dict:
    """Phases 17-22 at configs/dit-small-tpu-4.yaml's widths, then K3
    against its plain version at every shape those paths gave it.
    Returns K3's per-forward totals at the DiT sites (``sites``), K3's
    launches by path, K5's in the training phase (``k5_launches``), K3's
    largest error over the phases and the calls per DiT forward."""
    dcfg = dit_config()
    say(f"DiT: {DIT_CONFIG} read by the port's reader (hidden "
        f"{dcfg.denoiser.hidden_size}, depth {dcfg.denoiser.depth}, "
        f"{dcfg.denoiser.num_heads} heads, patch {dcfg.denoiser.patch_size},"
        f" {dcfg.denoiser.image_size} px, {dcfg.train.compute_dtype}); cut: "
        f"batch 112 on 4 chips -> {TRAIN_BATCH} on one card (R = "
        f"{TRAIN_ROWS}), the ancestral chain -> one {DIT_CHAIN_STEPS}-step "
        f"segment of T = 2000; seeded weights, zero-init layers perturbed")
    calls = sum(dit_sites(dcfg, 1).values())
    sites = check_attention_dit(dcfg, device)                    # 17
    err = max(t["max_abs_err"] for t in sites.values())
    weights = dit_weights(dcfg)
    launches, shapes = {}, {}
    with dit_k3_shapes(shapes, "dit_serving"):                   # 18
        launches["dit_serving"], served = run_dit_serving(
            dcfg, weights, device, calls)
    with dit_k3_shapes(shapes, "dit_training"):                  # 19
        trained, k5_launches = run_dit_trainer(weights, device, calls)
        launches.update(trained)
    check_dit_train_against_cpu(device)
    torch.cuda.empty_cache()
    with dit_k3_shapes(shapes, "dit_ancestral"):                 # 20
        launches["dit_ancestral"] = run_dit_ancestral(weights, device,
                                                      calls)
    check_offline_tools(device, served)                          # 21
    torch.cuda.empty_cache()
    with dit_k3_shapes(shapes, "dit_experiment"):                # 22
        launches["dit_experiment"] = run_dit_experiment(calls)
    for ((b, s, c), dtype), paths in sorted(shapes.items(), key=str):
        say(f"K3 at ({b}, {s}, {c}) {str(dtype)[6:]}, given by "
            f"{', '.join(sorted(paths))}:")
        err = max(err, check_attention(Counter({(s, c): 0}), device, rows=b,
                                       timed=False, heads=True)[
                                           "max_abs_err"])
    return {"sites": sites, "launches": launches, "k5_launches": k5_launches,
            "max_abs_err": err, "calls": calls, "config": dcfg}


# ----------------------------------------------------------------------
# phases 23-24: more than one process under torchrun; dropout on the card
# ----------------------------------------------------------------------
# batch 112: 28 per rank at 4; by absolute path, for the ranks run
# from a temporary directory
MP_CONFIG = str(Path(__file__).resolve().parent / "configs/small-tpu-4.yaml")
MP_RANKS = 4
MP_STEPS = 3                  # phase 24 (a), (b): Trainer steps per case
MP_CASES = (("a", {}), ("a_zero1", {"shard_opt_state": True}),
            ("b_view2", {"mesh_view": 2, "shard_opt_state": True}))
MP_CLI_MAX_IT = 9             # phase 23: it 0..9, ten steps
MP_EXP_MAX_IT = 3             # phase 24 (c): four steps
CHILD_TIMEOUT = 600           # seconds for one torchrun launch
DROPOUT = 0.1


def mp_config(**tpu) -> Config:
    """configs/small-tpu-4.yaml through the port's reader, at its
    published global batch of 112."""
    raw = parse_yaml(Path(MP_CONFIG).read_text())
    raw.setdefault("tpu", {}).update(tpu)
    return Config.from_dict(raw)


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.detach().float().reshape(-1) for t in tensors])


def _local_rows(batch: dict, mesh) -> dict:
    """This rank's samples of a global host batch, with the packed rows
    of its own samples."""
    local = shard_batch({k: v for k, v in batch.items()
                         if k not in ("sample_idx", "view_idx")}, mesh)
    local["sample_idx"], local["view_idx"] = packed_indices(
        local["view_count"])
    return local


def mp_reference(ref_dir: str, device) -> dict:
    """One process on the card at small-tpu-4's batch of 112 (R = 392):
    MP_STEPS Trainer steps on seeded batches, drawing from the
    generator; the parameters before and after each update and the first
    step's gradients go to ``ref_dir`` for the ranks to compare with."""
    cfg = mp_config()
    trainer = Trainer(cfg, device=device, seed=SEED)
    rng = np.random.default_rng(SEED + 24)
    batches = [train_batch(cfg, it, rng) for it in range(MP_STEPS)]
    torch.save(_flat(trainer.params).cpu(), os.path.join(ref_dir,
                                                         "start.pt"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for it, batch in enumerate(batches):
        t0 = time.perf_counter()
        losses.append(trainer.train_step(batch).item())
        times.append((time.perf_counter() - t0) * 1e3)
        if it == 0:
            torch.save(_flat(p.grad for p in trainer.params).cpu(),
                       os.path.join(ref_dir, "grads-0.pt"))
        torch.save(_flat(trainer.params).cpu(),
                   os.path.join(ref_dir, f"params-{it}.pt"))
    out = {"losses": losses, "rows": len(batches[0]["sample_idx"]),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "adam_bytes": sum(t.numel() * t.element_size()
                             for st in trainer.optimizer.state.values()
                             for k, t in st.items() if k != "step"),
           "ms": times}
    say(f"phase 24 reference, one process at batch 112 (R = {out['rows']}):"
        f" losses {' '.join(f'{v:.6f}' for v in losses)}; ms per step "
        + " ".join(f"{t:.1f}" for t in times)
        + f"; peak {out['peak_gib']:.2f} GiB; Adam m and v "
        f"{out['adam_bytes'] / 2 ** 20:.1f} MiB")
    del trainer
    torch.cuda.empty_cache()
    return out


def torchrun(nproc: int, args: list, cwd: str) -> list:
    """``chip_smoke.py --rank-child <args>`` on ``nproc`` ranks under
    ``python -m torch.distributed.run``; each rank writes its record to
    ``child-<rank>.json`` in a fresh directory (the ranks share one output
    pipe, where their lines can interleave).  Returns the ranks' records
    in rank order.  A launch that fails, outlasts CHILD_TIMEOUT or loses a
    rank's record raises; the whole process group is killed on the way
    out."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", str(Path(__file__).resolve()),
           "--rank-child", *args]
    t0 = time.perf_counter()
    records = Path(tempfile.mkdtemp(prefix="records-", dir=cwd))
    proc = subprocess.Popen(cmd, cwd=cwd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True,
                            env={**os.environ, "VF_CHILD_RECORDS": str(
                                records)})
    try:
        out, _ = proc.communicate(timeout=CHILD_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"torchrun {args[0]} on {nproc} ranks outlasted"
                             f" {CHILD_TIMEOUT} s:\n{out[-6000:]}")
    finally:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)
    recs = [json.loads(f.read_text())
            for f in sorted(records.glob("child-*.json"))]
    for line in out.splitlines():
        print("    | " + line)
    if proc.returncode != 0 or len(recs) != nproc:
        raise AssertionError(f"torchrun {args[0]} on {nproc} ranks: rc "
                             f"{proc.returncode}, {len(recs)} records:\n"
                             f"{out[-6000:]}")
    say(f"torchrun {args[0]}: {nproc} ranks in "
        f"{time.perf_counter() - t0:.1f} s")
    return sorted(recs, key=lambda r: r["rank"])


def _child_cli(argv: list) -> dict:
    """``cli.main(argv)`` (``-t``) on this rank, then an eval pass of the
    Experiment (the best-model files); the loop's step times, the run
    dir's checks (rank 0) and what the Experiment ran on."""
    mark = tracing.mark()
    exp = cli.main(argv)
    exp.eval()
    tr = exp.trainer
    run = exp.out_dir
    step_ends = [sp.end / 1e9 for sp in tracing.spans("train.step",
                                                       after=mark)]
    rec = {"forwards": forwards_since(mark), "steps": tr.step, "it": exp.it,
           "loop_ms": float(np.median(np.diff(step_ends)[1:] * 1e3)),
           "zero1": tr.zero1 is not None,
           "fused_feed": exp.config.train.fused_feed,
           "mesh": [exp.mesh.data, exp.mesh.view],
           "eval_seconds": [sp.seconds for sp in
                            tracing.spans("eval.pass", after=mark)],
           "run": run,
           "moment_bytes": tr.zero1.moment_bytes() if tr.zero1 else None}
    if exp.is_host0:
        state, extra = Checkpoint(run).load("model.msgpack",
                                            dict.fromkeys(EXP_FIELDS))
        p_shapes = [a.shape for a in _leaves(state["params"])]
        for key in ("mu", "nu"):
            m_shapes = [a.shape for a in _leaves(
                state["opt_state"]["0"][key])]
            if m_shapes != p_shapes:
                raise AssertionError(f"model.msgpack {key}: not the whole "
                                     f"Adam tree")
        rec["msgpack"] = {"it": extra["it"], "tensors": len(p_shapes),
                          "best": sorted(f for f in os.listdir(run)
                                         if f.startswith("best_model"))}
    return rec


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [np.asarray(tree)]


def _child_steps(ref_dir: str) -> dict:
    """Phase 24 (a), (b): each case of MP_CASES takes MP_STEPS Trainer
    steps on this rank's rows of the reference's batches; rank 0 holds
    its loss, first gradients and parameters against the reference's."""
    device = initialize_distributed("cuda")
    out = {}
    for name, tpu in MP_CASES:
        cfg = mp_config(**tpu)
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        trainer = Trainer(cfg, device=device, seed=SEED)
        rng = np.random.default_rng(SEED + 24)
        batches = [train_batch(cfg, it, rng) for it in range(MP_STEPS)]
        start = torch.load(os.path.join(ref_dir, "start.pt")).to(device)
        rec = {"loss": [], "update_rel": [], "param_max": [], "ms": []}
        for it, batch in enumerate(batches):
            t0 = time.perf_counter()
            rec["loss"].append(trainer.train_step(
                _local_rows(batch, trainer.mesh)).item())
            rec["ms"].append((time.perf_counter() - t0) * 1e3)
            if trainer.mesh.rank:
                continue
            mine = _flat(trainer.params)
            ref = torch.load(os.path.join(ref_dir, f"params-{it}.pt")).to(
                device)
            upd, upd_ref = mine - start, ref - start
            rec["update_rel"].append(
                ((upd - upd_ref).norm() / upd_ref.norm()).item()
                if upd_ref.norm() > 0 else float(upd.norm()))
            rec["param_max"].append((mine - ref).abs().max().item())
            rec.setdefault("lr", []).append(float(trainer.lr_fn(it)))
            if it == 0:
                g = _flat(p.grad for p in trainer.params)
                g_ref = torch.load(os.path.join(ref_dir, "grads-0.pt")).to(
                    device)
                rec["grad_rel"] = ((g - g_ref).norm() / g_ref.norm()).item()
            del mine, ref, upd, upd_ref
        rec["checksum"] = float(_flat(trainer.params).double().sum())
        rec["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
        rec["adam_bytes"] = (trainer.zero1.moment_bytes() if trainer.zero1
                             else sum(t.numel() * t.element_size()
                                      for st in trainer.optimizer.state
                                      .values()
                                      for k, t in st.items() if k != "step"))
        rec["mesh"] = [trainer.mesh.data, trainer.mesh.view]
        out[name] = rec
        del trainer, start
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def unet_rows():
    """Count the UNet forwards by (rows, grad enabled) while the block
    runs: the calls that run the module (not a CUDA graph's capture,
    which runs nothing), and the replayed graphs by their
    ``unet.forward`` spans (a replay does not call the module; it runs
    without autograd)."""
    rows = Counter()
    forward = UNet.forward
    mark = tracing.mark()

    def counted(self, x, *a, **kw):
        if not torch.cuda.is_current_stream_capturing():
            rows[(int(x.shape[0]), torch.is_grad_enabled())] += 1
        return forward(self, x, *a, **kw)

    UNet.forward = counted
    try:
        yield rows
    finally:
        UNet.forward = forward
        for sp in tracing.spans("unet.forward", after=mark):
            if sp.attrs.get("graphed"):
                rows[(sp.attrs["rows"], False)] += 1


def rank_child(argv: list) -> int:
    """A rank of a torchrun launch (``--rank-child cli <cli argv>`` or
    ``--rank-child steps <reference dir>``): runs it with the kernels'
    counters at 0 and the UNet's row counts recorded, then writes its
    record to ``$VF_CHILD_RECORDS/child-<rank>.json``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    group_norm_act.launches = group_norm_act_backward.launches = 0
    spatial_self_attention.launches = 0
    kind, args = argv[0], argv[1:]
    with unet_rows() as rows:
        rec = _child_cli(args) if kind == "cli" else {"cases": _child_steps(
            args[0])}
    torch.cuda.synchronize()
    rec.update(rank=dist.get_rank(), world=dist.get_world_size(),
               backend=dist.get_backend(),
               device=torch.cuda.current_device(),
               launches={"k1": group_norm_act.launches,
                         "k2": group_norm_act_backward.launches,
                         "k3": spatial_self_attention.launches},
               rows=[[r, g, n] for (r, g), n in sorted(rows.items())],
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    path = Path(os.environ["VF_CHILD_RECORDS"]) / f"child-{rec['rank']}"
    path.with_suffix(".tmp").write_text(json.dumps(rec))
    path.with_suffix(".tmp").replace(path.with_suffix(".json"))
    dist.destroy_process_group()
    return 0


def check_rank_rows(rows: dict, groups: int, device,
                    whose: str = "the ranks'") -> dict:
    """K1 and K3 at every row count ``rows`` holds (the per-rank counts
    the ranks' UNets ran at, or those of one path), K2 at the training
    ones, each against its plain version at every site of the paper UNet
    (untimed).  Returns the largest errors."""
    unet = paper_unet(device)
    errs = {"k1": 0.0, "k2": 0.0, "k3": 0.0}
    for r in sorted(rows):
        gn, attn = sites(unet, r, device)
        with contextlib.redirect_stdout(io.StringIO()):
            e = {"k1": check_group_norm(gn, groups, device, rows=r,
                                        timed=False)["max_abs_err"],
                 "k3": check_attention(attn, device, rows=r,
                                       timed=False)["max_abs_err"]}
            if rows[r]:
                e["k2"] = check_group_norm_backward(
                    Counter(dict.fromkeys(gn, 0)), groups, device,
                    rows=r)["max_abs_err"]
        for k, v in e.items():
            errs[k] = max(errs[k], v)
        say(f"  K1/K2/K3 at {whose} {r} rows "
            f"({'training' if rows[r] else 'no grad'}) against their plain "
            "versions at every site: "
            + ", ".join(f"{k} {v:.3g}" for k, v in e.items()))
    del unet
    torch.cuda.empty_cache()
    return errs


def _check_launches(recs, k1_sites: int, k3_sites: int, what: str) -> dict:
    """Each rank's counters against its UNet forwards and steps; returns
    the ranks' sums."""
    total = Counter()
    for r in recs:
        fwd = sum(n for _, _, n in r["rows"])
        steps = sum(n for _, g, n in r["rows"] if g)
        want = {"k1": k1_sites * fwd, "k2": k1_sites * steps,
                "k3": k3_sites * fwd}
        if r["launches"] != want or not fwd:
            raise AssertionError(f"{what} rank {r['rank']}: launches "
                                 f"{r['launches']} != {want}")
        total.update(r["launches"])
    return dict(total)


def check_dropout_against_cpu(device, k1_sites: int, k3_sites: int) -> dict:
    """One dense f32 training step at small-tpu-1's widths with dropout
    0.1 (batch cut to 2: 12 UNet rows) on the card, its masks drawn from
    the Trainer's generator, against the same step on the CPU with those
    masks fed in: loss and gradients within 1e-4.  Returns the
    launches."""
    raw = json.loads(json.dumps(PAPER_CONFIG))
    raw["model"]["denoise_net_params"]["dropout"] = DROPOUT
    raw["data"]["params"]["batch_size"] = 2
    raw["tpu"].update(packed_views=False, compute_dtype="float32")
    cfg = Config.from_dict(raw)
    card = Trainer(cfg, device=device, seed=SEED)
    state = {k: v.detach().cpu() for k, v in
             card.model.unet.state_dict().items()}
    cpu = Trainer(cfg, device="cpu", state_dict=state)
    rng = np.random.default_rng(SEED + 25)
    b, n, hw = 2, cfg.data.max_views, cfg.unet.image_size
    batch = {"target": rng.uniform(0, 1, (b, hw, hw, 3)).astype(np.float32),
             "cond": rng.uniform(0, 1, (b, n, hw, hw, 3)).astype(np.float32),
             "angle": rng.uniform(0, 6.3, b).astype(np.float32),
             "view_count": np.asarray([3, 6], np.int32)}
    noise = rng.normal(size=(b, hw, hw, 3)).astype(np.float32)
    gammas = rng.uniform(0.05, 0.95, b).astype(np.float32)
    masks = {}
    draw = UNet._dropout_mask

    def record(self, layer, h, name, dropout):
        mask = draw(self, layer, h, name, dropout)
        masks[name + ".res_block.block2.block.2"] = mask.permute(
            0, 2, 3, 1).cpu()
        return mask

    group_norm_act.launches = group_norm_act_backward.launches = 0
    spatial_self_attention.launches = 0
    UNet._dropout_mask = record
    try:
        loss_card = card.train_step(batch, noise=noise,
                                    sample_gammas=gammas).item()
    finally:
        UNet._dropout_mask = draw
    torch.cuda.synchronize()
    launches = {"k1": group_norm_act.launches,
                "k2": group_norm_act_backward.launches,
                "k3": spatial_self_attention.launches}
    want = {"k1": k1_sites, "k2": k1_sites, "k3": k3_sites}
    if launches != want:
        raise AssertionError(f"dropout step launches {launches} != {want}")
    loss_cpu = cpu.train_step(batch, noise=noise, sample_gammas=gammas,
                              masks=masks).item()
    g_card = _flat(p.grad for p in card.params).cpu()
    g_cpu = _flat(p.grad for p in cpu.params)
    rel_loss = abs(loss_card - loss_cpu) / abs(loss_cpu)
    g_err = (g_card - g_cpu).abs().max().item() / g_cpu.abs().max().item()
    kept = float(np.mean([m.float().mean().item() for m in masks.values()]))
    blocks = sum(isinstance(m, unet_module.ResnetBlocWithAttn)
                 for m in card.model.unet.modules())
    say(f"dropout {DROPOUT}: one dense f32 step at small-tpu-1 widths "
        f"({b * n} rows) on the card vs the CPU with the card's {len(masks)}"
        f" masks (kept {kept:.4f}): loss {loss_card:.7f} vs {loss_cpu:.7f} "
        f"(rel {rel_loss:.3g}), gradients {g_err:.3g} of the largest")
    if not (len(masks) == blocks and rel_loss <= 1e-4 and g_err <= 1e-4
            and abs(kept - (1 - DROPOUT)) < 0.01):
        raise AssertionError(f"dropout step disagrees: {len(masks)} masks "
                             f"of {blocks}, loss rel {rel_loss}, gradients "
                             f"{g_err}, kept {kept}")
    del card, cpu
    torch.cuda.empty_cache()
    return launches


def check_mp_steps(recs: list, ref: dict, how: str) -> None:
    """Phase 24 (a), (b): each case of MP_CASES on the ranks against the
    one process (``ref``), with the bounds of the module docstring; prints
    a line per case, ``how`` saying what the step times measure."""
    for name, tpu in MP_CASES:
        case = [r["cases"][name] for r in recs]
        c0 = case[0]
        lr_sum = np.cumsum(c0["lr"])
        rel = [abs(a - b) / abs(b) for a, b in zip(c0["loss"],
                                                   ref["losses"])]
        equal = len({c["checksum"] for c in case}) == 1
        say(f"phase 24 ({name}, {tpu or 'replicated Adam'}, mesh "
            f"{c0['mesh'][0]}x{c0['mesh'][1]}, {recs[0]['backend']} on "
            f"{len({r['device'] for r in recs})} card(s)): losses "
            + " ".join(f"{v:.6f}" for v in c0["loss"])
            + f" (rel to one process {max(rel):.3g}), first gradients "
            f"rel L2 {c0['grad_rel']:.3g}, updates rel L2 "
            + " ".join(f"{u:.3g}" for u in c0["update_rel"])
            + ", parameters max diff "
            + " ".join(f"{m:.3g}" for m in c0["param_max"])
            + f"; ranks equal: {equal}; per rank peak "
            + " ".join(f"{c['peak_gib']:.2f}" for c in case)
            + " GiB, Adam m and v "
            + " ".join(f"{c['adam_bytes'] / 2 ** 20:.1f}" for c in case)
            + " MiB; ms per step (rank 0) "
            + " ".join(f"{t:.0f}" for t in c0["ms"]) + f" ({how})")
        if not (equal and max(rel) <= 1e-2 and c0["grad_rel"] <= 5e-2
                and all(m <= 2 * s + 1e-6 for m, s in
                        zip(c0["param_max"], lr_sum))
                and all(u <= 0.5 for u in c0["update_rel"])):
            raise AssertionError(f"phase 24 ({name}) disagrees with one "
                                 f"process: {c0}")


def mp_steps_nccl(ref_dir: str, ref: dict, cwd: str, k1_sites: int,
                  k3_sites: int):
    """Phase 24 (a), (b) with NCCL and one rank per card (on 4 cards, or
    2), against the same one process.  Returns the launches and the
    ranks' records."""
    nproc = 4 if torch.cuda.device_count() >= 4 else 2
    recs = torchrun(nproc, ["steps", ref_dir], cwd)
    placed = [(r["backend"], r["device"]) for r in recs]
    if {b for b, _ in placed} != {"nccl"} or len(set(placed)) != nproc:
        raise AssertionError(f"phase 24 NCCL: ranks on {placed}")
    check_mp_steps(recs, ref, f"NCCL, one rank per card on {nproc} cards")
    return _check_launches(recs, k1_sites, k3_sites, "phase 24 NCCL"), recs


def run_mp_phases(device, k1_sites: int, k3_sites: int, loop_ms: float,
                  groups: int) -> dict:
    """Phases 23-24 and the dropout step.  Returns the launches by path and
    K1-K3's largest errors at the ranks' row counts."""
    launches = {"dropout": check_dropout_against_cpu(device, k1_sites,
                                                     k3_sites)}
    tmp = tempfile.TemporaryDirectory(prefix="vf-phase23-")
    try:
        data = os.path.join(tmp.name, "data")
        for mode, seed in (("train", 1), ("test", 2)):
            make_synthetic_shards(data, mode, num_objects=EXP_OBJECTS,
                                  num_shards=4, image_size=64, seed=seed,
                                  family="shaded")
        rows = Counter()

        def note_rows(recs):
            for r in recs:
                for n_rows, grad, _ in r["rows"]:
                    rows[n_rows] |= grad

        # 23. one rank under torchrun: NCCL, DDP, ZeRO-1, the fused feed
        cfg23 = experiment_config(
            data, phase=23, model__max_it=MP_CLI_MAX_IT,
            model__checkpoint_every=5, model__validate_from=100,
            tpu__profile_steps=0, tpu__shard_opt_state=True,
            tpu__fused_feed=True)
        recs = torchrun(1, ["cli", "-c", cfg23, "-t"], tmp.name)
        r = recs[0]
        if not (r["backend"] == "nccl" and r["zero1"] and r["fused_feed"]
                and r["steps"] == MP_CLI_MAX_IT + 1
                and r["msgpack"]["it"] == MP_CLI_MAX_IT
                and r["msgpack"]["best"]):
            raise AssertionError(f"phase 23: {r}")
        launches["mp_cli_1rank"] = _check_launches(recs, k1_sites, k3_sites,
                                                   "phase 23")
        note_rows(recs)
        say(f"phase 23 on {card_line()}: one NCCL rank, DDP, ZeRO-1 at data "
            f"1, fused feed: loop median {r['loop_ms']:.1f} ms per step "
            f"(steps 2-{r['steps']}) against phase 16's {loop_ms:.1f} ms; "
            f"eval {r['eval_seconds'][0]:.2f} s; model.msgpack at it "
            f"{r['msgpack']['it']} with {r['msgpack']['tensors']} tensors "
            f"and the whole Adam tree; peak {r['peak_gib']:.2f} GiB")

        # 24 (a), (b): Trainer steps on four ranks sharing the card
        ref_dir = os.path.join(tmp.name, "ref")
        os.makedirs(ref_dir)
        ref = mp_reference(ref_dir, device)
        recs = torchrun(MP_RANKS, ["steps", ref_dir], tmp.name)
        launches["mp_steps_4ranks"] = _check_launches(
            recs, k1_sites, k3_sites, "phase 24 (a, b)")
        note_rows(recs)
        check_mp_steps(recs, ref, "four ranks time-share one card and gloo "
                       "stages through the host: no measure of multi-GPU "
                       "speed")
        if torch.cuda.device_count() >= 2:
            launches["mp_steps_nccl"], recs = mp_steps_nccl(
                ref_dir, ref, tmp.name, k1_sites, k3_sites)
            note_rows(recs)
        else:
            say("phase 24 (a) with NCCL and one rank per card: not run, "
                f"{torch.cuda.device_count()} card")

        # 24 (c): the Experiment on four ranks
        cfg24 = experiment_config(
            data, source=MP_CONFIG, phase=24, model__max_it=MP_EXP_MAX_IT,
            model__checkpoint_every=2, model__validate_from=100,
            tpu__profile_steps=0, tpu__shard_opt_state=True)
        recs = torchrun(MP_RANKS, ["cli", "-c", cfg24, "-t"], tmp.name)
        r = recs[0]
        if not (len({x["run"] for x in recs}) == 1
                and all(x["mesh"] == [MP_RANKS, 1] and x["zero1"]
                        for x in recs)
                and r["msgpack"]["it"] == MP_EXP_MAX_IT
                and r["steps"] == MP_EXP_MAX_IT + 1):
            raise AssertionError(f"phase 24 (c): {recs}")
        launches["mp_experiment_4ranks"] = _check_launches(
            recs, k1_sites, k3_sites, "phase 24 (c)")
        note_rows(recs)
        say(f"phase 24 (c): the Experiment on {MP_RANKS} ranks "
            f"({r['backend']}, one card): {r['steps']} steps, loop median "
            f"{r['loop_ms']:.0f} ms per step (time-shared card), eval "
            f"{r['eval_seconds'][0]:.2f} s, model.msgpack at it "
            f"{r['msgpack']['it']} with the whole Adam tree, best files "
            f"{r['msgpack']['best']}; per rank peak "
            + " ".join(f"{x['peak_gib']:.2f}" for x in recs)
            + " GiB, Adam m and v "
            + " ".join(f"{x['moment_bytes'] / 2 ** 20:.1f}" for x in recs)
            + " MiB")
        errs = check_rank_rows(rows, groups, device)
        return {"launches": launches, "errs": errs}
    finally:
        tmp.cleanup()


# ----------------------------------------------------------------------
# phase 25: the published-weights path
# ----------------------------------------------------------------------
PRETRAINED_IT = 1_234_000
PRETRAINED_OBJECTS = 32   # test split: 4 shards of 8 at 64 px
PRETRAINED_EVAL_BATCHES = 2
PRETRAINED_REQUESTS = 3 * BATCH   # three full batches, as phase 18 serves


def reference_payload(state_dict: dict, cfg: Config) -> dict:
    """A checkpoint in the layout of the reference's ``best_model_all.pt``
    (utils/checkpoint.py: the model's and the optimizer's state_dicts and
    the scalars) holding ``state_dict`` as its UNet: the ViewFusion's
    schedule buffers beside ``denoise_fn.*``, torch Adam moments of the
    parameters' shapes, an int ``it``, a numpy-float ``ssim`` and a 0-d
    tensor ``psnr``."""
    model = {f"denoise_fn.{k}": v for k, v in state_dict.items()}
    sched = DiffusionSchedule.create(cfg.diffusion.phases["train"])
    for name in SCHEDULE_BUFFERS:
        model[name] = torch.from_numpy(getattr(sched, name))
    g = torch.Generator().manual_seed(SEED + 25)
    params = list(state_dict.values())
    state = {i: {"step": torch.tensor(float(PRETRAINED_IT)),
                 "exp_avg": 1e-4 * torch.randn(p.shape, generator=g),
                 "exp_avg_sq": 1e-8 * torch.rand(p.shape, generator=g)}
             for i, p in enumerate(params)}
    groups = [{"lr": 5e-5, "betas": (0.9, 0.999), "eps": 1e-8,
               "weight_decay": 0, "amsgrad": False,
               "params": list(range(len(params)))}]
    return {"model": model, "optimizer": {"state": state,
                                          "param_groups": groups},
            "it": PRETRAINED_IT, "t": 987654.25, "run_id": "3xk9q2ab",
            "ssim": np.float64(0.8271), "psnr": torch.tensor(23.19)}


def run_pretrained(state_dict: dict, device, k1_sites: int,
                   k3_sites: int, groups: int) -> dict:
    """Phase 25: a reference-layout best_model_all.pt of the paper UNet's
    weights, converted by ``python -m viewfusion_tpu_torch.utils.
    torch_convert`` into a run dir, served (bit for bit as a service on
    the unconverted weights, then three full batches timed) and evaluated
    by ``cli -s <run dir> -e``.  Returns the K1 and K3 launches of the
    converted run dir's service and eval, and the kernels' largest errors
    against their plain versions at the row counts those UNet forwards
    ran at."""
    tmp = tempfile.TemporaryDirectory(prefix="vf-phase25-")
    try:
        data = os.path.join(tmp.name, "data")
        make_synthetic_shards(data, "test", num_objects=PRETRAINED_OBJECTS,
                              num_shards=4, image_size=64, seed=25,
                              family="shaded")
        batch = load_config(MP_CONFIG).data.batch_size
        cfg_path = experiment_config(
            data, source=MP_CONFIG, phase=25, tpu__ema_decay=0.0,
            data__params__test__params__size=PRETRAINED_EVAL_BATCHES * batch)
        cfg = load_config(cfg_path)
        pt = os.path.join(tmp.name, "best_model_all.pt")
        t0 = time.perf_counter()
        torch.save(reference_payload(state_dict, cfg), pt)
        save_s = time.perf_counter() - t0
        run = os.path.join(tmp.name, "pretrained")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "viewfusion_tpu_torch.utils.torch_convert",
             pt, run, cfg_path], cwd=str(Path(__file__).resolve().parent),
            capture_output=True, text=True, timeout=600)
        convert_s = time.perf_counter() - t0
        msgpack = os.path.join(run, "best_model_all.msgpack")
        if (proc.returncode != 0
                or proc.stdout.strip() != f"wrote {run}/best_model_all.msgpack"):
            raise AssertionError(f"torch_convert exited {proc.returncode}: "
                                 f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
        say(f"phase 25 on {card_line()}: reference-layout .pt "
            f"{os.path.getsize(pt) / 1e6:.1f} MB (written in {save_s:.1f} s), "
            f"converted in {convert_s:.1f} s (a fresh interpreter) to "
            f"best_model_all.msgpack {os.path.getsize(msgpack) / 1e6:.1f} MB")

        restored, _ = Checkpoint(run).load("best_model_all.msgpack",
                                           {"params": None})
        converted = unet_state_dict_from_jax(restored["params"])
        for k, v in state_dict.items():
            if not torch.equal(converted[k], v.cpu()):
                raise AssertionError(f"{k}: the run dir holds other weights "
                                     "than the .pt")

        rng = np.random.default_rng(SEED + 25)
        hw, n_max = cfg.unet.image_size, cfg.data.max_views
        conds = [rng.uniform(0, 1, (1 + i % n_max, hw, hw, 3)).astype(
            np.float32) for i in range(PRETRAINED_REQUESTS)]
        angles = [0.4 * i for i in range(PRETRAINED_REQUESTS)]
        opts = dict(batch_size=BATCH, max_wait_ms=0.0,
                    default_steps=DDIM_STEPS, device=device)
        # one request a batch, one after another: the same requests and
        # seeds in both services (each seeds its n-th batch alike)
        reference = ViewFusionService.from_state_dict(cfg, state_dict, **opts)
        want = [reference.submit(conds[i], angles[i]) for i in range(2)]
        del reference
        torch.cuda.empty_cache()

        group_norm_act.launches = spatial_self_attention.launches = 0
        mark = tracing.mark()
        with unet_rows() as rows:
            service = ViewFusionService(run, **opts)
            for i, w in enumerate(want):
                if not np.array_equal(service.submit(conds[i], angles[i]), w):
                    raise AssertionError(
                        f"request {i}: the converted run dir serves another "
                        "image than the unconverted weights")
            # then full batches: every request queued before a batch is cut
            service.max_wait_ms = 60_000.0
            t0 = time.perf_counter()
            with ThreadPoolExecutor(PRETRAINED_REQUESTS) as pool:
                got = list(pool.map(service.submit, conds, angles))
            wall = time.perf_counter() - t0
            batches = list(service.batch_log)[2:]
            if not all(img.shape == (hw, hw, 3) and np.isfinite(img).all()
                       for img in got):
                raise AssertionError("bad served image")
            say(f"served the converted run dir: the images of 2 requests "
                f"equal bit for bit to the service's on the unconverted "
                f"weights; {PRETRAINED_REQUESTS} requests (DDIM "
                f"{DDIM_STEPS}) in {wall:.2f} s = "
                f"{PRETRAINED_REQUESTS / wall:.2f} views/s, batches "
                + " ".join(f"{n}:{n / sec:.2f}" for _, _, n, sec in batches)
                + " views/s")
            del service
            torch.cuda.empty_cache()

            t0 = time.perf_counter()
            eval_mark = tracing.mark()
            exp = cli.main(["-s", run, "-e", "--device", str(device)])
            eval_s = time.perf_counter() - t0
            forwards = forwards_since(mark)
            torch.cuda.synchronize()
        last = json.loads(open(os.path.join(run, "metrics.jsonl"))
                          .readlines()[-1])
        if (last.get("it") != float(PRETRAINED_IT)
                or not all(np.isfinite(last.get(k, np.nan))
                           for k in ("ssim", "psnr"))):
            raise AssertionError(f"-e logged {last}")
        say(f"-e on the converted run dir: ssim {last['ssim']:.4f} psnr "
            f"{last['psnr']:.2f} at it {last['it']} ({exp.last_eval_count:.0f}"
            f" samples, DDIM {cfg.train.ddim_steps}) in "
            f"{tracing.spans('eval.pass', after=eval_mark)[0].seconds:.2f} "
            f"s, {eval_s:.1f} s with the set-up")
        del exp
        torch.cuda.empty_cache()

        launches = {"k1": group_norm_act.launches,
                    "k3": spatial_self_attention.launches}
        if (forwards == 0 or sum(rows.values()) != forwards
                or launches != {"k1": k1_sites * forwards,
                                "k3": k3_sites * forwards}):
            raise AssertionError(
                f"pretrained launch counters {launches} != per-forward "
                f"sites ({k1_sites}, {k3_sites}) x {forwards} forwards")
        say(f"launches on the pretrained path: K1 {launches['k1']}, K3 "
            f"{launches['k3']} over {forwards} UNet forwards at "
            + ", ".join(f"{n} x {r} rows" for (r, _), n in
                        sorted(rows.items())))
        errs = check_rank_rows({r: g for r, g in rows}, groups, device,
                               whose="the pretrained path's")
        return {"launches": launches, "errs": errs}
    finally:
        tmp.cleanup()


# ----------------------------------------------------------------------
# phase 26: the input formats (YAML 1.1, every view format) on the served
# path
# ----------------------------------------------------------------------
FORMATS_DIR = Path(__file__).resolve().parent / "tests" / "torch_port_formats"
FORMAT_STEPS = 20


def run_formats(state_dict: dict, device, k1_sites: int,
                k3_sites: int) -> dict:
    """Phase 26 (see the module docstring).  Returns the K1 and K3
    launches of the service and each format's host decode ms per view."""
    t_phase = time.perf_counter()
    cfg = load_config(str(FORMATS_DIR / "small-tpu-4-yaml11.yaml"))
    if cfg != load_config(MP_CONFIG):
        raise AssertionError("the YAML 1.1 fixture does not load to "
                             "configs/small-tpu-4.yaml's Config")
    # expected.npz holds PIL's decode of each view file, keyed
    # <format>_<view> as the file is named
    expected = np.load(FORMATS_DIR / "expected.npz")
    files: dict = {}
    for key in sorted(expected.files):
        data = next(FORMATS_DIR.glob(key + ".*")).read_bytes()
        if not np.array_equal(decode_image(data), expected[key]):
            raise AssertionError(f"{key} decodes to another image than "
                                 "Pillow's")
        files.setdefault(key.rsplit("_", 1)[0], []).append(data)
    decode_ms = {}  # host work: the host's clock, ten passes
    for name, blobs in files.items():
        t0 = time.perf_counter()
        for _ in range(10):
            for data in blobs:
                decode_image(data)
        decode_ms[name] = (time.perf_counter() - t0) * 1e3 / (10 * len(blobs))
    say(f"phase 26 on {card_line()}: host decode ms per 64 x 64 view: "
        + ", ".join(f"{k} {v:.3f}" for k, v in decode_ms.items()))

    tmp = tempfile.TemporaryDirectory(prefix="vf-phase26-")
    servers = []
    try:
        run = os.path.join(tmp.name, "run")
        write_run_dir(run, cfg, state_dict)
        text = Path(run, "config.yaml").read_text()
        if parse_yaml(text) != cfg.raw or cfg.raw["description"] in text:
            raise AssertionError("the run dir's config.yaml does not read "
                                 "back to the fixture's tree, folded")
        svc = ViewFusionService(run, batch_size=BATCH, max_wait_ms=0.0,
                                default_steps=FORMAT_STEPS, device=device)
        httpd = make_server(svc, host="127.0.0.1", port=0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        servers.append(httpd)
        port = httpd.server_address[1]
        torch.cuda.synchronize()
        group_norm_act.launches = spatial_self_attention.launches = 0
        mark = tracing.mark()
        t0 = time.perf_counter()
        for i, (name, blobs) in enumerate(files.items()):
            body = {"angle": 0.5 * i, "steps": FORMAT_STEPS,
                    "views": [base64.b64encode(b).decode() for b in blobs]}
            code, out = _post(port, body)
            if code != 200:
                raise AssertionError(f"{name}: HTTP {code} {out}")
            image = decode_png(base64.b64decode(out["image"]))
            if image.shape != (64, 64, 3):
                raise AssertionError(f"{name}: a served image of "
                                     f"{image.shape}")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        forwards = forwards_since(mark)
        launches = {"k1": group_norm_act.launches,
                    "k3": spatial_self_attention.launches}
        if forwards == 0 or launches != {"k1": k1_sites * forwards,
                                         "k3": k3_sites * forwards}:
            raise AssertionError(
                f"formats launch counters {launches} != per-forward sites "
                f"({k1_sites}, {k3_sites}) x {forwards} forwards")
        refused = tracing.counters().get("serve.refused", 0)
        code, out = _post(port, {"angle": 0.0, "views": [
            base64.b64encode(b"not an image").decode()]})
        if code != 400 or "unrecognised" not in out.get("error", ""):
            raise AssertionError(f"an unrecognised view got HTTP {code} "
                                 f"{out}")
        if tracing.counters().get("serve.refused", 0) != refused + 1:
            raise AssertionError("the 400 was not counted as refused")
        say(f"served {len(files)} requests (one per format, {len(blobs)} "
            f"views each, DDIM {FORMAT_STEPS}) in {wall:.2f} s, each a "
            f"64 x 64 image; an unrecognised view: HTTP 400 "
            f"{out['error']!r}; launches K1 {launches['k1']}, K3 "
            f"{launches['k3']} over {forwards} UNet forwards")
        del svc
        torch.cuda.empty_cache()

        gen, tgt, ref = (os.path.join(tmp.name, d) for d in
                         ("gen", "tgt", "ref"))
        for d in (gen, tgt, ref):
            os.makedirs(d)
        sources = render_views_shaded(11, image_size=64)[[0, 8, 16]]
        i = 0
        for name in ("jpeg_baseline", "jpeg_progressive"):
            for v in range(len(files[name])):
                Path(gen, f"{i:04d}.jpg").write_bytes(files[name][v])
                Path(ref, f"{i:04d}.png").write_bytes(
                    encode_png(expected[f"{name}_{v}"]))
                Path(tgt, f"{i:04d}.png").write_bytes(encode_png(sources[v]))
                i += 1
        none = os.path.join(tmp.name, "no-lpips.npz")
        got, want = (compute_metrics.compute_folder_metrics(
            d, tgt, batch_size=4, lpips_weights=none, device=device)
            for d in (gen, ref))
        say(f"compute_metrics over {got['count']} JPEG views on the card: "
            f"psnr {got['psnr']:.4f} ssim {got['ssim']:.4f}, equal to it "
            "over their expected arrays as PNGs")
        if got != want or got["count"] != i:
            raise AssertionError(f"compute_metrics over the JPEGs {got} != "
                                 f"over their expected arrays {want}")
        say(f"phase 26 in {time.perf_counter() - t_phase:.1f} s")
        return {"launches": launches, "decode_ms": decode_ms}
    finally:
        for httpd in servers:
            httpd.shutdown()
            httpd.server_close()
        tmp.cleanup()


# ---------------------------------------------------------------------
# phase 27: the served UNet forward replayed as a CUDA graph

GRAPH_REQUESTS = 2 * BATCH        # two full batches


def run_graphed_serving(state_dict: dict, device, k1_sites: int,
                        k3_sites: int) -> dict:
    """Phase 27: a ViewFusionService at the paper config on phase 5's
    weights.  Its warm-up (DDIM 50 at the served 8 x 6 rows) captures the
    UNet forward exactly once (the first forward eager, the second the
    capture); then two full batches, every forward of which is a replay,
    with exactly 69 K1 and 8 K3 launches per forward.  Returns the
    phase's launches, which the kernels line keeps apart from the other
    paths'."""
    cfg = Config.from_dict(PAPER_CONFIG)
    service = ViewFusionService.from_state_dict(
        cfg, state_dict, batch_size=BATCH, max_views=MAX_VIEWS,
        default_steps=DDIM_STEPS, device=device)
    before = tracing.counters()
    t0 = time.perf_counter()
    service.warmup([DDIM_STEPS])
    warm_s = time.perf_counter() - t0
    warm = tracing.counters()
    captures = (warm.get("unet.graph_captures", 0)
                - before.get("unet.graph_captures", 0))
    warm_replays = (warm.get("unet.graph_replays", 0)
                    - before.get("unet.graph_replays", 0))
    if (captures, warm_replays) != (1, DDIM_STEPS - 2):
        raise AssertionError(f"warm-up: {captures} captures and "
                             f"{warm_replays} replays, not 1 and "
                             f"{DDIM_STEPS - 2}")
    rng = np.random.default_rng(SEED + 27)
    hw = service.image_size
    conds = [rng.uniform(0, 1, (1 + i % MAX_VIEWS, hw, hw, 3)).astype(
        np.float32) for i in range(GRAPH_REQUESTS)]
    angles = [0.3 * i for i in range(GRAPH_REQUESTS)]
    service.batch_log.clear()
    service.max_wait_ms = 60_000.0  # each batch cut when it is full
    group_norm_act.launches = spatial_self_attention.launches = 0
    mark = tracing.mark()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(GRAPH_REQUESTS) as pool:
        got = list(pool.map(service.submit, conds, angles))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = tracing.counters()
    forwards = tracing.spans("unet.forward", after=mark)
    launches = {"k1": group_norm_act.launches,
                "k3": spatial_self_attention.launches}
    n = len(forwards)
    if not all(img.shape == (hw, hw, 3) and np.isfinite(img).all()
               for img in got):
        raise AssertionError("bad served image")
    if (n != 2 * DDIM_STEPS
            or not all(sp.attrs.get("graphed") for sp in forwards)
            or after["unet.graph_captures"] != warm["unet.graph_captures"]
            or after["unet.graph_replays"] - warm["unet.graph_replays"] != n
            or launches != {"k1": k1_sites * n, "k3": k3_sites * n}):
        raise AssertionError(
            f"graphed serving: {n} forwards, graphed "
            f"{[sp.attrs.get('graphed') for sp in forwards]}, counters "
            f"{after}, launches {launches} != sites ({k1_sites}, "
            f"{k3_sites}) x {n}")
    batches = [sec for _, _, _, sec in service.batch_log]
    say(f"phase 27 on {card_line()}: warm-up DDIM {DDIM_STEPS} in "
        f"{warm_s:.2f} s with 1 capture and {warm_replays} replays; "
        f"{GRAPH_REQUESTS} requests in {len(batches)} full batches in "
        f"{wall:.2f} s, every one of the {n} forwards a replay; batches "
        + " ".join(f"{sec * 1e3:.0f}" for sec in batches)
        + f" ms; spans {span_summary(mark)}")
    say(f"launches on the graphed serving path (counted apart): K1 "
        f"{launches['k1']}, K3 {launches['k3']} over {n} replayed forwards")
    del service
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------
# phase 28: the ADM denoiser (viewfusion_tpu_torch/configs/adm-imagenet-64.yaml)

ADM_CONFIG = "viewfusion_tpu_torch/configs/adm-imagenet-64.yaml"
ADM_BATCH = 32      # one card's 32 of ADM's global 2048 over 64 cards
ADM_ROWS = 112      # sum of stratified_count_multiset(32, 6)


def adm_config() -> Config:
    """The ADM ImageNet-64 YAML through the port's reader at its published
    widths, at one card's batch of 32 (R = 112 packed rows)."""
    raw = parse_yaml(Path(ADM_CONFIG).read_text())
    raw["data"]["params"]["batch_size"] = ADM_BATCH
    return Config.from_dict(raw)


def adm_sites(cfg: Config, device, rows: int = ADM_ROWS):
    """(L, C, act, per_sample, dtype) GroupNorm sites and (S, head width,
    heads) attention sites of one ADM forward at ``rows`` rows, with their
    counts, read by hooks on the model (per_sample: an AdaGN, whose affine
    is (B, C))."""
    torch.manual_seed(SEED)
    model = ADM(cfg.denoiser, dtype=torch.bfloat16).to(device).eval()
    gn, attn = Counter(), Counter()

    def on_norm(m, a):
        x = a[0]
        gn.update([(x.shape[2] * x.shape[3], x.shape[1], m.act,
                    isinstance(m, AdaGroupNorm), x.dtype)])

    def on_attn(m, a):
        _, s, c = a[0].shape
        attn.update([(s, c // m.num_heads, m.num_heads)])

    hooks = [m.register_forward_pre_hook(on_norm) for m in model.modules()
             if isinstance(m, GroupNormAct)]
    hooks += [m.register_forward_pre_hook(on_attn) for m in model.modules()
              if isinstance(m, MHAttention)]
    with torch.inference_mode():
        model(*unet_inputs(rows, cfg.denoiser, device))
    for h in hooks:
        h.remove()
    del model
    torch.cuda.empty_cache()
    return gn, attn


def _affine(kind: str, rows: int, c: int, g) -> tuple:
    """A seeded (C,) or (B, C) f32 scale and bias: an AdaGN's folded
    ``gamma (1 + s)``, ``beta (1 + s) + t`` for (B, C)."""
    shape = (rows, c) if kind == "(B, C)" else (c,)
    device = g.device
    scale = torch.randn(shape, generator=g, device=device) * 0.3 + 1.0
    bias = torch.randn(shape, generator=g, device=device) * 0.3
    return scale, bias


def check_adm_group_norm(gn_sites, groups: int, device,
                         rows: int = ADM_ROWS) -> dict:
    """K1 and K2 at every distinct GroupNorm shape of one ADM forward at
    ``rows`` rows, each with a (B, C) affine and with a (C,) one, against
    the plain versions (within one bf16 ulp of the output's scale, as
    phases 3 and 8; f32 within 1e-5 of it), two calls equal bit for bit,
    timed with the plain versions and the byte bound, with each plan.  The
    per-forward (K1) and per-step (K2) totals weight each shape by its
    count with the affine the model gives it there; ``affine`` totals
    count the AdaGN sites alone."""
    g = torch.Generator(device=device).manual_seed(SEED + 28)
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_bytes_ms",
            "max_abs_err")
    tot = {k: dict.fromkeys(keys, 0.0)
           for k in ("k1", "k2", "k1_affine", "k2_affine")}
    shapes = Counter()
    for (l, c, act, per_sample, dtype), n in gn_sites.items():
        shapes[(l, c, act, dtype, per_sample)] += n
    for l, c, act, dtype in sorted({k[:4] for k in shapes},
                                   key=lambda k: k[:3] + (str(k[3]),)):
        x = (torch.randn((rows, l, c), generator=g, device=device) * 1.5
             + 0.5).to(dtype)
        gy = torch.randn((rows, l, c), generator=g, device=device).to(dtype)
        kw = dict(groups=groups, act=act)
        for kind in ("(B, C)", "(C,)"):
            count = shapes[(l, c, act, dtype, kind == "(B, C)")]
            scale, bias = _affine(kind, rows, c, g)
            name = f"L={l} C={c} act={act} {str(dtype)[6:]} {kind} x{count}"
            y, mean, rstd = group_norm_act(x, scale, bias, return_stats=True,
                                           **kw)
            again = group_norm_act(x, scale, bias, return_stats=True, **kw)
            y_r, mean_r, rstd_r = group_norm_act_reference(x, scale, bias,
                                                           **kw)
            args = (x, gy, scale, bias, mean, rstd)
            out = group_norm_act_backward(*args, **kw)
            out2 = group_norm_act_backward(*args, **kw)
            ref = group_norm_act_backward_reference(*args, **kw)
            torch.cuda.synchronize()
            if not (all(torch.equal(a, b) for a, b in
                        zip((y, mean, rstd), again))
                    and all(torch.equal(a, b) for a, b in zip(out, out2))):
                raise AssertionError(f"ADM K1/K2 {name}: two calls differ")
            errs = []
            for got, want in ((y, y_r), (out[0], ref[0])):
                top = want.float().abs().max().item()
                tol = (bf16_ulp(top) if dtype == torch.bfloat16
                       else 1e-5 * top)
                errs.append(((got.float() - want.float()).abs().max()
                             .item(), tol))
            torch.testing.assert_close(mean, mean_r, rtol=1e-4, atol=1e-5)
            torch.testing.assert_close(rstd, rstd_r, rtol=1e-4, atol=1e-5)
            perr = max((a - b).abs().max().item() / b.abs().max().item()
                       for a, b in zip(out[1:], ref[1:]))
            if not (all(e <= t for e, t in errs) and perr <= 1e-4):
                raise AssertionError(f"ADM K1/K2 {name}: y, dx (err, tol) "
                                     f"{errs}, partials rel err {perr}")
            ms1 = device_ms(lambda: group_norm_act(x, scale, bias, **kw))
            plain1 = device_ms(lambda: group_norm_act_reference(
                x, scale, bias, **kw))
            ms2 = device_ms(lambda: group_norm_act_backward(*args, **kw))
            plain2 = device_ms(
                lambda: group_norm_act_backward_reference(*args, **kw))
            aff = 2 * scale.numel() * 4
            stats = 2 * rows * groups * 4
            b1 = 2 * x.numel() * x.element_size() + aff + stats
            b2 = 3 * x.numel() * x.element_size() + aff + stats \
                + 2 * rows * c * 4
            bound1, by1 = bound_ms(b1, 10 * x.numel(), torch.float32)
            bound2, by2 = bound_ms(b2, 16 * x.numel(), torch.float32)
            say(f"ADM {name}: K1 err {errs[0][0]:.3g} (tol "
                f"{errs[0][1]:.3g}) {ms1 * 1e3:.1f} us, plain "
                f"{plain1 * 1e3:.1f} us, bound {bound1 * 1e3:.1f} us ({by1})"
                f" = {bound1 / ms1:.0%}; {plan_note(x)} | K2 dx err "
                f"{errs[1][0]:.3g} (tol {errs[1][1]:.3g}) partials rel err "
                f"{perr:.3g} {ms2 * 1e3:.1f} us, plain {plain2 * 1e3:.1f} "
                f"us, bound {bound2 * 1e3:.1f} us ({by2}) = "
                f"{bound2 / ms2:.0%}; {plan_note(x, backward=True)}")
            for key, ms, plain, bms, nbytes, err in (
                    ("k1", ms1, plain1, bound1, b1, errs[0][0]),
                    ("k2", ms2, plain2, bound2, b2, errs[1][0])):
                add_site(tot[key], count, ms, plain, 0.0, bms, nbytes, err)
                if kind == "(B, C)":
                    add_site(tot[key + "_affine"], count, ms, plain, 0.0,
                             bms, nbytes, err)
                # the shapes the model does not run count too
                tot[key]["max_abs_err"] = max(tot[key]["max_abs_err"], err)
        del x, gy
        torch.cuda.empty_cache()
    return tot


def attention_backward_ms(prof) -> Counter:
    """Device ms by kernel family of the kernels the attention backward
    (``_Attention.backward``, ``ops/attention.py``: K5 or the closed form)
    launched in a profiled step: those under its autograd node's
    events."""
    fam = Counter()

    def walk(e):
        for k in e.kernels:
            fam[kernel_family(k.name)] += k.duration / 1e3
        for ch in e.cpu_children:
            walk(ch)

    nodes = [e for e in prof.events() if "_AttentionBackward" in e.name]
    top = [e for e in nodes
           if not any(n is not e and n.time_range.start <= e.time_range.start
                      and e.time_range.end <= n.time_range.end
                      and n.thread == e.thread for n in nodes)]
    for e in top:
        walk(e)
    return fam


def run_adm_trainer(device, gn_sites, attn_sites) -> dict:
    """The ADM's training step, the main path of its benchmark cell: the
    Trainer at the ADM YAML (batch 32, R = 112) from seeded weights takes a
    warm-up step, then one step with the launch counters zeroed just
    before it, which must read one K1 and one K2 launch per GroupNorm site
    (those with a (B, C) affine: one per AdaGN) and one K3 per attention
    site; then a profiled step, its device time by kernel family and the
    closed-form attention backward's own.  Returns the step's launches."""
    from torch.profiler import ProfilerActivity, profile

    cfg = adm_config()
    trainer = Trainer(cfg, device=device, seed=SEED)
    rng = np.random.default_rng(SEED + 28)
    batches = [train_batch(cfg, it, rng) for it in range(3)]
    rows = int(batches[1]["view_count"].sum())
    if rows != ADM_ROWS:
        raise AssertionError(f"ADM batch of {ADM_BATCH}: {rows} rows, not "
                             f"{ADM_ROWS}")
    start = [p.detach().clone() for p in trainer.params]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = trainer.train_step(batches[0]).item()
    first_ms = (time.perf_counter() - t0) * 1e3
    for fn in (group_norm_act, group_norm_act_backward):
        fn.launches = fn.affine_launches = 0
    spatial_self_attention.launches = attention_backward.launches = 0
    _Attention.closed_form_calls = 0
    mark = tracing.mark()
    t0 = time.perf_counter()
    loss = trainer.train_step(batches[1]).item()
    step_ms = (time.perf_counter() - t0) * 1e3
    launches = {"k1": group_norm_act.launches,
                "k2": group_norm_act_backward.launches,
                "k3": spatial_self_attention.launches,
                "k5": attention_backward.launches,
                "closed_form": _Attention.closed_form_calls,
                "k1.affine": group_norm_act.affine_launches,
                "k2.affine": group_norm_act_backward.affine_launches}
    forwards = forwards_since(mark)
    n_gn = sum(gn_sites.values())
    n_ada = sum(n for k, n in gn_sites.items() if k[3])
    n_attn = sum(attn_sites.values())
    want = {"k1": n_gn, "k2": n_gn, "k3": n_attn, "k5": n_attn,
            "closed_form": 0, "k1.affine": n_ada, "k2.affine": n_ada}
    say(f"ADM train step spans: {span_summary(mark)}")
    if forwards != 1 or launches != want:
        raise AssertionError(f"ADM training launch counters {launches} != "
                             f"{want} ({forwards} forwards)")
    if not np.isfinite([first, loss]).all():
        raise AssertionError(f"non-finite ADM loss: {first}, {loss}")
    moved = sum(not torch.equal(a, b) for a, b in zip(trainer.params, start))
    if not moved:
        raise AssertionError("no ADM parameter changed in training")
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    say(f"Trainer ADM ImageNet-64, {rows} rows bf16: losses {first:.5f} "
        f"{loss:.5f}; ms per step: first {first_ms:.1f}, then "
        f"{step_ms:.1f}; peak memory {peak_gb:.2f} GiB; {moved}/"
        f"{len(start)} parameter tensors moved")
    say(f"launches in one ADM training step: K1 {launches['k1']} (with a "
        f"(B, C) affine {launches['k1.affine']}), K2 {launches['k2']} "
        f"({launches['k2.affine']}), K3 {launches['k3']}, K5 "
        f"{launches['k5']}, closed-form backward {launches['closed_form']}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.train_step(batches[2]).item()
    busy = report_profile(prof, f"one ADM training step at {rows} rows",
                          (time.perf_counter() - t0) * 1e3)
    attn = attention_backward_ms(prof)
    say(f"attention backward (K5) in that step: "
        f"{sum(attn.values()):.2f} ms of the {busy:.2f} device-ms ("
        + ", ".join(f"{k} {v:.2f} ms" for k, v in attn.most_common())
        + ")")
    del trainer
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": step_ms, "busy_ms": busy,
            "attention_backward_ms": sum(attn.values())}


def run_adm_phase(device) -> dict:
    """Phase 28: the ADM's GroupNorm and attention sites at R = 112, K1
    and K2 at each (``check_adm_group_norm``), K3 at each attention site
    against its plain version, timed, and one counted training step
    (``run_adm_trainer``)."""
    t_phase = time.perf_counter()
    cfg = adm_config()
    gn_sites, attn_sites = adm_sites(cfg, device)
    say(f"ADM sites per forward at {ADM_ROWS} rows: "
        f"{sum(gn_sites.values())} GroupNorm "
        f"({sum(n for k, n in gn_sites.items() if k[3])} AdaGN with a "
        f"(B, C) affine; {len(gn_sites)} distinct), "
        f"{sum(attn_sites.values())} attention {dict(attn_sites)}")
    gn = check_adm_group_norm(gn_sites, 32, device)
    for key, per in (("k1", "forward"), ("k2", "step (backward)")):
        for part in (key, key + "_affine"):
            t = gn[part]
            say(f"ADM {part.upper()} per {per} at {ADM_ROWS} rows: "
                f"{t['ms']:.3f} ms, plain {t['plain_ms']:.3f} ms, bound "
                f"{t['bound_ms']:.3f} ms = {t['bound_ms'] / t['ms']:.1%}; "
                f"largest err {t['max_abs_err']:.3g}")
    # K3 at the ADM's (B * heads, S, head width), q, k and v the planes of
    # one (3, B * heads, S, hd) copy as MHAttention hands them over
    k3 = dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms",
                        "bound_bytes_ms", "max_abs_err"), 0.0)
    for (s, hd, heads), n in sorted(attn_sites.items()):
        say(f"ADM K3 site: S={s}, {heads} heads of {hd}, x{n}")
        site = check_attention(Counter({(s, hd): n}), device,
                               rows=ADM_ROWS * heads, heads=True)
        for k, v in site.items():
            k3[k] = max(k3[k], v) if k == "max_abs_err" else k3[k] + v
        torch.cuda.empty_cache()
    say(f"ADM K3 per forward at {ADM_ROWS} rows: {k3['ms']:.3f} ms, plain "
        f"{k3['plain_ms']:.3f} ms, SDPA {k3['library_ms']:.3f} ms, bound "
        f"{k3['bound_ms']:.3f} ms = {k3['bound_ms'] / k3['ms']:.1%}")
    step = run_adm_trainer(device, gn_sites, attn_sites)
    say(f"phase 28 in {time.perf_counter() - t_phase:.1f} s")
    return {"gn": gn, "k3": k3, **step}


def adm_kernels(adm: dict) -> dict:
    """Phase 28's numbers as the kernels line keeps them: K1 per ADM
    forward, K2 per ADM step and K3 per ADM forward at 112 rows (all sites
    and, for K1/K2, the AdaGN sites alone), and the step's launches."""
    pick = ("ms", "plain_ms", "bound_ms", "max_abs_err")
    out = {"per": f"one ADM forward (K1, K3) or training step (K2) at "
                  f"{ADM_ROWS} rows",
           "launches_one_step": adm["launches"],
           "attention_backward_ms": adm["attention_backward_ms"],
           "step_device_ms": adm["busy_ms"]}
    for part in ("k1", "k1_affine", "k2", "k2_affine"):
        out[part] = {k: adm["gn"][part][k] for k in pick}
    out["k3"] = {k: adm["k3"][k] for k in pick + ("library_ms",)}
    return out


# phase 29: K5, the fused attention backward for heads of 64

def check_attention_backward(sites, device, what: str) -> dict:
    """K5 at each (B x heads, S) site of ``sites`` (a Counter, calls per
    step): q, k, v the planes of one (3, B x heads, S, 64) bf16 copy, as
    MHAttention hands them over, and an upstream gradient of bf16 values
    (the models' cast) and a general f32 one.  Against the closed form and
    an f64 closed form on 32 rows (error no larger than twice the closed
    form's plus one bf16 ulp), two calls equal bit for bit; timed (device
    time in a CUDA graph) with its bound (bytes: q, k, v, dq, dk, dv in
    bf16 and g in f32; FLOPs: the four products, 8 x S^2 x 64 a row), the
    closed form (eager call) and the autograd backward of
    F.scaled_dot_product_attention on bf16 (eager call; timed only).
    Returns the per-step totals."""
    gen = torch.Generator(device=device).manual_seed(SEED + 29)
    tot = dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms",
                         "bound_bytes_ms", "max_abs_err"), 0.0)
    for (b, s), n in sorted(sites.items()):
        q, k, v = torch.randn((3, b, s, 64), generator=gen,
                              device=device).bfloat16()
        g = torch.randn((b, s, 64), generator=gen, device=device) * 0.01
        scale = 0.125
        worst = 0.0
        for kind, gg in (("bf16 values", g.bfloat16().float()), ("f32", g)):
            got = attention_backward(q, k, v, gg, scale)
            again = attention_backward(q, k, v, gg, scale)
            closed = spatial_self_attention_backward(q, k, v, gg, scale)
            exact = spatial_self_attention_backward(
                q[:32].double(), k[:32].double(), v[:32].double(),
                gg[:32].double(), scale)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise AssertionError(f"K5 ({b}, {s}, 64): two calls differ")
            notes = []
            for name, x, c, e in zip(("dq", "dk", "dv"), got, closed, exact):
                top = e.abs().max().item()
                err = (x[:32].double() - e).abs().max().item()
                err_c = (c[:32].double() - e).abs().max().item()
                gap = (x.float() - c.float()).abs().max().item()
                if not (err <= 2 * err_c + bf16_ulp(top)
                        and gap <= 2 * bf16_ulp(c.float().abs().max().item())):
                    raise AssertionError(
                        f"K5 ({b}, {s}, 64) g {kind} {name}: err {err} (closed "
                        f"form {err_c}), against the closed form {gap}")
                worst = max(worst, gap)
                notes.append(f"{name} {err:.3g} ({err_c:.3g})")
            say(f"K5 ({b}, {s}, 64) g {kind}: err against f64 (closed form's) "
                + ", ".join(notes))
            del got, again, closed, exact
        gb = g.bfloat16().float()
        ms = device_ms(lambda: attention_backward(q, k, v, gb, scale))
        plain = call_ms(lambda: spatial_self_attention_backward(
            q, k, v, gb, scale), iters=3, warmup=1)
        q4, k4, v4 = (t.view(b, 1, s, 64).clone().requires_grad_()
                      for t in (q, k, v))
        o = F.scaled_dot_product_attention(q4, k4, v4, scale=scale)
        go = gb.bfloat16().view(b, 1, s, 64)
        lib = call_ms(lambda: torch.autograd.grad(
            o, (q4, k4, v4), go, retain_graph=True), iters=5, warmup=1)
        nbytes = b * s * 64 * (6 * 2 + 4)
        bms, by = bound_ms(nbytes, 8.0 * b * s * s * 64, torch.bfloat16)
        say(f"K5 {what} ({b}, {s}, 64) x{n}: {ms * 1e3:.1f} us, closed form "
            f"{plain * 1e3:.1f} us, SDPA backward {lib * 1e3:.1f} us, bound "
            f"{bms * 1e3:.1f} us ({by}) = {bms / ms:.1%}")
        add_site(tot, n, ms, plain, lib, bms, nbytes, worst)
        del q, k, v, g, gb, o, q4, k4, v4
        torch.cuda.empty_cache()
    say(f"K5 per {what} step: {tot['ms']:.3f} ms, closed form "
        f"{tot['plain_ms']:.3f} ms, SDPA backward {tot['library_ms']:.3f} ms,"
        f" bound {tot['bound_ms']:.3f} ms = {tot['bound_ms'] / tot['ms']:.1%}")
    return tot


def count_attention_backward(cfg: Config, device, what: str,
                             weights: dict | None = None) -> dict:
    """One counted Trainer step of ``cfg`` after a warm-up step: K3, K5 and
    closed-form backward calls."""
    trainer = Trainer(cfg, device=device, state_dict=weights, seed=SEED)
    rng = np.random.default_rng(SEED + 29)
    batches = [train_batch(cfg, it, rng) for it in range(2)]
    trainer.train_step(batches[0]).item()
    spatial_self_attention.launches = attention_backward.launches = 0
    _Attention.closed_form_calls = 0
    loss = trainer.train_step(batches[1]).item()
    counts = {"k3": spatial_self_attention.launches,
              "k5": attention_backward.launches,
              "closed_form": _Attention.closed_form_calls}
    say(f"{what} training step: loss {loss:.5f}; K3 {counts['k3']}, K5 "
        f"{counts['k5']}, closed-form backward {counts['closed_form']}")
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite {what} loss {loss}")
    del trainer
    torch.cuda.empty_cache()
    return counts


def run_k5_phase(device) -> dict:
    """Phase 29: K5 at every attention site of the DiT (R = 98) and the
    ADM (R = 112), timed against its bound, the closed form and SDPA's
    backward; K3's forward at the ADM's sites, as phase 28 times it; the
    attention backward's route in one training step of each family: the
    DiT 12 K5 and 0 closed form, the paper UNet (single heads of 192 and
    320 channels) 0 and 8.  The ADM's step (22 and 0) is phase 28's."""
    t_phase = time.perf_counter()
    dcfg = dit_config()
    dit = Counter({(b, s): n for (b, s, _), n in
                   dit_sites(dcfg, TRAIN_ROWS).items()})
    _, attn = adm_sites(adm_config(), device)
    adm = Counter()
    for (s, _, heads), n in attn.items():
        adm[(ADM_ROWS * heads, s)] += n
    out = {"dit": check_attention_backward(dit, device, "DiT"),
           "adm": check_attention_backward(adm, device, "ADM")}
    k3 = dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms",
                        "bound_bytes_ms", "max_abs_err"), 0.0)
    for (s, hd, heads), n in sorted(attn.items()):
        site = check_attention(Counter({(s, hd): n}), device,
                               rows=ADM_ROWS * heads, heads=True)
        for k, v in site.items():
            k3[k] = max(k3[k], v) if k == "max_abs_err" else k3[k] + v
        torch.cuda.empty_cache()
    say(f"ADM K3 per forward at {ADM_ROWS} rows: {k3['ms']:.3f} ms, bound "
        f"{k3['bound_ms']:.3f} ms = {k3['bound_ms'] / k3['ms']:.1%}")
    out["adm_k3_ms"] = k3["ms"]
    routes = {
        "dit": count_attention_backward(dcfg, device, "DiT",
                                        dit_weights(dcfg)),
        "unet": count_attention_backward(train_config(), device,
                                         "paper UNet")}
    want = {"dit": {"k3": 12, "k5": 12, "closed_form": 0},
            "unet": {"k3": 8, "k5": 0, "closed_form": 8}}
    if routes != want:
        raise AssertionError(f"attention backward routes {routes} != {want}")
    out["routes"] = routes
    say(f"phase 29 in {time.perf_counter() - t_phase:.1f} s")
    return out


def k5_kernel(k5: dict, adm: dict, by_path: dict) -> dict:
    """The ``kernels`` entry of K5 from phases 29 and 28: its totals per
    ADM training step (the DiT's apart), its launches in the counted
    steps of phases 28 and 29 and in ``by_path`` (other phases')."""
    tot, dit = k5["adm"], k5["dit"]
    by_path = {"dit_training_step": k5["routes"]["dit"]["k5"],
               "adm_training": adm["launches"]["k5"],
               "unet_training": k5["routes"]["unet"]["k5"], **by_path}
    pick = ("ms", "plain_ms", "library_ms", "bound_ms")
    return {
        "name": "attention_backward", "route": "cuda",
        "source": "viewfusion_tpu_torch/csrc/attention_bwd.cu",
        "replaces": "none: the JAX op's _attn_bwd leaves the closed form "
                    "to XLA",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": max(tot["max_abs_err"], dit["max_abs_err"]),
        **{k: tot[k] for k in pick},
        "bound_by": ("bytes" if tot["bound_bytes_ms"] >= tot["bound_ms"]
                     else "operations"),
        "per": f"one ADM training step's attention backwards at "
               f"{ADM_ROWS} rows",
        "dit_train_step": {"per": f"one DiT training step at {TRAIN_ROWS} "
                                  f"rows", **{k: dit[k] for k in pick}}}


def main() -> int:
    only_adm = sys.argv[1:2] == ["--adm"]
    only_k5 = sys.argv[1:2] == ["--k5"]
    if not torch.cuda.is_available():
        print("CUDA is not available: chip_smoke.py needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    # 1. device
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    say(f"device: {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.device_count()} device(s)")

    # 2. build
    t0 = time.perf_counter()
    _native.library()
    say(f"build: {time.perf_counter() - t0:.1f} s")
    print(_native.build_log(), file=sys.stderr, flush=True)

    if only_k5:     # 29, then 28
        k5 = run_k5_phase(device)
        adm = run_adm_phase(device)
        say(card_line())
        say(json.dumps({"kernels": [k5_kernel(k5, adm, {})],
                        "adm": adm_kernels(adm)}))
        say(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0
    if only_adm:    # 28 alone
        adm = run_adm_phase(device)
        say(card_line())
        say(json.dumps({"adm": adm_kernels(adm)}))
        say(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0

    # 3, 4. kernels at the paper UNet's sites
    cfg = Config.from_dict(PAPER_CONFIG)
    unet = paper_unet(device)
    gn_sites, attn_sites = sites(unet, ROWS, device)
    k1_calls, k3_calls = sum(gn_sites.values()), sum(attn_sites.values())
    say(f"paper UNet sites per forward: {k1_calls} GroupNorm "
        f"({len(gn_sites)} distinct), {k3_calls} attention "
        f"({len(attn_sites)} distinct)")
    w_sites = conv_sites(unet, TRAIN_ROWS, device)
    k4_calls = sum(w_sites.values())
    say(f"paper UNet stride-1 3x3 convs per forward: {k4_calls} "
        f"({len(w_sites)} distinct (H, W, Cin, Cout))")
    k1 = check_group_norm(gn_sites, cfg.unet.norm_groups, device)
    k3 = check_attention(attn_sites, device)

    # 5. full-width UNet, kernels against plain versions
    check_full_unet(unet, device)
    profile_forward(unet, device)
    state_dict = {k: v.float().cpu() for k, v in unet.state_dict().items()}
    del unet
    torch.cuda.empty_cache()

    # 6. serving: the main path
    service = ViewFusionService.from_state_dict(
        cfg, state_dict, batch_size=BATCH, max_views=MAX_VIEWS,
        default_steps=DDIM_STEPS, device=device)
    t0 = time.perf_counter()
    service.warmup([DDIM_STEPS], sampler="ddim")
    service.warmup([DPM_STEPS], sampler="dpm")
    say(f"warmup (ddim {DDIM_STEPS} + dpm {DPM_STEPS} steps): "
        f"{time.perf_counter() - t0:.1f} s")
    service.batch_log.clear()
    group_norm_act.launches = 0
    spatial_self_attention.launches = 0
    mark = tracing.mark()
    t0 = time.perf_counter()
    results = serve_requests(
        service, [np.random.default_rng(SEED + i) for i in range(14)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    forwards = forwards_since(mark)
    say(f"serving spans: {span_summary(mark)}; counters "
        f"{tracing.counters()}")
    launches = {"k1": group_norm_act.launches,
                "k3": spatial_self_attention.launches}
    for img, _, sampler in results:
        if not (img.shape == (64, 64, 3) and np.isfinite(img).all()
                and img.min() >= 0.0 and img.max() <= 1.0):
            raise AssertionError(f"bad {sampler} output {img.shape}")
    if forwards == 0 or launches != {"k1": k1_calls * forwards,
                                     "k3": k3_calls * forwards}:
        raise AssertionError(
            f"launch counters {launches} != per-forward sites "
            f"({k1_calls}, {k3_calls}) x {forwards} forwards")
    lat = sorted(r[1] for r in results)
    say(f"served {len(results)} requests ({sum(r[2] != 'ddim' for r in results)}"
        f" dpm) in {wall:.2f} s = {len(results) / wall:.2f} views/s, "
        f"request latency p50 {lat[len(lat) // 2]:.2f} s max {lat[-1]:.2f} s"
        f" on {card}")
    for steps, sampler, n, sec in service.batch_log:
        say(f"  batch {sampler} {steps} steps, {n} requests: "
            f"{sec * 1e3:.0f} ms ({sec * 1e3 / steps:.1f} ms per step)")
    say(f"launches on the main path: K1 {launches['k1']}, K3 "
        f"{launches['k3']} over {forwards} UNet forwards")

    # 7. a small chain on the card against the CPU
    check_chain_against_cpu(device)
    del service
    torch.cuda.empty_cache()

    # 8. K2 at the paper UNet's GroupNorm sites at the training batch
    k2 = check_group_norm_backward(gn_sites, cfg.unet.norm_groups, device)
    torch.cuda.empty_cache()

    # 9. full-width bf16 training step, kernels against plain versions
    check_train_step(device)
    torch.cuda.empty_cache()

    # 10. training: the second main path
    train_launches, trainer_ms = run_trainer(device, k1_calls, k3_calls)
    torch.cuda.empty_cache()

    # 11. tiny f32 train steps on the card against the CPU
    check_train_against_cpu(device)
    torch.cuda.empty_cache()

    # 12. K4 at the paper UNet's conv sites at the training batch
    k4 = check_conv_wgrad(w_sites, device)
    torch.cuda.empty_cache()

    # 13. the conv3x3 op: a full-width training step through K4
    conv_launches = check_conv3x3_step(device, k4_calls)
    torch.cuda.empty_cache()

    # 14. ancestral sampling: the third main path
    anc_launches, anc_errs, k1_anc = run_ancestral(device, k1_calls,
                                                   k3_calls)
    for tot, key in ((k1, "k1"), (k3, "k3")):
        tot["max_abs_err"] = max(tot["max_abs_err"], anc_errs[key])
    torch.cuda.empty_cache()

    # 15. tiny f32 ancestral chain on the card against the CPU
    check_ancestral_against_cpu(device)
    torch.cuda.empty_cache()

    # 16. the experiment loop through the CLI: the fourth main path
    exp_launches, loop_ms = run_experiment(k1_calls, k3_calls, trainer_ms)
    torch.cuda.empty_cache()

    # 17-22. the DiT family at configs/dit-small-tpu-4.yaml's widths
    dit = run_dit_phases(device)
    k3["max_abs_err"] = max(k3["max_abs_err"], dit["max_abs_err"])
    torch.cuda.empty_cache()

    # 23-24. more than one process under torchrun; dropout on the card
    mp = run_mp_phases(device, k1_calls, k3_calls, loop_ms,
                       cfg.unet.norm_groups)
    for tot, key in ((k1, "k1"), (k2, "k2"), (k3, "k3")):
        tot["max_abs_err"] = max(tot["max_abs_err"], mp["errs"][key])
    torch.cuda.empty_cache()

    # 25. the published-weights path: convert, serve, evaluate
    pretrained = run_pretrained(state_dict, device, k1_calls, k3_calls,
                                cfg.unet.norm_groups)
    for tot, key in ((k1, "k1"), (k3, "k3")):
        tot["max_abs_err"] = max(tot["max_abs_err"], pretrained["errs"][key])
    torch.cuda.empty_cache()

    # 26. the input formats on the served path
    formats = run_formats(state_dict, device, k1_calls, k3_calls)
    torch.cuda.empty_cache()

    # 27. the served forward replayed as a CUDA graph (counted apart)
    graphed = run_graphed_serving(state_dict, device, k1_calls, k3_calls)
    torch.cuda.empty_cache()

    # 28. the ADM denoiser: K1/K2 with a (B, C) affine, K3, a train step
    adm = run_adm_phase(device)
    torch.cuda.empty_cache()

    # 29. K5 at the DiT's and the ADM's sites; the backward's route a step
    k5 = run_k5_phase(device)

    kernels = []
    for name, route_src, replaces, tot, key, per in (
            ("group_norm_act", "viewfusion_tpu_torch/csrc/groupnorm.cu",
             "viewfusion_tpu/ops/groupnorm.py:147", k1, "k1",
             f"one UNet forward at {ROWS} rows"),
            ("group_norm_act_backward",
             "viewfusion_tpu_torch/csrc/groupnorm_bwd.cu",
             "viewfusion_tpu/ops/groupnorm.py:256", k2, "k2",
             f"one training step (backward) at {TRAIN_ROWS} rows"),
            ("spatial_self_attention",
             "viewfusion_tpu_torch/csrc/attention.cu",
             "viewfusion_tpu/ops/attention.py:47", k3, "k3",
             f"one UNet forward at {ROWS} rows")):
        by_path = {"serving": launches.get(key, 0),
                   "training": train_launches[key]}
        if key in anc_launches:
            by_path["ancestral"] = anc_launches[key]
        by_path["experiment"] = exp_launches[key]
        if key == "k3":
            by_path.update(dit["launches"])
        for path, counts in mp["launches"].items():
            by_path[path] = counts[key]
        if key in pretrained["launches"]:
            by_path["pretrained"] = pretrained["launches"][key]
        if key in formats["launches"]:
            by_path["formats"] = formats["launches"][key]
        kernels.append({
            "name": name, "route": "cuda", "source": route_src,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": tot["max_abs_err"], "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": ("bytes" if tot["bound_bytes_ms"] >= tot["bound_ms"]
                         else "operations"),
            "library_ms": tot["library_ms"], "per": per,
        })
    kernels[0]["ancestral_forward"] = {
        "per": f"one UNet forward at the ancestral chain's "
               f"{k1_anc['rows']} packed rows",
        **{k: k1_anc[k] for k in ("ms", "plain_ms", "library_ms",
                                  "bound_ms")}}
    for name, rows in (("dit_forward", ROWS),
                       ("dit_train_forward", TRAIN_ROWS)):
        kernels[2][name] = {
            "per": f"one DiT forward at {rows} rows ({dit['calls']} calls on "
                   f"{next(iter(dit_sites(dit['config'], rows)))})",
            **{k: dit["sites"][rows][k] for k in ("ms", "plain_ms",
                                                  "library_ms", "bound_ms")}}
    kernels.append({
        "name": "conv3x3_wgrad", "route": "cuda",
        "source": "viewfusion_tpu_torch/csrc/conv_wgrad.cu",
        "replaces": "viewfusion_tpu/ops/conv_wgrad.py:47",
        "launches": conv_launches,
        "launches_by_path": {"conv3x3": conv_launches},
        "max_abs_err": k4["max_abs_err"], "ms": k4["ms"],
        "plain_ms": k4["plain_ms"], "bound_ms": k4["bound_ms"],
        "bound_by": ("bytes" if k4["bound_bytes_ms"] >= k4["bound_ms"]
                     else "operations"),
        "library_ms": k4["library_ms"],
        "per": f"one training step's {k4_calls} conv weight gradients at "
               f"{TRAIN_ROWS} rows"})
    kernels.append(k5_kernel(k5, adm, dit["k5_launches"]))
    say(card_line())
    say(json.dumps({"kernels": kernels,
                    "graphed_serving_launches": graphed,
                    "adm": adm_kernels(adm)}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-child"]:  # a rank of phases 23-24
        sys.exit(rank_child(sys.argv[2:]))
    sys.exit(main())
