"""Fused GroupNorm(+SiLU): forward kernel K1, backward kernel K2 and their
plain versions.

``group_norm_act`` is the counterpart of ``viewfusion_tpu.ops.groupnorm.
group_norm_act``: GroupNorm over the trailing channel axis of a
channels-last tensor, f32 statistics, output in x's dtype, optionally
followed by SiLU.  It is differentiable on both devices, as the JAX op's
custom VJP (``_gn_act_pallas``): the forward saves x and the (B, G)
statistics, the backward is the analytic gradient of ``_bwd_kernel_v2``.
On CUDA tensors the forward launches ``csrc/groupnorm.cu`` (K1) and the
backward ``csrc/groupnorm_bwd.cu`` (K2); on CPU tensors both run their
plain versions, :func:`group_norm_act_reference` and
:func:`group_norm_act_backward_reference`.

The affine ``scale``/``bias`` is (C,), the GroupNorm's own, or (B, C), one
per (sample, channel): a scale-shift norm (AdaGN) whose per-sample
``(1 + s, t)`` the caller folds into the GroupNorm's affine.  The C
entries take the affine's sample stride (0 or C) and run a (B, C) affine
in a kernel instantiation of its own, so the per-channel kernels are
unchanged; the backward's affine gradients are shaped like the affine.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from viewfusion_tpu_torch import _native, tracing

__all__ = ["group_norm_act", "group_norm_act_reference",
           "group_norm_act_backward", "group_norm_act_backward_reference",
           "group_norm_plan", "group_norm_active_clusters", "GroupNormPlan"]

_ACTS = {"none": 0, "silu": 1}


def _check_args(x: torch.Tensor, groups: int, act: str) -> None:
    if x.dim() < 2:
        raise ValueError(f"x must be (B, ..., C), got shape {tuple(x.shape)}")
    if x.shape[-1] % groups:
        raise ValueError(
            f"channels {x.shape[-1]} not divisible by groups {groups}")
    if act not in _ACTS:
        raise ValueError(f"unsupported act {act!r}")


def _check_affine(what: str, x: torch.Tensor, scale, bias) -> None:
    b, c = x.shape[0], x.shape[-1]
    if tuple(scale.shape) not in ((c,), (b, c)) or bias.shape != scale.shape:
        raise ValueError(f"{what}: scale and bias must both be ({c},) or "
                         f"({b}, {c}), got {tuple(scale.shape)} and "
                         f"{tuple(bias.shape)}")


def _per_channel(stat: torch.Tensor, cpg: int) -> torch.Tensor:
    """(B, G) group statistic -> (B, 1, C) f32."""
    return stat.float().repeat_interleave(cpg, dim=1)[:, None, :]


def _rows(affine: torch.Tensor) -> torch.Tensor:
    """A (C,) or (B, C) affine -> (1, 1, C) or (B, 1, C) f32."""
    return affine.float().reshape(-1, 1, affine.shape[-1])


def group_norm_act_reference(x, scale, bias, *, groups, eps=1e-5,
                             act="none"):
    """Plain PyTorch GroupNorm(+SiLU) with the kernel's arithmetic.

    Returns ``(y, mean, rstd)``: y in x's dtype and shape, mean/rstd
    (B, G) f32.  Statistics use the clamped E[x^2] - mean^2 variance of
    the TPU kernel (viewfusion_tpu/ops/groupnorm.py:168-189).  ``scale``
    and ``bias`` are (C,) or (B, C)."""
    _check_args(x, groups, act)
    _check_affine("group_norm_act", x, scale, bias)
    b, c = x.shape[0], x.shape[-1]
    cpg = c // groups
    xf = x.reshape(b, -1, groups, cpg).float()
    n = xf.shape[1] * cpg
    mean = xf.sum(dim=(1, 3)) / n
    var = torch.clamp((xf * xf).sum(dim=(1, 3)) / n - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    sc = _per_channel(rstd, cpg) * _rows(scale)
    sh = _rows(bias) - _per_channel(mean, cpg) * sc
    z = xf.reshape(b, -1, c) * sc + sh
    if act == "silu":
        z = z * torch.sigmoid(z)
    return z.to(x.dtype).reshape(x.shape), mean, rstd


def group_norm_act_backward_reference(x, g, scale, bias, mean, rstd, *,
                                      groups, act="none"):
    """Plain PyTorch GroupNorm(+SiLU) backward with K2's arithmetic
    (``_bwd_kernel_v2``): from the saved (B, G) mean/rstd,
    dy = g * act'(z), two per-channel reductions (dbias = sum dy,
    dscale = sum dy * xhat), then dx = dy * sc - (xhat * rb + ra).

    Returns ``(dx, dscale_p, dbias_p)``: dx in x's dtype and shape, the
    partials per sample (B, C) f32, as ``_pallas_bwd`` returns them.
    ``scale`` and ``bias`` are (C,) or (B, C)."""
    _check_args(x, groups, act)
    _check_affine("group_norm_act_backward", x, scale, bias)
    b, c = x.shape[0], x.shape[-1]
    cpg = c // groups
    xf = x.reshape(b, -1, c).float()
    gf = g.reshape(b, -1, c).float()
    n = xf.shape[1] * cpg
    scale, bias = _rows(scale), _rows(bias)
    rstd_c, mean_c = _per_channel(rstd, cpg), _per_channel(mean, cpg)
    sc = rstd_c * scale
    sh = bias - mean_c * sc
    xhat = xf * rstd_c - mean_c * rstd_c
    dy = gf
    if act == "silu":
        z = xf * sc + sh
        s = torch.sigmoid(z)
        dy = gf * (s * (1.0 + z * (1.0 - s)))
    dbias = dy.sum(dim=1)
    dscale = (dy * xhat).sum(dim=1)
    a_g = (dbias * scale[:, 0]).reshape(b, groups, cpg).sum(dim=-1) / n
    b_g = (dscale * scale[:, 0]).reshape(b, groups, cpg).sum(dim=-1) / n
    ra = rstd_c * _per_channel(a_g, cpg)
    rb = rstd_c * _per_channel(b_g, cpg)
    dx = dy * sc - (xhat * rb + ra)
    return dx.to(x.dtype).reshape(x.shape), dscale, dbias


# K1/K2's work plan (csrc/gn_cluster.cuh): one thread-block cluster per
# sample; each block stages its contiguous range of the sample's rows in
# shared memory, in up to _MAX_CHUNKS bulk-copy chunks
_SMEM_BYTES = 232_448      # dynamic shared memory one block may use
_TWO_BLOCKS = 115_712      # ... with two blocks on an SM (1 KB each kept)
_BAR_BYTES = 128           # the chunks' mbarriers (csrc/tma.cuh kBarBytes)
_MAX_CHUNKS = 16
_THREADS = 256             # threads a block, unless a row needs more
_MAX_THREADS = 512
_PORTABLE_CLUSTER = 8      # larger clusters need the non-portable flag
_MAX_CLUSTER = 16


class GroupNormPlan(NamedTuple):
    """Launch plan of K1 or K2 for one (B, L, C, dtype): ``cluster``
    blocks per sample, each owning ``rows_per_block`` rows (the last
    blocks fewer, or none), of which it stages the first ``rows_staged``
    in shared memory in chunks of ``chunk_rows``; ``threads`` a block,
    ``vec`` channels a thread, ``smem`` bytes of dynamic shared memory;
    ``bulk`` where rows are staged by bulk copies (16-byte vectors)."""
    cluster: int
    rows_per_block: int
    rows_staged: int
    chunk_rows: int
    threads: int
    smem: int
    vec: int
    bulk: bool


def _plan_layout(l, c, itemsize, n_tensors, vec, cluster, smem_cap):
    """The plan of ``cluster`` blocks per sample, each staging as many of
    its rows as fit ``smem_cap`` bytes of shared memory."""
    nv = c // vec
    rows = -(-l // cluster)
    threads = nv * max(1, min(max(1, _THREADS // nv), rows))
    row_bytes = c * itemsize * n_tensors
    fixed = _BAR_BYTES + 4 * threads * vec + 8 * c * (cluster + 2)
    staged = min(rows, max(0, (smem_cap - fixed) // row_bytes))
    rpi = threads // nv
    sweeps = -(-staged // rpi)
    chunk_rows = rpi * max(1, -(-sweeps // _MAX_CHUNKS))
    smem = fixed + -(-staged * row_bytes // 16) * 16
    return GroupNormPlan(cluster, rows, staged, chunk_rows, threads, smem,
                         vec, vec * itemsize == 16)


@functools.lru_cache(maxsize=None)
def group_norm_plan(b: int, l: int, c: int, itemsize: int, n_tensors: int,
                    sms: int, align: int = 16) -> GroupNormPlan:
    """The work plan of K1 (``n_tensors=1``: x) or K2 (2: x and g) for
    (B, L, C) rows of ``itemsize``-byte elements on a card with ``sms``
    SMs, data pointers aligned to ``align`` bytes.

    The cluster starts at the smallest power of two that puts at least
    ``sms / 2`` blocks on the card (at most 8 for that: at the small
    sites the cluster's fixed costs outweigh more SMs), and doubles (up to
    16, the non-portable cluster size) until each block stages all its
    rows in half an SM's shared memory (two blocks fit an SM); failing
    that, in all of a block's 227 KB; failing that (large f32 shapes),
    each block of 16 stages what fits and reads the rest of its rows from
    device memory.
    Threads run along C with the widest vector (at most 16 bytes) that
    divides C and the alignment, 256 a block unless a row needs more.
    """
    vec = next(v for v in (8, 4, 2, 1) if v * itemsize <= 16
               and c % v == 0 and align % (v * itemsize) == 0)
    if c // vec > _MAX_THREADS:
        raise ValueError(f"group_norm_act: {c} channels need {c // vec} "
                         f"threads a row, more than {_MAX_THREADS}")
    fill = 1
    while fill < min(_PORTABLE_CLUSTER, l) and 2 * b * fill < sms:
        fill *= 2
    clusters = [cl for cl in (1, 2, 4, 8, 16) if cl >= fill
                and (cl == fill or cl < 2 * l)]
    for cap in (_TWO_BLOCKS, _SMEM_BYTES):
        for cluster in clusters:
            plan = _plan_layout(l, c, itemsize, n_tensors, vec, cluster, cap)
            if plan.rows_staged == plan.rows_per_block:
                return plan
    return _plan_layout(l, c, itemsize, n_tensors, vec, clusters[-1],
                        _SMEM_BYTES)


def _alignment(*tensors) -> int:
    """The largest power of two up to 16 that divides every data
    pointer."""
    align = 16
    for t in tensors:
        while t.data_ptr() % align:
            align //= 2
    return align


def _plan_for(x, n_tensors, *tensors) -> GroupNormPlan:
    b, c = x.shape[0], x.shape[-1]
    return group_norm_plan(b, x.numel() // (b * c), c, x.element_size(),
                           n_tensors, _native.sm_count(x.device),
                           _alignment(x, *tensors))


def group_norm_active_clusters(plan: GroupNormPlan, dtype,
                               backward: bool = False) -> int:
    """How many clusters of ``plan``'s shape the current CUDA device holds
    at once (cudaOccupancyMaxActiveClusters) for K1, or K2 with
    ``backward``; 0 means the plan cannot be launched."""
    lib = _native.library()
    fn = (lib.vf_group_norm_act_bwd_clusters if backward
          else lib.vf_group_norm_act_fwd_clusters)
    active = ctypes.c_int(0)
    err = fn(plan.cluster, plan.threads, plan.smem, plan.vec,
             _native.dtype_code(dtype, "group_norm_plan"),
             ctypes.byref(active))
    _native.check(err, "group_norm_active_clusters")
    return active.value


def _plan_args(plan: GroupNormPlan) -> tuple:
    return (plan.cluster, plan.rows_per_block, plan.rows_staged,
            plan.chunk_rows, plan.threads, plan.smem, plan.vec)


def _check_f32(what, x, **tensors) -> None:
    """Each named tensor must be contiguous f32 of its given shape on x's
    device."""
    for name, (t, shape) in tensors.items():
        if (t.device != x.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"{what}: {name} must be contiguous float32 {shape} on "
                f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _launch(x, scale, bias, groups, eps, act, return_stats):
    code = _native.dtype_code(x.dtype, "group_norm_act")
    if not x.is_contiguous():
        raise ValueError("group_norm_act: x must be contiguous (B, ..., C)")
    b, c = x.shape[0], x.shape[-1]
    _check_f32("group_norm_act", x, scale=(scale, tuple(scale.shape)),
               bias=(bias, tuple(scale.shape)))
    l = x.numel() // (b * c)
    per_sample = scale.dim() == 2
    lib = _native.library()
    y = torch.empty_like(x)
    plan = _plan_for(x, 1, y)
    # the (2, B, G) mean/rstd, stored only when asked for
    stats = mean_p = rstd_p = None
    if return_stats:
        stats = torch.empty((2, b, groups), device=x.device,
                            dtype=torch.float32)
        mean_p = stats.data_ptr()
        rstd_p = mean_p + 4 * b * groups
    err = lib.vf_group_norm_act_fwd(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        mean_p, rstd_p, b, l, c, groups, *_plan_args(plan),
        float(eps), _ACTS[act], c if per_sample else 0, code,
        _native.stream_ptr(x.device))
    _native.check(err, "group_norm_act")
    group_norm_act.launches += 1
    group_norm_act.affine_launches += per_sample
    if not return_stats:
        return y, None, None
    return y, stats[0], stats[1]


def _forward(x, scale, bias, groups, eps, act, return_stats):
    if x.is_cuda:
        return _launch(x, scale, bias, groups, eps, act, return_stats)
    if x.device.type == "cpu":
        return group_norm_act_reference(x, scale, bias, groups=groups,
                                         eps=eps, act=act)
    raise ValueError(f"group_norm_act: unsupported device {x.device}")


def _launch_backward(x, g, scale, bias, mean, rstd, groups, act):
    what = "group_norm_act_backward"
    code = _native.dtype_code(x.dtype, what)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"{what}: g must match x in shape, dtype and "
                         f"device, got {g.dtype} {tuple(g.shape)} on "
                         f"{g.device}")
    if not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError(f"{what}: x and g must be contiguous (B, ..., C)")
    b, c = x.shape[0], x.shape[-1]
    _check_f32(what, x, scale=(scale, tuple(scale.shape)),
               bias=(bias, tuple(scale.shape)),
               mean=(mean, (b, groups)), rstd=(rstd, (b, groups)))
    l = x.numel() // (b * c)
    per_sample = scale.dim() == 2
    lib = _native.library()
    dx = torch.empty_like(x)
    plan = _plan_for(x, 2, g, dx)
    partials = torch.empty((2, b, c), device=x.device, dtype=torch.float32)
    p = partials.data_ptr()
    err = lib.vf_group_norm_act_bwd(
        x.data_ptr(), g.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(), p, p + 4 * b * c,
        b, l, c, groups, *_plan_args(plan), _ACTS[act],
        c if per_sample else 0, code, _native.stream_ptr(x.device))
    _native.check(err, what)
    group_norm_act_backward.launches += 1
    group_norm_act_backward.affine_launches += per_sample
    return dx, partials[0], partials[1]


def group_norm_act_backward(x, g, scale, bias, mean, rstd, *, groups,
                            act="none"):
    """Gradient of :func:`group_norm_act` from its saved statistics.

    ``x`` and the upstream gradient ``g`` are contiguous (B, ..., C) of
    one dtype (bf16 or f32), ``scale``/``bias`` (C,) or (B, C) f32 and
    ``mean``/``rstd`` (B, G) f32 as the forward returns them.  Returns
    ``(dx, dscale_p, dbias_p)``: dx in x's dtype, the dscale/dbias
    partials per sample (B, C) f32.  CUDA tensors launch kernel K2; CPU
    tensors run the plain version."""
    _check_args(x, groups, act)
    _check_affine("group_norm_act_backward", x, scale, bias)
    if x.is_cuda:
        return _launch_backward(x, g, scale, bias, mean, rstd, groups, act)
    if x.device.type == "cpu":
        return group_norm_act_backward_reference(
            x, g, scale, bias, mean, rstd, groups=groups, act=act)
    raise ValueError(f"group_norm_act_backward: unsupported device "
                     f"{x.device}")


class _GroupNormAct(torch.autograd.Function):
    """K1 forward, K2 backward (plain versions on the CPU).  For a (C,)
    affine, dscale and dbias are the sums over B of the per-sample
    partials, in a fixed order (``_gn_act_bwd``,
    viewfusion_tpu/ops/groupnorm.py:714-720); for a (B, C) affine they
    are the partials themselves."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps, act):
        y, mean, rstd = _forward(x, scale, bias, groups, eps, act, True)
        ctx.save_for_backward(x, scale, bias, mean, rstd)
        ctx.groups, ctx.act = groups, act
        ctx.mark_non_differentiable(mean, rstd)
        return y, mean, rstd

    @staticmethod
    @once_differentiable
    def backward(ctx, gy, _gmean, _grstd):
        x, scale, bias, mean, rstd = ctx.saved_tensors
        if not gy.is_contiguous():
            gy = gy.contiguous()
            group_norm_act_backward.grad_copies += 1
        dx, dscale_p, dbias_p = group_norm_act_backward(
            x, gy, scale, bias, mean, rstd, groups=ctx.groups, act=ctx.act)
        if scale.dim() == 1:
            dscale_p, dbias_p = dscale_p.sum(dim=0), dbias_p.sum(dim=0)
        return dx, dscale_p, dbias_p, None, None, None


def group_norm_act(x, scale, bias, *, groups, eps=1e-5, act="none",
                   return_stats=False):
    """GroupNorm over the trailing channel axis of ``x`` (B, ..., C),
    per sample over all other axes, then optional SiLU (``act="silu"``).

    ``x`` is bf16 or f32 and contiguous (NHWC, or the (B, H*W, C) rows of
    a channels_last NCHW tensor); ``scale``/``bias`` are (C,) f32, or
    (B, C) f32 for an affine per sample (the backward then gives their
    gradients per sample).
    Returns y in x's dtype, plus (mean, rstd) (B, G) f32 when
    ``return_stats``.  CUDA tensors launch kernel K1; CPU tensors run the
    plain version.  Where autograd records (an input requires grad), the
    call goes through an autograd Function whose backward is K2 on CUDA
    and the plain backward on the CPU."""
    _check_args(x, groups, act)
    _check_affine("group_norm_act", x, scale, bias)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        y, mean, rstd = _GroupNormAct.apply(x, scale, bias, groups, eps, act)
    else:
        y, mean, rstd = _forward(x, scale, bias, groups, eps, act,
                                 return_stats)
    return (y, mean, rstd) if return_stats else y


group_norm_act.launches = 0
group_norm_act_backward.launches = 0
# launches with an affine per (sample, channel)
group_norm_act.affine_launches = 0
group_norm_act_backward.affine_launches = 0
# upstream gradients that arrived in another layout and were copied to
# contiguous rows before K2
group_norm_act_backward.grad_copies = 0
tracing.watch("k1.launches", group_norm_act, "launches")
tracing.watch("k2.launches", group_norm_act_backward, "launches")
tracing.watch("k1.affine_launches", group_norm_act, "affine_launches")
tracing.watch("k2.affine_launches", group_norm_act_backward,
              "affine_launches")
tracing.watch("k2.grad_copies", group_norm_act_backward, "grad_copies")
