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
"""

from __future__ import annotations

import math

import torch
from torch.autograd.function import once_differentiable

from viewfusion_tpu_torch import _native

__all__ = ["group_norm_act", "group_norm_act_reference",
           "group_norm_act_backward", "group_norm_act_backward_reference"]

_ACTS = {"none": 0, "silu": 1}


def _check_args(x: torch.Tensor, groups: int, act: str) -> None:
    if x.dim() < 2:
        raise ValueError(f"x must be (B, ..., C), got shape {tuple(x.shape)}")
    if x.shape[-1] % groups:
        raise ValueError(
            f"channels {x.shape[-1]} not divisible by groups {groups}")
    if act not in _ACTS:
        raise ValueError(f"unsupported act {act!r}")


def _per_channel(stat: torch.Tensor, cpg: int) -> torch.Tensor:
    """(B, G) group statistic -> (B, 1, C) f32."""
    return stat.float().repeat_interleave(cpg, dim=1)[:, None, :]


def group_norm_act_reference(x, scale, bias, *, groups, eps=1e-5,
                             act="none"):
    """Plain PyTorch GroupNorm(+SiLU) with the kernel's arithmetic.

    Returns ``(y, mean, rstd)``: y in x's dtype and shape, mean/rstd
    (B, G) f32.  Statistics use the clamped E[x^2] - mean^2 variance of
    the TPU kernel (viewfusion_tpu/ops/groupnorm.py:168-189)."""
    _check_args(x, groups, act)
    b, c = x.shape[0], x.shape[-1]
    cpg = c // groups
    xf = x.reshape(b, -1, groups, cpg).float()
    n = xf.shape[1] * cpg
    mean = xf.sum(dim=(1, 3)) / n
    var = torch.clamp((xf * xf).sum(dim=(1, 3)) / n - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    sc = _per_channel(rstd, cpg) * scale.float()
    sh = bias.float() - _per_channel(mean, cpg) * sc
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
    partials per sample (B, C) f32, as ``_pallas_bwd`` returns them."""
    _check_args(x, groups, act)
    b, c = x.shape[0], x.shape[-1]
    cpg = c // groups
    xf = x.reshape(b, -1, c).float()
    gf = g.reshape(b, -1, c).float()
    n = xf.shape[1] * cpg
    scale, bias = scale.float(), bias.float()
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
    a_g = (dbias * scale).reshape(b, groups, cpg).sum(dim=-1) / n
    b_g = (dscale * scale).reshape(b, groups, cpg).sum(dim=-1) / n
    ra = rstd_c * _per_channel(a_g, cpg)
    rb = rstd_c * _per_channel(b_g, cpg)
    dx = dy * sc - (xhat * rb + ra)
    return dx.to(x.dtype).reshape(x.shape), dscale, dbias


def _splits(device: torch.device, b: int, l: int) -> int:
    """Row splits per sample: enough blocks for ~4 per SM, at least 16
    rows a block (see csrc/groupnorm.cu)."""
    want = math.ceil(4 * _native.sm_count(device) / b)
    return max(1, min(want, l // 16))


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
    _check_f32("group_norm_act", x, scale=(scale, (c,)), bias=(bias, (c,)))
    l = x.numel() // (b * c)
    lib = _native.library()
    splits = _splits(x.device, b, l)
    y = torch.empty_like(x)
    # f32 scratch: the two (B, splits, C) partial-sum workspaces, then
    # mean and rstd (B, G), one allocation addressed by offset.  Stats
    # kept for a backward get their own allocation, so that they do not
    # hold the workspace alive.
    n_stat, n_ws = b * groups, b * splits * c
    scratch = torch.empty(2 * n_ws + (0 if return_stats else 2 * n_stat),
                          device=x.device, dtype=torch.float32)
    stats = (torch.empty((2, b, groups), device=x.device,
                         dtype=torch.float32) if return_stats
             else scratch[2 * n_ws:])
    p, s = scratch.data_ptr(), stats.data_ptr()
    err = lib.vf_group_norm_act_fwd(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        s, s + 4 * n_stat, p, p + 4 * n_ws,
        b, l, c, groups, splits, float(eps), _ACTS[act], code,
        _native.stream_ptr(x.device))
    _native.check(err, "group_norm_act")
    group_norm_act.launches += 1
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
    _check_f32(what, x, scale=(scale, (c,)), bias=(bias, (c,)),
               mean=(mean, (b, groups)), rstd=(rstd, (b, groups)))
    l = x.numel() // (b * c)
    lib = _native.library()
    splits = _splits(x.device, b, l)
    dx = torch.empty_like(x)
    # f32 scratch: dscale/dbias partials (B, C), then the two
    # (B, splits, C) workspaces of the row-split reduction
    n_p, n_ws = b * c, b * splits * c
    scratch = torch.empty(2 * (n_p + n_ws), device=x.device,
                          dtype=torch.float32)
    p = scratch.data_ptr()
    err = lib.vf_group_norm_act_bwd(
        x.data_ptr(), g.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
        p, p + 4 * n_p, p + 8 * n_p, p + 8 * n_p + 4 * n_ws,
        b, l, c, groups, splits, _ACTS[act], code,
        _native.stream_ptr(x.device))
    _native.check(err, what)
    group_norm_act_backward.launches += 1
    partials = scratch[:2 * n_p].view(2, b, c)
    return dx, partials[0], partials[1]


def group_norm_act_backward(x, g, scale, bias, mean, rstd, *, groups,
                            act="none"):
    """Gradient of :func:`group_norm_act` from its saved statistics.

    ``x`` and the upstream gradient ``g`` are contiguous (B, ..., C) of
    one dtype (bf16 or f32), ``scale``/``bias`` (C,) f32 and
    ``mean``/``rstd`` (B, G) f32 as the forward returns them.  Returns
    ``(dx, dscale_p, dbias_p)``: dx in x's dtype, the dscale/dbias
    partials per sample (B, C) f32.  CUDA tensors launch kernel K2; CPU
    tensors run the plain version."""
    _check_args(x, groups, act)
    if x.is_cuda:
        return _launch_backward(x, g, scale, bias, mean, rstd, groups, act)
    if x.device.type == "cpu":
        return group_norm_act_backward_reference(
            x, g, scale, bias, mean, rstd, groups=groups, act=act)
    raise ValueError(f"group_norm_act_backward: unsupported device "
                     f"{x.device}")


class _GroupNormAct(torch.autograd.Function):
    """K1 forward, K2 backward (plain versions on the CPU).  dscale and
    dbias are the sums over B of the per-sample partials, in a fixed
    order (``_gn_act_bwd``, viewfusion_tpu/ops/groupnorm.py:714-720)."""

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
        return dx, dscale_p.sum(dim=0), dbias_p.sum(dim=0), None, None, None


def group_norm_act(x, scale, bias, *, groups, eps=1e-5, act="none",
                   return_stats=False):
    """GroupNorm over the trailing channel axis of ``x`` (B, ..., C),
    per sample over all other axes, then optional SiLU (``act="silu"``).

    ``x`` is bf16 or f32 and contiguous (NHWC, or the (B, H*W, C) rows of
    a channels_last NCHW tensor); ``scale``/``bias`` are (C,) f32.
    Returns y in x's dtype, plus (mean, rstd) (B, G) f32 when
    ``return_stats``.  CUDA tensors launch kernel K1; CPU tensors run the
    plain version.  Where autograd records (an input requires grad), the
    call goes through an autograd Function whose backward is K2 on CUDA
    and the plain backward on the CPU."""
    _check_args(x, groups, act)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        y, mean, rstd = _GroupNormAct.apply(x, scale, bias, groups, eps, act)
    else:
        y, mean, rstd = _forward(x, scale, bias, groups, eps, act,
                                 return_stats)
    return (y, mean, rstd) if return_stats else y


group_norm_act.launches = 0
group_norm_act_backward.launches = 0
# upstream gradients that arrived in another layout and were copied to
# contiguous rows before K2
group_norm_act_backward.grad_copies = 0
