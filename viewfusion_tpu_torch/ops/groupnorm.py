"""Fused GroupNorm(+SiLU) forward: CUDA kernel K1 and its plain version.

``group_norm_act`` is the counterpart of ``viewfusion_tpu.ops.groupnorm.
group_norm_act``: GroupNorm over the trailing channel axis of a
channels-last tensor, f32 statistics, output in x's dtype, optionally
followed by SiLU.  On a CUDA tensor it launches ``csrc/groupnorm.cu``;
on a CPU tensor it runs :func:`group_norm_act_reference`.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from viewfusion_tpu_torch import _native

__all__ = ["group_norm_act", "group_norm_act_reference"]

_ACTS = {"none": 0, "silu": 1}
_sm_count: Dict[int, int] = {}


def _check_args(x: torch.Tensor, groups: int, act: str) -> None:
    if x.dim() < 2:
        raise ValueError(f"x must be (B, ..., C), got shape {tuple(x.shape)}")
    if x.shape[-1] % groups:
        raise ValueError(
            f"channels {x.shape[-1]} not divisible by groups {groups}")
    if act not in _ACTS:
        raise ValueError(f"unsupported act {act!r}")


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
    sc = rstd.repeat_interleave(cpg, dim=1)[:, None, :] * scale.float()
    sh = bias.float() - mean.repeat_interleave(cpg, dim=1)[:, None, :] * sc
    z = xf.reshape(b, -1, c) * sc + sh
    if act == "silu":
        z = z * torch.sigmoid(z)
    return z.to(x.dtype).reshape(x.shape), mean, rstd


def _splits(device: torch.device, b: int, l: int) -> int:
    """Row splits per sample: enough blocks for ~4 per SM, at least 16
    rows a block (see csrc/groupnorm.cu)."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _sm_count:
        _sm_count[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    want = math.ceil(4 * _sm_count[idx] / b)
    return max(1, min(want, l // 16))


def _launch(x, scale, bias, groups, eps, act, return_stats):
    code = _native.dtype_code(x.dtype, "group_norm_act")
    if not x.is_contiguous():
        raise ValueError("group_norm_act: x must be contiguous (B, ..., C)")
    c = x.shape[-1]
    for name, t in (("scale", scale), ("bias", bias)):
        if (t.device != x.device or t.dtype != torch.float32
                or t.shape != (c,) or not t.is_contiguous()):
            raise ValueError(
                f"group_norm_act: {name} must be contiguous float32 ({c},) "
                f"on {x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    b = x.shape[0]
    l = x.numel() // (b * c)
    lib = _native.library()
    splits = _splits(x.device, b, l)
    y = torch.empty_like(x)
    # one f32 scratch allocation: mean and rstd (B, G), then the two
    # (B, splits, C) partial-sum workspaces; pointers into it by offset
    n_stat, n_ws = b * groups, b * splits * c
    scratch = torch.empty(2 * (n_stat + n_ws), device=x.device,
                          dtype=torch.float32)
    p = scratch.data_ptr()
    err = lib.vf_group_norm_act_fwd(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        p, p + 4 * n_stat, p + 8 * n_stat, p + 8 * n_stat + 4 * n_ws,
        b, l, c, groups, splits, float(eps), _ACTS[act], code,
        _native.stream_ptr(x.device))
    _native.check(err, "group_norm_act")
    group_norm_act.launches += 1
    if not return_stats:
        return y, None, None
    stats = scratch[:2 * n_stat].view(2, b, groups)
    return y, stats[0], stats[1]


def group_norm_act(x, scale, bias, *, groups, eps=1e-5, act="none",
                   return_stats=False):
    """GroupNorm over the trailing channel axis of ``x`` (B, ..., C),
    per sample over all other axes, then optional SiLU (``act="silu"``).

    ``x`` is bf16 or f32 and contiguous (NHWC, or the (B, H*W, C) rows of
    a channels_last NCHW tensor); ``scale``/``bias`` are (C,) f32.
    Returns y in x's dtype, plus (mean, rstd) (B, G) f32 when
    ``return_stats``.  CUDA tensors launch kernel K1; CPU tensors run the
    plain version."""
    _check_args(x, groups, act)
    if x.is_cuda:
        y, mean, rstd = _launch(x, scale, bias, groups, eps, act,
                                return_stats)
    elif x.device.type == "cpu":
        y, mean, rstd = group_norm_act_reference(
            x, scale, bias, groups=groups, eps=eps, act=act)
    else:
        raise ValueError(f"group_norm_act: unsupported device {x.device}")
    return (y, mean, rstd) if return_stats else y


group_norm_act.launches = 0
