"""Dense spatial self-attention: forward kernel K3, its plain version and
the closed-form backward.

``spatial_self_attention(q, k, v, scale)`` is the counterpart of
``viewfusion_tpu.ops.attention.spatial_self_attention``: single-head
``softmax(q k^T * scale) v`` over (B, S, C) tokens with f32 math and an
f32 result.  On CUDA tensors the forward launches ``csrc/attention.cu``;
on CPU tensors it runs :func:`spatial_self_attention_reference`.  It is
differentiable on both devices: the backward is the closed-form gradient
in plain PyTorch with S and P recomputed in f32, as the JAX op's custom
VJP (``_attn_bwd``) leaves it to XLA.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from viewfusion_tpu_torch import _native

__all__ = ["spatial_self_attention", "spatial_self_attention_reference",
           "spatial_self_attention_backward", "attention_plan"]


def _probs(qf, kf, scale):
    return torch.softmax(torch.matmul(qf, kf.transpose(1, 2)) * scale, dim=-1)


def spatial_self_attention_reference(q, k, v, scale):
    """Plain PyTorch attention in f32 (softmax over the key axis)."""
    return torch.matmul(_probs(q.float(), k.float(), scale), v.float())


def spatial_self_attention_backward(q, k, v, g, scale):
    """Gradients (dq, dk, dv) of the attention for the f32 upstream
    gradient ``g`` (B, S, C), each in its input's dtype; P is recomputed
    in f32 rather than kept from the forward."""
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    p = _probs(qf, kf, scale)
    dv = torch.matmul(p.transpose(1, 2), gf)
    dp = torch.matmul(gf, vf.transpose(1, 2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * scale
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(1, 2), qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# K3's tensor-core path: a block (one warpgroup) owns 64 queries of a row
# and one of `parts` slices of the output channels (csrc/attention.cu)
_QUERIES_PER_BLOCK = 64
_MAX_PART_CHANNELS = 192


def attention_plan(b: int, s: int, c: int) -> dict:
    """Work units of K3's bf16 (wgmma) path for (B, S, C): ``q_tiles``
    blocks of 64 queries per row, ``parts`` blocks along the output
    channels, each owning ``part_width`` channels (a multiple of 8:
    16-byte rows), ``blocks`` in all.  Two parts only where one
    block's f32 output accumulator would pass 192 channels (C = 320 at
    the mid block): each part fetches all of K again."""
    q_tiles = -(-s // _QUERIES_PER_BLOCK)
    parts = 2 if c > _MAX_PART_CHANNELS else 1
    per_part = -(-c // parts)
    part_width = -(-per_part // 8) * 8
    return {"q_tiles": q_tiles, "parts": parts, "part_width": part_width,
            "blocks": b * q_tiles * parts}


def _launch(q, k, v, scale):
    code = _native.dtype_code(q.dtype, "spatial_self_attention")
    for name, t in (("k", k), ("v", v)):
        if (t.shape != q.shape or t.dtype != q.dtype
                or t.stride() != q.stride() or t.device != q.device):
            raise ValueError(
                f"spatial_self_attention: {name} must match q in shape, "
                f"dtype, strides and device")
    if q.stride(-1) != 1:
        raise ValueError("spatial_self_attention: the channel axis must be "
                         "contiguous")
    b, s, c = q.shape
    lib = _native.library()
    parts = attention_plan(b, s, c)["parts"]
    out = torch.empty((b, s, c), device=q.device, dtype=torch.float32)
    err = lib.vf_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, c,
        q.stride(0), q.stride(1), float(scale), parts, code,
        _native.stream_ptr(q.device))
    _native.check(err, "spatial_self_attention")
    spatial_self_attention.launches += 1
    return out


def _forward(q, k, v, scale):
    if q.is_cuda:
        return _launch(q, k, v, scale)
    if q.device.type == "cpu":
        return spatial_self_attention_reference(q, k, v, scale)
    raise ValueError(f"spatial_self_attention: unsupported device {q.device}")


class _Attention(torch.autograd.Function):
    """K3 forward (plain version on the CPU), closed-form backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _forward(q, k, v, scale)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*spatial_self_attention_backward(q, k, v, g, ctx.scale),
                None)


def spatial_self_attention(q, k, v, scale):
    """Dense self-attention over (B, S, C) tokens, f32 result.

    q, k and v share shape, dtype (bf16 or f32) and strides; rows may be
    strided (column slices of one (B, S, 3C) qkv buffer) but channels
    must be contiguous.  CUDA tensors launch kernel K3; CPU tensors run
    the plain version.  Where autograd records, the call goes through an
    autograd Function with the closed-form backward."""
    if q.dim() != 3:
        raise ValueError(
            f"q, k, v must be (B, S, C), got shape {tuple(q.shape)}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Attention.apply(q, k, v, scale)
    return _forward(q, k, v, scale)


spatial_self_attention.launches = 0
