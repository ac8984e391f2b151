"""Dense spatial self-attention: forward kernel K3, backward kernel K5,
their plain versions.

``spatial_self_attention(q, k, v, scale)`` is the counterpart of
``viewfusion_tpu.ops.attention.spatial_self_attention``: single-head
``softmax(q k^T * scale) v`` over (B, S, C) tokens with f32 math and an
f32 result.  On CUDA tensors the forward launches ``csrc/attention.cu``;
on CPU tensors it runs :func:`spatial_self_attention_reference`.  It is
differentiable on both devices.  The backward is chosen by
:func:`backward_route` from what the input shows: bf16 CUDA tensors with
heads of 64 (the DiT's and ADM's) launch K5 (``csrc/attention_bwd.cu``,
:func:`attention_backward`); everything else (the UNet's single heads of
192 and 320 channels, f32, the CPU) runs the closed form in plain
PyTorch with S and P recomputed in f32, as the JAX op's custom VJP
(``_attn_bwd``) leaves it to XLA.  Counters: ``k5.launches`` and
``attn_bwd.closed_form_calls``.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from viewfusion_tpu_torch import _native, tracing

__all__ = ["spatial_self_attention", "spatial_self_attention_reference",
           "spatial_self_attention_backward", "attention_plan",
           "attention_backward", "attention_backward_plan", "backward_route"]


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


# K5 (csrc/attention_bwd.cu): heads of 64, tiles of 64 queries x 64 keys,
# one warpgroup a block (the C entry sets and checks each pass's shared
# memory)
_K5_HEAD = 64
_K5_TILE = 64


def attention_backward_plan(b: int, s: int, c: int) -> dict:
    """Work and scratch of K5 for (B, S, C): ``tiles`` tiles of 64
    queries (and as many of 64 keys) a row, the last ragged where 64
    does not divide S; each of the three passes (softmax statistics and
    g's planes, dK and dV, dQ) launches one block per (row, tile),
    ``blocks`` in all.  Scratch shapes: g split into bf16 planes (hi, mid, lo),
    each tile's m, 1/l and D, and its mark (nonzero where g has bits
    below bf16 there)."""
    if c != _K5_HEAD:
        raise ValueError(f"attention_backward: K5 takes heads of "
                         f"{_K5_HEAD} channels, got {c}")
    tiles = -(-s // _K5_TILE)
    return {"tiles": tiles, "blocks": b * tiles,
            "planes": (3, b, s, c), "stats": (b, tiles, 3, _K5_TILE),
            "marks": (b, tiles)}


def backward_route(device_type: str, c: int, dtype) -> str:
    """Which backward ``_Attention`` runs: ``"k5"`` for bf16 CUDA tensors
    with heads of 64 channels, else ``"closed_form"``."""
    if device_type == "cuda" and c == _K5_HEAD and dtype == torch.bfloat16:
        return "k5"
    return "closed_form"


def _launch_backward(q, k, v, g, scale, plan):
    if not q.is_cuda:
        raise ValueError("attention_backward: K5 needs CUDA tensors")
    b, s, c = q.shape
    lib = _native.library()
    dq, dk, dv = (torch.empty((b, s, c), device=q.device,
                              dtype=torch.bfloat16) for _ in range(3))
    planes = torch.empty(plan["planes"], device=q.device,
                         dtype=torch.bfloat16)
    stats = torch.empty(plan["stats"], device=q.device, dtype=torch.float32)
    marks = torch.empty(plan["marks"], device=q.device, dtype=torch.int32)
    err = lib.vf_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), planes.data_ptr(),
        stats.data_ptr(), marks.data_ptr(), b, s, c, q.stride(0),
        q.stride(1), float(scale), _native.stream_ptr(q.device))
    _native.check(err, "attention_backward")
    return dq, dk, dv


def attention_backward(q, k, v, g, scale):
    """K5: the gradients (dq, dk, dv), bf16, of the attention for bf16 q,
    k, v (B, S, 64) on the card, sharing shape, strides (channels
    contiguous, rows and rows of the batch at multiples of 8) and device,
    and the upstream gradient ``g`` (B, S, 64), taken as f32.  Raises on
    what the kernel does not take."""
    for name, t in (("k", k), ("v", v)):
        if (t.shape != q.shape or t.dtype != q.dtype
                or t.stride() != q.stride() or t.device != q.device):
            raise ValueError(f"attention_backward: {name} must match q in "
                             f"shape, dtype, strides and device")
    if q.dim() != 3 or g.shape != q.shape or g.device != q.device:
        raise ValueError(f"attention_backward: q and g must be one (B, S, "
                         f"C) shape on one device, got {tuple(q.shape)} and "
                         f"{tuple(g.shape)}")
    if q.dtype != torch.bfloat16:
        raise ValueError(f"attention_backward: K5 takes bfloat16 q, k, v, "
                         f"got {q.dtype}")
    if q.stride(-1) != 1 or q.stride(0) % 8 or q.stride(1) % 8:
        raise ValueError("attention_backward: the channel axis must be "
                         "contiguous and rows start at multiples of 8 "
                         "elements")
    plan = attention_backward_plan(*q.shape)
    grads = _launch_backward(q, k, v, g.float().contiguous(), scale, plan)
    attention_backward.launches += 1
    return grads


def _forward(q, k, v, scale):
    if q.is_cuda:
        return _launch(q, k, v, scale)
    if q.device.type == "cpu":
        return spatial_self_attention_reference(q, k, v, scale)
    raise ValueError(f"spatial_self_attention: unsupported device {q.device}")


class _Attention(torch.autograd.Function):
    """K3 forward (plain version on the CPU); K5 or the closed form
    backward, as :func:`backward_route` says."""

    closed_form_calls = 0

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _forward(q, k, v, scale)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        if backward_route(q.device.type, q.shape[-1], q.dtype) == "k5":
            return (*attention_backward(q, k, v, g, ctx.scale), None)
        _Attention.closed_form_calls += 1
        return (*spatial_self_attention_backward(q, k, v, g, ctx.scale),
                None)


def spatial_self_attention(q, k, v, scale):
    """Dense self-attention over (B, S, C) tokens, f32 result.

    q, k and v share shape, dtype (bf16 or f32) and strides; rows may be
    strided (column slices of one (B, S, 3C) qkv buffer) but channels
    must be contiguous.  CUDA tensors launch kernel K3; CPU tensors run
    the plain version.  Where autograd records, the call goes through an
    autograd Function whose backward is K5 or the closed form
    (:func:`backward_route`)."""
    if q.dim() != 3:
        raise ValueError(
            f"q, k, v must be (B, S, C), got shape {tuple(q.shape)}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Attention.apply(q, k, v, scale)
    return _forward(q, k, v, scale)


spatial_self_attention.launches = 0
attention_backward.launches = 0
tracing.watch("k3.launches", spatial_self_attention, "launches")
tracing.watch("k5.launches", attention_backward, "launches")
tracing.watch("attn_bwd.closed_form_calls", _Attention, "closed_form_calls")
