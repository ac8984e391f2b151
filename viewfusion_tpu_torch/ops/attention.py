"""Dense spatial self-attention forward: CUDA kernel K3 and its plain
version.

``spatial_self_attention(q, k, v, scale)`` is the counterpart of
``viewfusion_tpu.ops.attention.spatial_self_attention``: single-head
``softmax(q k^T * scale) v`` over (B, S, C) tokens with f32 math and an
f32 result.  On CUDA tensors it launches ``csrc/attention.cu``; on CPU
tensors it runs :func:`spatial_self_attention_reference`.
"""

from __future__ import annotations

import torch

from viewfusion_tpu_torch import _native

__all__ = ["spatial_self_attention", "spatial_self_attention_reference"]


def spatial_self_attention_reference(q, k, v, scale):
    """Plain PyTorch attention in f32 (softmax over the key axis)."""
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    return torch.matmul(torch.softmax(s, dim=-1), v.float())


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
    out = torch.empty((b, s, c), device=q.device, dtype=torch.float32)
    err = lib.vf_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, c,
        q.stride(0), q.stride(1), float(scale), code,
        _native.stream_ptr(q.device))
    _native.check(err, "spatial_self_attention")
    spatial_self_attention.launches += 1
    return out


def spatial_self_attention(q, k, v, scale):
    """Dense self-attention over (B, S, C) tokens, f32 result.

    q, k and v share shape, dtype (bf16 or f32) and strides; rows may be
    strided (column slices of one (B, S, 3C) qkv buffer) but channels
    must be contiguous.  CUDA tensors launch kernel K3; CPU tensors run
    the plain version."""
    if q.dim() != 3:
        raise ValueError(
            f"q, k, v must be (B, S, C), got shape {tuple(q.shape)}")
    if q.is_cuda:
        return _launch(q, k, v, scale)
    if q.device.type == "cpu":
        return spatial_self_attention_reference(q, k, v, scale)
    raise ValueError(f"spatial_self_attention: unsupported device {q.device}")


spatial_self_attention.launches = 0
