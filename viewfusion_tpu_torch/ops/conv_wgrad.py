"""Weight gradient of a stride-1 SAME 3x3 conv: kernel K4, its plain
version, and the ``conv3x3`` op around it.

``conv3x3_wgrad(x, g)`` is the counterpart of
``viewfusion_tpu.ops.conv_wgrad.conv3x3_wgrad``, at its contract and
layout: x (B, H, W, Cin) the conv input and g (B, H, W, Cout) the output
cotangent, NHWC, bf16 or f32, give dW (3, 3, Cin, Cout) (HWIO) in f32, the
sums in f32 whatever the input dtype.  On CUDA tensors it launches
``csrc/conv_wgrad.cu`` (K4); on CPU tensors it runs
:func:`conv3x3_wgrad_reference`.

``conv3x3(x, weight, bias=None, impl=...)`` is the counterpart of the JAX
custom-VJP ``conv3x3``, in PyTorch's layout: x (B, Cin, H, W) in any
memory format (the UNet's are channels_last, whose NHWC view is free),
weight (Cout, Cin, 3, 3).  The forward is ``F.conv2d(x, weight, bias,
padding=1)``: the JAX forward is an XLA conv outside Pallas.  The backward
takes dx (and the bias gradient) from the library's data gradient and dW
from K4 cast to the weight's dtype (``impl="kernel"``, JAX's "pallas" and
"pallas-interpret": the plain version on a CPU tensor), or all of them
from the library (``impl="library"``, JAX's "xla").
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from viewfusion_tpu_torch import _native, tracing

__all__ = ["conv3x3_wgrad", "conv3x3_wgrad_reference", "conv3x3",
           "wgrad_plan"]

_IMPLS = ("library", "kernel")


def _check_shapes(x: torch.Tensor, g: torch.Tensor) -> None:
    if x.dim() != 4 or g.dim() != 4 or x.shape[:3] != g.shape[:3]:
        raise ValueError(
            f"conv3x3_wgrad: x (B, H, W, Cin) and g (B, H, W, Cout) must "
            f"share B, H, W; got {tuple(x.shape)} and {tuple(g.shape)}")


def conv3x3_wgrad_reference(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch dW (3, 3, Cin, Cout) f32: per tap (di, dj), the f32
    product of x shifted by (di - 1, dj - 1) (zero-padded) with g, summed
    over (B, H, W).  bf16 inputs widen to f32 exactly first."""
    _check_shapes(x, g)
    b, h, w, cin = x.shape
    cout = g.shape[3]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))  # (B, H+2, W+2, Cin)
    gf = g.float().reshape(-1, cout)
    taps = [xp[:, di:di + h, dj:dj + w].reshape(-1, cin).t() @ gf
            for di in range(3) for dj in range(3)]
    return torch.stack(taps).reshape(3, 3, cin, cout)


# K4's work split (csrc/conv_wgrad.cu): chunks of about 128 pixels (TR
# image rows x TW columns) summed in order by `splits` blocks per output
# tile, the splits summed in a second pass
_CHUNK_PIXELS = 128
_MAX_CHUNK_W = 64
_WG_TILE = 64      # wgmma path: Cin and Cout per block
_F32_TILE = 32     # f32 path: Cin and Cout per block


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def wgrad_plan(b: int, h: int, w: int, cin: int, cout: int, dtype,
               sm_count: int) -> dict:
    """K4's path and work split for x (B, H, W, Cin), g (B, H, W, Cout).

    ``path``: "wgmma" (bf16 with Cin and Cout multiples of 8), "mma"
    (bf16 with ragged channels) or "f32".  Chunks are ``tr`` x ``tw``
    pixels (``n_chunks`` in all); ``splits`` blocks per output tile
    (``tiles``) sum ``per_split`` consecutive chunks each.  The wgmma
    path wants TW = 8 with TR even, or TW a multiple of 16 (a 16-pixel
    k-slice never crosses an image row), and about one block per SM; the
    others TR * TW a multiple of 16 and two blocks per SM."""
    wgmma = dtype == torch.bfloat16 and cin % 8 == 0 and cout % 8 == 0
    if wgmma:
        path = "wgmma"
        tw = 8 if w <= 8 else min(_MAX_CHUNK_W, _cdiv(w, 16) * 16)
        tr = _CHUNK_PIXELS // tw
        tr = min(tr, _cdiv(h, 2) * 2) if tw == 8 else min(tr, h)
        tiles = _cdiv(cin, _WG_TILE) * _cdiv(cout, _WG_TILE)
        want = max(1, sm_count // tiles)
    else:
        path = "mma" if dtype == torch.bfloat16 else "f32"
        tw = min(_MAX_CHUNK_W, _cdiv(w, 8) * 8)
        tr = _CHUNK_PIXELS // tw
        if (tr * tw) % 16:
            tr -= 1  # TW = 8 (mod 16) needs an even TR
        tr = max(1, min(tr, _cdiv(h, 2) * 2))
        if path == "mma":
            wm = 1 if cin <= 16 else (2 if cin <= 32 else 4)
            wn = 1 if cout <= 16 else 2
            tiles = _cdiv(cin, 16 * wm) * _cdiv(cout, 16 * wn)
        else:
            tiles = _cdiv(cin, _F32_TILE) * _cdiv(cout, _F32_TILE)
        want = _cdiv(2 * sm_count, tiles)
    n_chunks = b * _cdiv(h, tr) * _cdiv(w, tw)
    per_split = _cdiv(n_chunks, min(want, n_chunks))
    return {"path": path, "tr": tr, "tw": tw, "tiles": tiles,
            "n_chunks": n_chunks, "splits": _cdiv(n_chunks, per_split),
            "per_split": per_split}


def _launch(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    code = _native.dtype_code(x.dtype, "conv3x3_wgrad")
    if g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"conv3x3_wgrad: g must match x in dtype and "
                         f"device, got {g.dtype} on {g.device}")
    if not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError("conv3x3_wgrad: x and g must be contiguous NHWC")
    b, h, w, cin = x.shape
    cout = g.shape[3]
    shape = (b, h, w, cin, cout)
    plan = wgrad_plan(*shape, x.dtype, _native.sm_count(x.device))
    splits = plan["splits"]
    dw = torch.empty((3, 3, cin, cout), device=x.device, dtype=torch.float32)
    ws = (torch.empty(splits * dw.numel(), device=x.device,
                      dtype=torch.float32) if splits > 1 else None)
    err = _native.library().vf_conv3x3_wgrad(
        x.data_ptr(), g.data_ptr(), dw.data_ptr(),
        None if ws is None else ws.data_ptr(), *shape, plan["tr"],
        plan["tw"], splits, code, _native.stream_ptr(x.device))
    _native.check(err, "conv3x3_wgrad")
    conv3x3_wgrad.launches += 1
    return dw


def conv3x3_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dW (3, 3, Cin, Cout) f32 of a stride-1 SAME 3x3 NHWC conv.

    ``x`` (B, H, W, Cin) is the conv input and ``g`` (B, H, W, Cout) the
    output cotangent, contiguous, of one dtype (bf16 or f32).  CUDA
    tensors launch kernel K4; CPU tensors run the plain version."""
    _check_shapes(x, g)
    if x.is_cuda:
        return _launch(x, g)
    if x.device.type == "cpu":
        return conv3x3_wgrad_reference(x, g)
    raise ValueError(f"conv3x3_wgrad: unsupported device {x.device}")


def _nhwc(t: torch.Tensor, counter: str) -> torch.Tensor:
    """The NHWC rows of an NCHW tensor: a free view of a channels_last
    tensor; any other layout is copied, and the copy counted."""
    rows = t.permute(0, 2, 3, 1)
    if not rows.is_contiguous():
        rows = rows.contiguous()
        setattr(conv3x3, counter, getattr(conv3x3, counter) + 1)
    return rows


class _Conv3x3(torch.autograd.Function):
    """Library forward; backward: library dx and bias gradient, dW from
    K4 (``impl="kernel"``) or the library (``impl="library"``)."""

    @staticmethod
    def forward(ctx, x, weight, bias, impl):
        ctx.save_for_backward(x, weight)
        ctx.impl, ctx.has_bias = impl, bias is not None
        return F.conv2d(x, weight, bias, padding=1)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        library_w = need_w and ctx.impl == "library"
        dx, dw, db = torch.ops.aten.convolution_backward(
            g, x, weight, [weight.shape[0]] if ctx.has_bias else None,
            [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
            [need_x, library_w, need_b and ctx.has_bias])
        if need_w and not library_w:
            dw = conv3x3_wgrad(_nhwc(x, "input_copies"),
                               _nhwc(g, "grad_copies"))
            dw = dw.permute(3, 2, 0, 1).to(weight.dtype).contiguous()
        return dx, dw, db, None


def conv3x3(x: torch.Tensor, weight: torch.Tensor, bias=None,
            impl: str = "library") -> torch.Tensor:
    """Stride-1 SAME 3x3 conv, x (B, Cin, H, W), weight (Cout, Cin, 3, 3),
    optional bias (Cout,).  ``impl`` selects the weight gradient:
    "kernel" (K4 on CUDA, its plain version on the CPU) or "library"."""
    if impl not in _IMPLS:
        raise ValueError(f"conv3x3: impl must be one of {_IMPLS}, got "
                         f"{impl!r}")
    if weight.dim() != 4 or tuple(weight.shape[2:]) != (3, 3):
        raise ValueError(f"conv3x3: weight must be (Cout, Cin, 3, 3), got "
                         f"{tuple(weight.shape)}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, weight, bias)):
        return _Conv3x3.apply(x, weight, bias, impl)
    return F.conv2d(x, weight, bias, padding=1)


conv3x3_wgrad.launches = 0
# conv inputs and upstream gradients that were not channels_last and were
# copied to NHWC rows before K4
conv3x3.input_copies = 0
conv3x3.grad_copies = 0
tracing.watch("k4.launches", conv3x3_wgrad, "launches")
tracing.watch("conv3x3.input_copies", conv3x3, "input_copies")
tracing.watch("conv3x3.grad_copies", conv3x3, "grad_copies")
