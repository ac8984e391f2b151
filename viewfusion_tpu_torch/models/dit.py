"""DiT denoiser in PyTorch (counterpart of ``viewfusion_tpu/models/dit.py``).

A Diffusion Transformer (Peebles & Xie 2023, adaLN-Zero blocks) with the
UNet's call contract: ``forward(x, angle, noise_level)`` takes NHWC ``x``
(B, H, W, in_channel), ``angle`` (B,) and ``noise_level`` (B,) and
returns an f32 NHWC (B, H, W, out_channel), so :class:`ViewFusion`
composes either denoiser unchanged.

The forward follows the JAX module op by op: WaveGrad encodings of the
noise level and the angle (f32, then cast) into a two-layer conditioning
MLP; a p x p stride-p patchify conv plus a fixed 2-D sin-cos position
table; ``depth`` adaLN-Zero blocks whose multi-head attention runs per
head through :func:`spatial_self_attention` (kernel K3 on CUDA); a
modulated LayerNorm, the linear head and the pixel shuffle.

Precision follows flax's ``dtype=``: every Linear and the patchify conv
run in the compute dtype (weights cast to the input's dtype), so the
token stream, the modulations, the gates and the residual adds are in
the compute dtype; the LayerNorms take f32 statistics
(E[x^2] - E[x]^2, clamped at 0, epsilon 1e-6, no scale or bias) and
round once; GELU is the tanh approximation (flax's default); attention
returns f32 and is cast back to the stream's dtype; only the output is
f32.

A fresh DiT is initialised as flax initialises the JAX one (lecun-normal
kernels, zero biases) with zero kernels in ``adaLN``, ``final_adaLN``
and ``unpatchify``: it starts as the zero map.  ``remat=True`` recomputes
each block in the backward (``torch.utils.checkpoint``), as
``nn.remat`` does per block in JAX.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from viewfusion_tpu_torch.config import DiTConfig
from viewfusion_tpu_torch.models.unet import (Conv2d, Linear, _init_like_flax,
                                              positional_encoding)
from viewfusion_tpu_torch.ops.attention import spatial_self_attention

__all__ = ["DiT", "DiTConfig", "layer_norm"]

_LN_EPS = 1e-6


def _sincos_2d(h: int, w: int, dim: int) -> np.ndarray:
    """Fixed 2D sin-cos position embedding, (h*w, dim) f32."""
    assert dim % 4 == 0
    quarter = dim // 4
    omega = 1.0 / (10000 ** (np.arange(quarter) / quarter))
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    out = []
    for coords in (ys.reshape(-1), xs.reshape(-1)):
        ang = coords[:, None] * omega[None, :]
        out += [np.sin(ang), np.cos(ang)]
    return np.concatenate(out, axis=1).astype(np.float32)


def layer_norm(x: torch.Tensor) -> torch.Tensor:
    """Flax's ``LayerNorm(use_bias=False, use_scale=False)`` over the last
    axis: f32 mean and E[x^2] - E[x]^2 (clamped at 0), normalised in f32
    and rounded once to ``x``'s dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf * xf).mean(dim=-1, keepdim=True) - mu * mu).clamp_min(0.0)
    return ((xf - mu) * torch.rsqrt(var + _LN_EPS)).to(x.dtype)


class MHAttention(nn.Module):
    """Multi-head self-attention over (B, S, C) tokens, each head through
    :func:`spatial_self_attention`.  ``qkv`` output channel
    ``which * C + head * hd + d`` is q/k/v ``which`` of head ``head``."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x):
        b, s, c = x.shape
        heads = self.num_heads
        hd = c // heads
        # one copy into (3, B*heads, S, hd): q, k and v share strides
        qkv = self.qkv(x).view(b, s, 3, heads, hd).permute(2, 0, 3, 1, 4)
        qkv = qkv.reshape(3, b * heads, s, hd)
        out = spatial_self_attention(qkv[0], qkv[1], qkv[2],
                                     1.0 / math.sqrt(hd))
        out = out.view(b, heads, s, hd).permute(0, 2, 1, 3).reshape(b, s, c)
        return self.proj(out.to(x.dtype))


class DiTBlock(nn.Module):
    """adaLN-Zero transformer block: the six modulation vectors come from
    a zero-init Linear of SiLU(cond), so a fresh block is the identity."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int):
        super().__init__()
        self.adaLN = Linear(dim, 6 * dim)
        self.attn = MHAttention(dim, num_heads)
        self.fc1 = Linear(dim, mlp_ratio * dim)
        self.fc2 = Linear(mlp_ratio * dim, dim)

    def forward(self, x, cond):
        mod = self.adaLN(F.silu(cond))[:, None, :]
        sh1, sc1, g1, sh2, sc2, g2 = mod.chunk(6, dim=-1)
        h = layer_norm(x) * (1 + sc1) + sh1
        x = x + g1 * self.attn(h)
        h = layer_norm(x) * (1 + sc2) + sh2
        h = self.fc2(F.gelu(self.fc1(h), approximate="tanh"))
        return x + g2 * h


class DiT(nn.Module):
    """The transformer denoiser.

    ``forward(x, angle, noise_level)``: x (B, H, W, in_channel) NHWC,
    angle (B,), noise_level (B,) -> (B, H, W, out_channel) f32 NHWC.
    """

    def __init__(self, config: DiTConfig, dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        cfg = self.config = config
        if cfg.image_size % cfg.patch_size:
            raise ValueError(f"image_size {cfg.image_size} not divisible by "
                             f"patch_size {cfg.patch_size}")
        if cfg.hidden_size % cfg.num_heads:
            raise ValueError(f"hidden_size {cfg.hidden_size} not divisible "
                             f"by num_heads {cfg.num_heads}")
        self.dtype, self.remat = dtype, remat
        dim, p = cfg.hidden_size, cfg.patch_size
        self.cond_mlp = nn.Sequential(Linear(dim, 4 * dim), nn.SiLU(),
                                      Linear(4 * dim, dim))
        self.patchify = Conv2d(cfg.in_channel, dim, p, stride=p)
        grid = cfg.image_size // p
        self.register_buffer("pos", torch.from_numpy(
            _sincos_2d(grid, grid, dim)), persistent=False)
        self.blocks = nn.ModuleList(
            DiTBlock(dim, cfg.num_heads, cfg.mlp_ratio)
            for _ in range(cfg.depth))
        self.final_adaLN = Linear(dim, 2 * dim)
        self.unpatchify = Linear(dim, p * p * cfg.out_channel)
        _init_like_flax(self)
        with torch.no_grad():
            for m in [blk.adaLN for blk in self.blocks] + [
                    self.final_adaLN, self.unpatchify]:
                m.weight.zero_()

    def forward(self, x, angle, noise_level):
        cfg = self.config
        b, hh, ww, cin = x.shape
        if (hh, ww, cin) != (cfg.image_size, cfg.image_size, cfg.in_channel):
            raise ValueError(
                f"input {hh}x{ww}x{cin} != configured {cfg.image_size}x"
                f"{cfg.image_size}x{cfg.in_channel}")
        dim, p = cfg.hidden_size, cfg.patch_size
        gh, gw = hh // p, ww // p

        emb = torch.cat([
            positional_encoding(noise_level.reshape(-1), dim // 2),
            positional_encoding(angle.reshape(-1), dim // 2),
        ], dim=-1).to(self.dtype)
        cond = self.cond_mlp(emb)

        h = x.to(self.dtype).permute(0, 3, 1, 2)  # NCHW, channels_last
        tok = self.patchify(h.contiguous(memory_format=torch.channels_last))
        tok = tok.permute(0, 2, 3, 1).reshape(b, gh * gw, dim)
        tok = tok + self.pos.to(self.dtype)

        for blk in self.blocks:
            if self.remat and torch.is_grad_enabled():
                tok = checkpoint(blk, tok, cond, use_reentrant=False)
            else:
                tok = blk(tok, cond)

        mod = self.final_adaLN(F.silu(cond))[:, None, :]
        shift, scale = mod.chunk(2, dim=-1)
        tok = layer_norm(tok) * (1 + scale) + shift
        tok = self.unpatchify(tok)
        out = tok.view(b, gh, gw, p, p, cfg.out_channel)
        out = out.permute(0, 1, 3, 2, 4, 5).reshape(b, hh, ww, cfg.out_channel)
        return out.float()
