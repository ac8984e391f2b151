"""SR3-style denoising UNet in PyTorch (counterpart of
``viewfusion_tpu/models/unet.py``).

Module for module the JAX UNet (stem conv, per-scale ResnetBlocWithAttn
stacks with stride-2 Downsample, two mid blocks, skip-concat up blocks
with nearest Upsample, final GroupNorm/SiLU/conv Block), with the
reference repo's ``state_dict`` names (``downs.N``, ``block.0``/``block.3``,
``noise_level_mlp.0/2``, ``res_block``, ``attn.norm/qkv/out``), so the
published upstream ``denoise_fn.*`` weights load directly.

Layout: the public ``UNet.forward`` takes and returns NHWC, like the JAX
module.  Inside, tensors are NCHW in ``torch.channels_last`` memory: the
NHWC buffer viewed as NCHW costs no copy, cuDNN convolves it natively,
and its memory is exactly the (B, H*W, C) rows that the GroupNorm and
attention kernels read.

Precision follows the JAX policy: parameters are f32 unless cast with
:func:`cast_matmul_weights_` (serving; training keeps f32 master
parameters and casts them per call, as flax does); conv/linear inputs and
weights run in the compute dtype; the positional encoding is computed in
f32 and cast; GroupNorm statistics are f32 with output in the compute
dtype; attention returns f32 and is cast back before its output conv; the
UNet output is f32.

A fresh UNet is initialised as flax initialises the JAX one: lecun-normal
(truncated) conv and dense kernels, zero biases, GroupNorm scale one and
bias zero.  ``remat=True`` recomputes each ``ResnetBlocWithAttn`` in the
backward (``torch.utils.checkpoint``), as ``nn.remat`` does per block in
JAX.

Dropout (``dropout > 0``) follows the fused GroupNorm+SiLU of each
ResnetBlock's second Block and precedes its conv, as in JAX.  It is on
only in a forward given ``dropout=``: a ``torch.Generator`` to draw the
masks from, or a dict of masks by module name (tests feed JAX's).  Each
block's mask (NHWC, keep probability 1 - p) is drawn before the block
runs and passed into it, so a remat recomputation sees the same mask.
Without ``dropout=`` (eval, sampling, the packed loss) the forward is the
one without dropout.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from viewfusion_tpu_torch.config import UNetConfig
from viewfusion_tpu_torch.ops.attention import spatial_self_attention
from viewfusion_tpu_torch.ops.groupnorm import group_norm_act

__all__ = ["UNet", "Dropout", "positional_encoding", "cast_matmul_weights_"]


class Conv2d(nn.Conv2d):
    """Conv whose weights are cast to the input's dtype (flax ``dtype=``)."""

    def forward(self, x):
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, w, b)


class Linear(nn.Linear):
    """Linear whose weights are cast to the input's dtype."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


def cast_matmul_weights_(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Store conv/linear weights in ``dtype`` (once, instead of a cast per
    call) and 4-D weights channels_last; GroupNorm params stay f32."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            m.to(dtype)
            if isinstance(m, nn.Conv2d):
                m.weight.data = m.weight.data.contiguous(
                    memory_format=torch.channels_last)
    return module


def _init_like_flax(module: nn.Module) -> None:
    """Re-initialise conv/linear layers as flax's defaults do:
    ``lecun_normal`` kernels (a normal of variance 1/fan_in truncated at
    two standard deviations, rescaled by 1/0.8796 to keep that variance)
    and zero biases.  GroupNorm parameters start at ones and zeros."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()  # in * kh * kw
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            with torch.no_grad():
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std,
                                      b=2 * std)
                if m.bias is not None:
                    m.bias.zero_()


class GroupNormAct(nn.Module):
    """GroupNorm (+ fused SiLU) on a channels_last NCHW tensor through
    :func:`group_norm_act` (kernel K1 on CUDA).  Parameters ``weight`` /
    ``bias`` as in ``torch.nn.GroupNorm``, f32."""

    def __init__(self, num_groups: int, num_channels: int, act: str = "none",
                 eps: float = 1e-5):
        super().__init__()
        self.num_groups, self.act, self.eps = num_groups, act, eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x):
        b, c, h, w = x.shape
        rows = x.permute(0, 2, 3, 1).reshape(b, h * w, c)  # free if NHWC
        y = group_norm_act(rows, self.weight, self.bias,
                           groups=self.num_groups, eps=self.eps, act=self.act)
        return y.view(b, h, w, c).permute(0, 3, 1, 2)


def positional_encoding(level: torch.Tensor, dim: int) -> torch.Tensor:
    """WaveGrad positional encoding: (B,) -> (B, dim) f32 =
    concat(sin, cos) of level * 1e4^(-k/count), count = dim // 2."""
    count = dim // 2
    step = torch.arange(count, dtype=torch.float32, device=level.device) / count
    encoding = level.float()[:, None] * torch.exp(-math.log(1e4) * step[None, :])
    return torch.cat([torch.sin(encoding), torch.cos(encoding)], dim=-1)


class FeatureWiseAffine(nn.Module):
    """Additive conditioning injection (``noise_func.noise_func.0``)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.noise_func = nn.Sequential(Linear(in_channels, out_channels))

    def forward(self, x, noise_embed):
        return x + self.noise_func(noise_embed)[:, :, None, None]


class Dropout(nn.Module):
    """flax's ``nn.Dropout``: where the (NCHW view of an NHWC) ``mask``
    keeps an element, ``x / (1 - p)``, else 0; the identity without a
    mask."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x, mask=None):
        if mask is None:
            return x
        return torch.where(mask, x / (1.0 - self.p), 0.0).to(x.dtype)


class Block(nn.Module):
    """GroupNorm -> SiLU -> dropout -> 3x3 conv, as ``block.0`` ..
    ``block.3``; the norm and SiLU are one fused op."""

    def __init__(self, dim: int, dim_out: int, groups: int = 32,
                 dropout: float = 0.0):
        super().__init__()
        self.block = nn.Sequential(
            GroupNormAct(groups, dim, act="silu"),
            nn.Identity(),  # SiLU, fused into block.0
            Dropout(dropout),
            Conv2d(dim, dim_out, 3, padding=1),
        )

    def forward(self, x, mask=None):
        h = self.block[2](self.block[0](x), mask)
        return self.block[3](h)


class ResnetBlock(nn.Module):
    """Two Blocks with the conditioning added between them, plus a 1x1
    residual projection when the channel count changes."""

    def __init__(self, dim: int, dim_out: int, noise_dim: int,
                 norm_groups: int = 32, dropout: float = 0.0):
        super().__init__()
        self.noise_func = FeatureWiseAffine(noise_dim, dim_out)
        self.block1 = Block(dim, dim_out, groups=norm_groups)
        self.block2 = Block(dim_out, dim_out, groups=norm_groups,
                            dropout=dropout)
        self.res_conv = (Conv2d(dim, dim_out, 1) if dim != dim_out
                         else nn.Identity())

    def forward(self, x, time_emb, mask=None):
        h = self.block1(x)
        h = self.noise_func(h, time_emb)
        h = self.block2(h, mask)
        return h + self.res_conv(x)


class SelfAttention(nn.Module):
    """Single-head attention over the H*W tokens, with residual.  q, k and
    v stay column slices of the qkv conv output (no copy)."""

    def __init__(self, in_channel: int, norm_groups: int = 32):
        super().__init__()
        self.norm = GroupNormAct(norm_groups, in_channel, act="none")
        self.qkv = Conv2d(in_channel, in_channel * 3, 1, bias=False)
        self.out = Conv2d(in_channel, in_channel, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        qkv = self.qkv(self.norm(x))
        rows = qkv.permute(0, 2, 3, 1).reshape(b, h * w, 3 * c)
        q, k, v = rows[..., :c], rows[..., c:2 * c], rows[..., 2 * c:]
        o = spatial_self_attention(q, k, v, scale=1.0 / math.sqrt(c))
        o = o.view(b, h, w, c).permute(0, 3, 1, 2).to(x.dtype)
        return self.out(o) + x


class ResnetBlocWithAttn(nn.Module):
    def __init__(self, dim: int, dim_out: int, noise_dim: int,
                 norm_groups: int = 32, with_attn: bool = False,
                 dropout: float = 0.0):
        super().__init__()
        self.res_block = ResnetBlock(dim, dim_out, noise_dim, norm_groups,
                                     dropout)
        self.attn = (SelfAttention(dim_out, norm_groups) if with_attn
                     else None)

    def forward(self, x, time_emb, mask=None):
        x = self.res_block(x, time_emb, mask)
        return x if self.attn is None else self.attn(x)


class Downsample(nn.Module):
    """3x3 stride-2 conv."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = Conv2d(dim, dim, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    """Nearest 2x upsample (exactly the JAX double ``repeat``) + 3x3 conv."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = Conv2d(dim, dim, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class UNet(nn.Module):
    """The full denoiser.

    ``forward(x, angle, noise_level, dropout=None)``: x (B, H, W,
    in_channel) NHWC, angle (B,), noise_level (B,) -> (B, H, W,
    out_channel) f32 NHWC; ``dropout`` turns dropout on (see the module
    docstring).
    """

    def __init__(self, config: UNetConfig, dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        cfg = self.config = config
        self.dtype, self.remat = dtype, remat
        self.dropout = cfg.dropout
        inner = cfg.inner_channel
        groups = cfg.norm_groups
        if cfg.with_noise_level_emb:
            self.noise_level_mlp = nn.Sequential(
                Linear(inner, inner * 4), nn.SiLU(), Linear(inner * 4, inner))
        else:
            self.noise_level_mlp = None

        now_res = cfg.image_size
        downs = [Conv2d(cfg.in_channel, inner, 3, padding=1)]
        feat_channels = [inner]
        pre_channel = inner
        num_mults = len(cfg.channel_mults)
        for ind in range(num_mults):
            use_attn = now_res in cfg.attn_res
            channel_mult = inner * cfg.channel_mults[ind]
            for _ in range(cfg.res_blocks):
                downs.append(ResnetBlocWithAttn(
                    pre_channel, channel_mult, inner, groups, use_attn,
                    cfg.dropout))
                feat_channels.append(channel_mult)
                pre_channel = channel_mult
            if ind != num_mults - 1:
                downs.append(Downsample(pre_channel))
                feat_channels.append(pre_channel)
                now_res //= 2
        self.downs = nn.ModuleList(downs)
        self.mid = nn.ModuleList([
            ResnetBlocWithAttn(pre_channel, pre_channel, inner, groups, True,
                               cfg.dropout),
            ResnetBlocWithAttn(pre_channel, pre_channel, inner, groups,
                               False, cfg.dropout),
        ])
        ups = []
        for ind in reversed(range(num_mults)):
            use_attn = now_res in cfg.attn_res
            channel_mult = inner * cfg.channel_mults[ind]
            for _ in range(cfg.res_blocks + 1):
                ups.append(ResnetBlocWithAttn(
                    pre_channel + feat_channels.pop(), channel_mult, inner,
                    groups, use_attn, cfg.dropout))
                pre_channel = channel_mult
            if ind >= 1:
                ups.append(Upsample(pre_channel))
                now_res *= 2
        self.ups = nn.ModuleList(ups)
        self.final_conv = Block(pre_channel, cfg.out_channel, groups=groups)
        _init_like_flax(self)

    def forward(self, x, angle, noise_level, dropout=None):
        inner = self.config.inner_channel
        if self.noise_level_mlp is not None:
            t = torch.cat([
                positional_encoding(noise_level.reshape(-1), inner // 2),
                positional_encoding(angle.reshape(-1), inner // 2),
            ], dim=-1).to(self.dtype)
            t = self.noise_level_mlp(t)
        else:
            t = torch.zeros((x.shape[0], inner), dtype=self.dtype,
                            device=x.device)

        def block(layer, h, name):
            args = (h, t)
            if dropout is not None and self.dropout > 0:
                args += (self._dropout_mask(layer, h, name, dropout),)
            if self.remat and torch.is_grad_enabled():
                return checkpoint(layer, *args, use_reentrant=False)
            return layer(*args)

        h = x.to(self.dtype).permute(0, 3, 1, 2)  # NCHW, channels_last
        h = h.contiguous(memory_format=torch.channels_last)
        feats = []
        for i, layer in enumerate(self.downs):
            h = block(layer, h, f"downs.{i}") \
                if isinstance(layer, ResnetBlocWithAttn) else layer(h)
            feats.append(h)
        for i, layer in enumerate(self.mid):
            h = block(layer, h, f"mid.{i}")
        for i, layer in enumerate(self.ups):
            if isinstance(layer, ResnetBlocWithAttn):
                h = torch.cat([h, feats.pop()], dim=1)
                h = h.contiguous(memory_format=torch.channels_last)
                h = block(layer, h, f"ups.{i}")
            else:
                h = layer(h)
        out = self.final_conv(h)
        return out.permute(0, 2, 3, 1).float()

    def _dropout_mask(self, layer, h, name: str, dropout) -> torch.Tensor:
        """The keep mask of ``layer``'s dropout for its input ``h``, as the
        NCHW view of an NHWC bool tensor: drawn from the generator
        ``dropout``, or ``dropout[<module name>]``."""
        name += ".res_block.block2.block.2"
        b, _, hh, ww = h.shape
        c = layer.res_block.block2.block[3].out_channels
        if isinstance(dropout, torch.Generator):
            mask = torch.rand((b, hh, ww, c), generator=dropout,
                              device=h.device) < 1.0 - self.dropout
        else:
            mask = torch.as_tensor(dropout[name]).to(h.device, torch.bool)
        return mask.permute(0, 3, 1, 2)
