"""ADM denoiser in PyTorch: the UNet of Dhariwal & Nichol, "Diffusion
Models Beat GANs on Image Synthesis" (arXiv 2105.05233), as
``guided_diffusion/unet.py`` builds it with scale-shift norm and up/down
ResBlocks, under ViewFusion's call contract: ``forward(x, angle,
noise_level)`` takes NHWC ``x`` (B, H, W, in_channel), ``angle`` (B,) and
``noise_level`` (B,) and returns an f32 NHWC (B, H, W, out_channel), so
:class:`ViewFusion` composes it like the UNet and the DiT.

Layers, with ``guided_diffusion``'s ``state_dict`` names:

  * ``time_embed``: ViewFusion's conditioning in place of ADM's timestep
    and class embeddings: the WaveGrad encodings of the noise level and
    of the angle (``model_channels // 2`` each), then Linear(mc, 4 mc),
    SiLU, Linear(4 mc, 4 mc);
  * ``input_blocks``: a 3x3 stem, then per level ``num_res_blocks``
    ResBlocks (each followed by an attention block where the resolution
    is in ``attention_resolutions``) and, below the last level, a
    ResBlock that halves the resolution;
  * ``middle_block``: ResBlock, attention, ResBlock;
  * ``output_blocks``: per level ``num_res_blocks + 1`` ResBlocks on the
    skip concatenations (with attention as above), the last of each
    level above the first followed by a ResBlock that doubles the
    resolution;
  * ``out``: GroupNorm + SiLU, then a zero-initialised 3x3 conv.

A ResBlock is ``in_layers`` (GroupNorm 32 + SiLU, then, in an up/down
block, a nearest 2x upsample or a 2x2 average pool of both the branch
and the skip, then a 3x3 conv), ``emb_layers`` (SiLU, Linear(4 mc, 2 C))
and ``out_layers``: AdaGN, ``GN(h) * (1 + scale) + shift`` with scale and
shift from ``emb_layers``, then SiLU, dropout and a zero-initialised 3x3
conv; a 1x1 ``skip_connection`` where the width changes.  AdaGN folds
``(1 + scale, shift)`` into the GroupNorm's affine per (sample, channel)
(``gamma * (1 + scale)``, ``beta * (1 + scale) + shift``, in f32), so the
norm, the scale-shift and the SiLU are one call of
:func:`group_norm_act` (kernel K1 on CUDA, its backward K2).  An
attention block is GroupNorm 32, then :class:`MHAttention` (the DiT's:
``qkv`` with bias, heads of ``num_head_channels``, each through kernel
K3; its channel split ``which * C + head * hd + d`` is ADM's
``use_new_attention_order``), whose zero-initialised ``proj`` is ADM's
``proj_out``, plus the residual.

Precision is ADM's own mixed precision, with bf16 (the compute dtype)
where ADM's ``convert_to_fp16`` puts fp16: the ``input_blocks``,
``middle_block`` and ``output_blocks`` convolve and project in the
compute dtype, while the conditioning (``time_embed`` and every
ResBlock's ``emb_layers``, Linear layers that ADM keeps in float32) and
the ``out`` head (ADM casts ``h`` back to float32 before it) run in f32;
the AdaGN fold is f32.  Layout and the rest follow the port's UNet
(``models/unet.py``): NCHW in ``channels_last`` memory inside, weights
cast to each layer's dtype per call, f32 GroupNorm statistics, f32
attention cast back, an f32 output.  A fresh ADM is initialised as the
port's other denoisers (lecun-normal kernels, zero biases), with ADM's
zero modules zeroed.  ``remat=True`` recomputes each ResBlock and
attention block in the backward (``torch.utils.checkpoint``).  Dropout
follows the UNet's contract: on only in a forward given ``dropout=`` (a
generator or a dict of masks by module name, ``<block>.out_layers.2``),
each ResBlock's NHWC keep mask drawn before the block runs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from viewfusion_tpu_torch.config import ADMConfig
from viewfusion_tpu_torch.models.dit import MHAttention
from viewfusion_tpu_torch.models.unet import (Conv2d, Dropout, GroupNormAct,
                                              Linear, _init_like_flax,
                                              positional_encoding)
from viewfusion_tpu_torch.ops.groupnorm import group_norm_act

__all__ = ["ADM", "ADMConfig"]

_GROUPS = 32


class AdaGroupNorm(GroupNormAct):
    """GroupNorm 32 + SiLU whose affine is scaled and shifted per sample:
    ``silu(GN(x) * (1 + scale) + shift)`` for (B, C) ``scale`` and
    ``shift``, one :func:`group_norm_act` call."""

    def forward(self, x, scale, shift):
        b, c, h, w = x.shape
        s = 1.0 + scale.float()
        rows = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
        y = group_norm_act(rows, self.weight * s,
                           self.bias * s + shift.float(),
                           groups=self.num_groups, eps=self.eps, act=self.act)
        return y.view(b, h, w, c).permute(0, 3, 1, 2)


class ResBlock(nn.Module):
    """ADM's ResBlock with scale-shift norm; ``up``/``down`` resample the
    branch and the skip between the first norm and the first conv.  The
    conditioning ``emb`` is f32, and so are the scale and shift."""

    def __init__(self, channels: int, emb_channels: int, out_channels: int,
                 dropout: float, up: bool = False, down: bool = False):
        super().__init__()
        self.up, self.down = up, down
        self.in_layers = nn.Sequential(
            GroupNormAct(_GROUPS, channels, act="silu"),
            nn.Identity(),  # SiLU, fused into in_layers.0
            Conv2d(channels, out_channels, 3, padding=1))
        self.emb_layers = nn.Sequential(
            nn.SiLU(), Linear(emb_channels, 2 * out_channels))
        self.out_layers = nn.Sequential(
            AdaGroupNorm(_GROUPS, out_channels, act="silu"),
            nn.Identity(),  # SiLU, fused into out_layers.0
            Dropout(dropout),
            Conv2d(out_channels, out_channels, 3, padding=1))
        self.skip_connection = (nn.Identity() if out_channels == channels
                                else Conv2d(channels, out_channels, 1))

    def _resample(self, h):
        if self.up:
            return F.interpolate(h, scale_factor=2, mode="nearest")
        if self.down:
            return F.avg_pool2d(h, 2)
        return h

    def forward(self, x, emb, mask=None):
        h = self._resample(self.in_layers[0](x))
        x = self._resample(x)
        h = self.in_layers[2](h)
        scale, shift = self.emb_layers(emb).chunk(2, dim=1)
        h = self.out_layers[2](self.out_layers[0](h, scale, shift), mask)
        return self.skip_connection(x) + self.out_layers[3](h)


class AttentionBlock(nn.Module):
    """GroupNorm 32, multi-head self-attention over the H*W tokens, the
    residual."""

    def __init__(self, channels: int, head_channels: int):
        super().__init__()
        self.norm = GroupNormAct(_GROUPS, channels, act="none")
        self.attn = MHAttention(channels, channels // head_channels)

    def forward(self, x):
        b, c, h, w = x.shape
        rows = self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        out = self.attn(rows).view(b, h, w, c).permute(0, 3, 1, 2)
        return x + out


class ADM(nn.Module):
    """The ADM denoiser.

    ``forward(x, angle, noise_level, dropout=None)``: x (B, H, W,
    in_channel) NHWC, angle (B,), noise_level (B,) -> (B, H, W,
    out_channel) f32 NHWC; ``dropout`` turns dropout on (see the module
    docstring).
    """

    def __init__(self, config: ADMConfig, dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        cfg = self.config = config
        mc, heads = cfg.model_channels, cfg.num_head_channels
        if mc % 2 or any(mc * m % heads for m in cfg.channel_mult):
            raise ValueError(f"model_channels {mc} must be even and every "
                             f"width a multiple of {heads}")
        self.dtype, self.remat, self.dropout = dtype, remat, cfg.dropout
        emb = 4 * mc
        self.time_embed = nn.Sequential(Linear(mc, emb), nn.SiLU(),
                                        Linear(emb, emb))

        def res_block(cin, cout, **updown):
            return ResBlock(cin, emb, cout, cfg.dropout, **updown)

        def stage(cin, cout, res):
            """A ResBlock, with attention where ``res`` is listed."""
            layers = nn.ModuleList([res_block(cin, cout)])
            if res in cfg.attention_resolutions:
                layers.append(AttentionBlock(cout, heads))
            return layers

        ch = mc * cfg.channel_mult[0]
        res = cfg.image_size
        blocks = [nn.ModuleList([Conv2d(cfg.in_channel, ch, 3, padding=1)])]
        chans = [ch]
        last = len(cfg.channel_mult) - 1
        for level, mult in enumerate(cfg.channel_mult):
            for _ in range(cfg.num_res_blocks):
                blocks.append(stage(ch, mc * mult, res))
                ch = mc * mult
                chans.append(ch)
            if level != last:
                blocks.append(nn.ModuleList([res_block(ch, ch, down=True)]))
                chans.append(ch)
                res //= 2
        self.input_blocks = nn.ModuleList(blocks)
        self.middle_block = nn.ModuleList([
            res_block(ch, ch), AttentionBlock(ch, heads), res_block(ch, ch)])
        blocks = []
        for level, mult in reversed(list(enumerate(cfg.channel_mult))):
            for i in range(cfg.num_res_blocks + 1):
                layers = stage(ch + chans.pop(), mc * mult, res)
                ch = mc * mult
                if level and i == cfg.num_res_blocks:
                    layers.append(res_block(ch, ch, up=True))
                    res *= 2
                blocks.append(layers)
        self.output_blocks = nn.ModuleList(blocks)
        self.out = nn.Sequential(
            GroupNormAct(_GROUPS, ch, act="silu"),
            nn.Identity(),  # SiLU, fused into out.0
            Conv2d(mc * cfg.channel_mult[0], cfg.out_channel, 3, padding=1))
        _init_like_flax(self)
        with torch.no_grad():
            zero = [self.out[2]] + [m.out_layers[3] for m in self.modules()
                                    if isinstance(m, ResBlock)] + [
                m.attn.proj for m in self.modules()
                if isinstance(m, AttentionBlock)]
            for m in zero:
                m.weight.zero_()
                m.bias.zero_()

    def forward(self, x, angle, noise_level, dropout=None):
        mc = self.config.model_channels
        emb = self.time_embed(torch.cat([           # f32, as in ADM
            positional_encoding(noise_level.reshape(-1), mc // 2),
            positional_encoding(angle.reshape(-1), mc // 2),
        ], dim=-1))

        h = x.to(self.dtype).permute(0, 3, 1, 2)  # NCHW, channels_last
        h = h.contiguous(memory_format=torch.channels_last)
        feats = []
        for i, layers in enumerate(self.input_blocks):
            h = self._stage(layers, h, emb, f"input_blocks.{i}", dropout)
            feats.append(h)
        h = self._stage(self.middle_block, h, emb, "middle_block", dropout)
        for i, layers in enumerate(self.output_blocks):
            h = torch.cat([h, feats.pop()], dim=1)
            h = h.contiguous(memory_format=torch.channels_last)
            h = self._stage(layers, h, emb, f"output_blocks.{i}", dropout)
        out = self.out[2](self.out[0](h.float()))    # f32, as in ADM
        return out.permute(0, 2, 3, 1)

    def _stage(self, layers, h, emb, name: str, dropout):
        for j, layer in enumerate(layers):
            if isinstance(layer, ResBlock):
                args = (h, emb)
                if dropout is not None and self.dropout > 0:
                    args += (self._dropout_mask(layer, h, f"{name}.{j}",
                                                dropout),)
            elif isinstance(layer, AttentionBlock):
                args = (h,)
            else:           # the stem conv
                h = layer(h)
                continue
            if self.remat and torch.is_grad_enabled():
                h = checkpoint(layer, *args, use_reentrant=False)
            else:
                h = layer(*args)
        return h

    def _dropout_mask(self, layer: ResBlock, h, name: str,
                      dropout) -> torch.Tensor:
        """The keep mask of ``layer``'s dropout for its input ``h``, as the
        NCHW view of an NHWC bool tensor: drawn from the generator
        ``dropout``, or ``dropout[<module name>]``."""
        name += ".out_layers.2"
        b, _, hh, ww = h.shape
        if layer.up:
            hh, ww = 2 * hh, 2 * ww
        elif layer.down:
            hh, ww = hh // 2, ww // 2
        c = layer.out_layers[3].out_channels
        if isinstance(dropout, torch.Generator):
            mask = torch.rand((b, hh, ww, c), generator=dropout,
                              device=h.device) < 1.0 - self.dropout
        else:
            mask = torch.as_tensor(dropout[name]).to(h.device, torch.bool)
        return mask.permute(0, 3, 1, 2)
