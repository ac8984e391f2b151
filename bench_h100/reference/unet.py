"""The ViewFusion UNet in plain float32 PyTorch, from the reference
repository's ``model/unet.py`` (SR3's denoiser as ViewFusion configures
it): a 3x3 stem, per scale ``res_blocks`` residual blocks (GroupNorm 32,
SiLU, 3x3 conv; the noise embedding added between the two convs; a 1x1
projection where the width changes), single-head self-attention with a
residual at the resolutions in ``attn_res``, stride-2 downsampling, two
middle blocks (the first with attention), skip concatenations, nearest 2x
upsampling with a 3x3 conv, and a GroupNorm-SiLU-conv head.  The noise
embedding is the WaveGrad encoding of the noise level and of the angle
(half the width each) through a Linear-SiLU-Linear MLP.

The parameters are a flat ``{name: tensor}`` dict with the reference's
``state_dict`` names, so the harness hands the same weights to the
program and to this function.  Tensors are NCHW inside; the entry takes
and returns NHWC.  ``param_specs`` lists every parameter's name, shape
and initial scale, in order."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench_h100.reference.precision import FLOAT32


def positional_encoding(level: torch.Tensor, dim: int) -> torch.Tensor:
    count = dim // 2
    step = torch.arange(count, dtype=torch.float32,
                        device=level.device) / count
    enc = level.float()[:, None] * torch.exp(-math.log(1e4) * step[None, :])
    return torch.cat([torch.sin(enc), torch.cos(enc)], dim=-1)


def _topology(cfg):
    """The module tree as (prefix, kind, args) in forward order."""
    inner, groups = cfg["inner_channel"], cfg.get("norm_groups", 32)
    now, mults = cfg["image_size"], cfg["channel_mults"]
    downs = [("downs.0", "conv", (cfg["in_channel"], inner, 3))]
    feats, pre = [inner], inner
    for ind, m in enumerate(mults):
        cm = inner * m
        for _ in range(cfg["res_blocks"]):
            downs.append((f"downs.{len(downs)}", "block",
                          (pre, cm, now in cfg["attn_res"])))
            feats.append(cm)
            pre = cm
        if ind != len(mults) - 1:
            downs.append((f"downs.{len(downs)}", "down", (pre,)))
            feats.append(pre)
            now //= 2
    mid = [("mid.0", "block", (pre, pre, True)),
           ("mid.1", "block", (pre, pre, False))]
    ups = []
    for ind in reversed(range(len(mults))):
        cm = inner * mults[ind]
        for _ in range(cfg["res_blocks"] + 1):
            ups.append((f"ups.{len(ups)}", "block",
                        (pre + feats.pop(), cm, now in cfg["attn_res"])))
            pre = cm
        if ind >= 1:
            ups.append((f"ups.{len(ups)}", "up", (pre,)))
            now *= 2
    return downs, mid, ups, pre, groups


def param_specs(cfg):
    """[(name, shape, kind)]: kind "kernel" (std 1/sqrt(fan_in)), "norm"
    (GroupNorm scale, about 1) or "bias" (about 0)."""
    inner = cfg["inner_channel"]
    specs = []

    def conv(p, cin, cout, k, bias=True):
        specs.append((f"{p}.weight", (cout, cin, k, k), "kernel"))
        if bias:
            specs.append((f"{p}.bias", (cout,), "bias"))

    def lin(p, cin, cout):
        specs.append((f"{p}.weight", (cout, cin), "kernel"))
        specs.append((f"{p}.bias", (cout,), "bias"))

    def norm(p, c):
        specs.append((f"{p}.weight", (c,), "norm"))
        specs.append((f"{p}.bias", (c,), "bias"))

    def block(p, cin, cout, attn):
        r = p + ".res_block"
        lin(r + ".noise_func.noise_func.0", inner, cout)
        norm(r + ".block1.block.0", cin)
        conv(r + ".block1.block.3", cin, cout, 3)
        norm(r + ".block2.block.0", cout)
        conv(r + ".block2.block.3", cout, cout, 3)
        if cin != cout:
            conv(r + ".res_conv", cin, cout, 1)
        if attn:
            norm(p + ".attn.norm", cout)
            conv(p + ".attn.qkv", cout, 3 * cout, 1, bias=False)
            conv(p + ".attn.out", cout, cout, 1)

    lin("noise_level_mlp.0", inner, 4 * inner)
    lin("noise_level_mlp.2", 4 * inner, inner)
    downs, mid, ups, pre, _ = _topology(cfg)
    for p, kind, args in downs + mid + ups:
        if kind == "conv":
            conv(p, *args)
        elif kind == "block":
            block(p, *args)
        else:
            conv(p + ".conv", args[0], args[0], 3)
    norm("final_conv.block.0", pre)
    conv("final_conv.block.3", pre, cfg["out_channel"], 3)
    return specs


def forward(params, cfg, x, angle, level, prec=FLOAT32):
    """x (B, H, W, in) NHWC, angle and level (B,) -> (B, H, W, out) f32."""
    inner = cfg["inner_channel"]
    downs, mid, ups, _, groups = _topology(cfg)
    P = params

    def conv(p, h, stride=1):
        w = P[p + ".weight"]
        pad = w.shape[-1] // 2
        return F.conv2d(prec.op(h), prec.op(w), P.get(p + ".bias"),
                        stride=stride, padding=pad)

    def lin(p, h):
        return F.linear(prec.op(h), prec.op(P[p + ".weight"]), P[p + ".bias"])

    def gn(p, h):
        return F.group_norm(h, groups, P[p + ".weight"], P[p + ".bias"], 1e-5)

    def block(p, h, t, attn):
        r = p + ".res_block"
        y = conv(r + ".block1.block.3", F.silu(gn(r + ".block1.block.0", h)))
        y = y + lin(r + ".noise_func.noise_func.0", t)[:, :, None, None]
        y = conv(r + ".block2.block.3", F.silu(gn(r + ".block2.block.0", y)))
        res = conv(r + ".res_conv", h) if r + ".res_conv.weight" in P else h
        y = y + res
        if not attn:
            return y
        b, c, hh, ww = y.shape
        qkv = conv(p + ".attn.qkv", gn(p + ".attn.norm", y))
        q, k, v = (qkv[:, i * c:(i + 1) * c].flatten(2).transpose(1, 2)
                   for i in range(3))
        s = torch.matmul(prec.op(q), prec.op(k).transpose(1, 2)) / math.sqrt(c)
        o = torch.matmul(prec.op(torch.softmax(s, dim=-1)), prec.op(v))
        o = o.transpose(1, 2).reshape(b, c, hh, ww)
        return conv(p + ".attn.out", o) + y

    t = torch.cat([positional_encoding(level.reshape(-1), inner // 2),
                   positional_encoding(angle.reshape(-1), inner // 2)], -1)
    t = lin("noise_level_mlp.2", F.silu(lin("noise_level_mlp.0", t)))
    h = x.float().permute(0, 3, 1, 2)
    feats = []
    for p, kind, args in downs:
        if kind == "conv":
            h = conv(p, h)
        elif kind == "block":
            h = block(p, h, t, args[2])
        else:
            h = conv(p + ".conv", h, stride=2)
        feats.append(h)
    for p, kind, args in mid:
        h = block(p, h, t, args[2])
    for p, kind, args in ups:
        if kind == "block":
            h = block(p, torch.cat([h, feats.pop()], dim=1), t, args[2])
        else:
            h = conv(p + ".conv", F.interpolate(h, scale_factor=2,
                                                mode="nearest"))
    h = conv("final_conv.block.3", F.silu(gn("final_conv.block.0", h)))
    return h.permute(0, 2, 3, 1).float()
