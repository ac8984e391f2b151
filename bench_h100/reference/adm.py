"""The ADM denoiser in plain float32 PyTorch, from Dhariwal & Nichol,
"Diffusion Models Beat GANs on Image Synthesis" (arXiv 2105.05233) and
``guided_diffusion/unet.py`` at its 64x64 flags (scale-shift norm,
up/down ResBlocks, heads of ``num_head_channels``, the new attention
order), as ViewFusion's denoiser.

Departures from the published ADM, all ViewFusion's:

  * conditioning: the WaveGrad encodings of the noise level and of the
    angle (``model_channels // 2`` each) into ``time_embed``
    (Linear-SiLU-Linear to 4 x ``model_channels``), in place of ADM's
    timestep and class embeddings;
  * the 6 output channels (ADM's ``learn_sigma`` width) are read as 3
    noise and 3 weight-logit channels, composed over the views;
  * the loss is ViewFusion's MSE on the composed noise, not ADM's hybrid
    loss; no EMA; the program computes in bf16, not fp16.

Layers: ``time_embed``; ``input_blocks`` (a 3x3 stem; per level
ResBlocks, each with attention where the resolution is listed; a
ResBlock that halves the resolution below the last level);
``middle_block`` (ResBlock, attention, ResBlock); ``output_blocks`` on
the skip concatenations (a ResBlock that doubles the resolution ends each
level above the first); ``out`` (GroupNorm 32, SiLU, 3x3 conv).  A
ResBlock: GroupNorm 32, SiLU, [nearest 2x or 2x2 average pool of the
branch and the skip], 3x3 conv; ``GN(h) * (1 + scale) + shift`` with
(scale, shift) = Linear(SiLU(emb)); SiLU; 3x3 conv; a 1x1 skip where the
width changes.  Attention: GroupNorm 32, ``qkv`` (q, k, v and the heads
split as ``which * C + head * hd + d``), softmax(q k^T / sqrt(hd)) v per
head, ``proj``, the residual.

Parameters are a flat ``{name: tensor}`` dict under the program's
``state_dict`` names.  ``param_specs`` marks ADM's zero-initialised
layers (each ResBlock's last conv, the attention ``proj``, the output
conv) ``zero_init``, so seeded weights make every branch live.  Each
ResBlock and attention block is recomputed in the backward
(``torch.utils.checkpoint``): a plain f32 forward keeps ~0.8 GB a row
for its backward, more than fits beside the program's state at the
training driver's blocks of 20 samples; the arithmetic is the same."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench_h100.reference.precision import FLOAT32
from bench_h100.reference.unet import positional_encoding

GROUPS = 32


def topology(cfg):
    """[(stage name, [(prefix, kind, cin, cout, extra)])] in forward order:
    kind ``stem``, ``res`` (extra: "up", "down" or None) or ``attn``
    (extra: heads); and the width before ``out``."""
    mc, heads = cfg["model_channels"], cfg["num_head_channels"]
    mults, attn_res = cfg["channel_mult"], cfg["attention_resolutions"]
    ch, res = mc * mults[0], cfg["image_size"]
    stages = [("input_blocks.0", [("input_blocks.0.0", "stem",
                                   cfg["in_channel"], ch, None)])]
    chans = [ch]

    def stage(name, cin, cout, res):
        layers = [(f"{name}.0", "res", cin, cout, None)]
        if res in attn_res:
            layers.append((f"{name}.1", "attn", cout, cout, cout // heads))
        return layers

    for level, mult in enumerate(mults):
        for _ in range(cfg["num_res_blocks"]):
            name = f"input_blocks.{len(stages)}"
            stages.append((name, stage(name, ch, mc * mult, res)))
            ch = mc * mult
            chans.append(ch)
        if level != len(mults) - 1:
            name = f"input_blocks.{len(stages)}"
            stages.append((name, [(f"{name}.0", "res", ch, ch, "down")]))
            chans.append(ch)
            res //= 2
    stages.append(("middle_block", [
        ("middle_block.0", "res", ch, ch, None),
        ("middle_block.1", "attn", ch, ch, ch // heads),
        ("middle_block.2", "res", ch, ch, None)]))
    k = 0
    for level, mult in reversed(list(enumerate(mults))):
        for i in range(cfg["num_res_blocks"] + 1):
            name = f"output_blocks.{k}"
            layers = stage(name, ch + chans.pop(), mc * mult, res)
            ch = mc * mult
            if level and i == cfg["num_res_blocks"]:
                layers.append((f"{name}.{len(layers)}", "res", ch, ch, "up"))
                res *= 2
            stages.append((name, layers))
            k += 1
    return stages, ch


def param_specs(cfg):
    """[(name, shape, kind)] under the program's ``state_dict`` names."""
    mc = cfg["model_channels"]
    emb = 4 * mc
    specs = []

    def conv(p, cin, cout, k, kind="kernel"):
        specs.append((f"{p}.weight", (cout, cin, k, k), kind))
        specs.append((f"{p}.bias", (cout,), "bias"))

    def lin(p, cin, cout, kind="kernel"):
        specs.append((f"{p}.weight", (cout, cin), kind))
        specs.append((f"{p}.bias", (cout,), "bias"))

    def norm(p, c):
        specs.append((f"{p}.weight", (c,), "norm"))
        specs.append((f"{p}.bias", (c,), "bias"))

    lin("time_embed.0", mc, emb)
    lin("time_embed.2", emb, emb)
    stages, ch = topology(cfg)
    for _, layers in stages:
        for p, kind, cin, cout, _ in layers:
            if kind == "stem":
                conv(p, cin, cout, 3)
            elif kind == "res":
                norm(p + ".in_layers.0", cin)
                conv(p + ".in_layers.2", cin, cout, 3)
                lin(p + ".emb_layers.1", emb, 2 * cout)
                norm(p + ".out_layers.0", cout)
                conv(p + ".out_layers.3", cout, cout, 3, "zero_init")
                if cin != cout:
                    conv(p + ".skip_connection", cin, cout, 1)
            else:
                norm(p + ".norm", cin)
                lin(p + ".attn.qkv", cin, 3 * cin)
                lin(p + ".attn.proj", cin, cin, "zero_init")
    norm("out.0", ch)
    conv("out.2", ch, cfg["out_channel"], 3, "zero_init")
    return specs


def forward(params, cfg, x, angle, level, prec=FLOAT32):
    """x (B, H, W, in) NHWC, angle and level (B,) -> (B, H, W, out) f32."""
    P = params
    mc = cfg["model_channels"]

    def conv(p, h):
        w = P[p + ".weight"]
        return F.conv2d(prec.op(h), prec.op(w), P[p + ".bias"],
                        padding=w.shape[-1] // 2)

    def lin(p, h):
        return F.linear(prec.op(h), prec.op(P[p + ".weight"]), P[p + ".bias"])

    def gn(p, h):
        return F.group_norm(h, GROUPS, P[p + ".weight"], P[p + ".bias"], 1e-5)

    def resample(h, how):
        if how == "up":
            return F.interpolate(h, scale_factor=2, mode="nearest")
        return F.avg_pool2d(h, 2) if how == "down" else h

    def res_block(p, how, h, emb):
        y = conv(p + ".in_layers.2",
                 resample(F.silu(gn(p + ".in_layers.0", h)), how))
        h = resample(h, how)
        scale, shift = lin(p + ".emb_layers.1", F.silu(emb)).chunk(2, dim=1)
        y = gn(p + ".out_layers.0", y) * (1 + scale[:, :, None, None]) \
            + shift[:, :, None, None]
        y = conv(p + ".out_layers.3", F.silu(y))
        skip = conv(p + ".skip_connection", h) \
            if p + ".skip_connection.weight" in P else h
        return skip + y

    def attn_block(p, heads, h):
        b, c, hh, ww = h.shape
        hd = c // heads
        tok = gn(p + ".norm", h).flatten(2).transpose(1, 2)
        q, k, v = (t.reshape(b, hh * ww, heads, hd).transpose(1, 2)
                   for t in lin(p + ".attn.qkv", tok).chunk(3, dim=-1))
        s = torch.matmul(prec.op(q), prec.op(k).transpose(-1, -2))
        o = torch.matmul(prec.op(torch.softmax(s / math.sqrt(hd), dim=-1)),
                         prec.op(v))
        o = lin(p + ".attn.proj", o.transpose(1, 2).reshape(b, hh * ww, c))
        return h + o.transpose(1, 2).reshape(b, c, hh, ww)

    def run(fn, *args):
        if torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    emb = torch.cat([positional_encoding(level.reshape(-1), mc // 2),
                     positional_encoding(angle.reshape(-1), mc // 2)], -1)
    emb = lin("time_embed.2", F.silu(lin("time_embed.0", emb)))
    h = x.float().permute(0, 3, 1, 2)
    stages, _ = topology(cfg)
    feats = []
    for name, layers in stages:
        if name.startswith("output_blocks"):
            h = torch.cat([h, feats.pop()], dim=1)
        for p, kind, _, _, extra in layers:
            if kind == "stem":
                h = conv(p, h)
            elif kind == "res":
                h = run(lambda a, e, p=p, how=extra: res_block(p, how, a, e),
                        h, emb)
            else:
                h = run(lambda a, p=p, heads=extra: attn_block(p, heads, a),
                        h)
        if name.startswith("input_blocks"):
            feats.append(h)
    h = conv("out.2", F.silu(gn("out.0", h)))
    return h.permute(0, 2, 3, 1).float()
