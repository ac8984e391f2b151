"""The ADM denoiser (Dhariwal & Nichol, arXiv 2105.05233;
``guided_diffusion/unet.py`` with scale-shift norm, up/down ResBlocks and
the new attention order) in plain float32 PyTorch, as ViewFusion's
denoiser: the tier-1 tests hold ``viewfusion_tpu_torch.models.adm``
against it.  It imports neither JAX nor anything of the port.

ViewFusion's conditioning takes the place of ADM's timestep and class
embeddings: the WaveGrad encodings of the noise level and of the angle
(``model_channels // 2`` each) into ``time_embed`` (Linear, SiLU,
Linear to 4 x ``model_channels``).  The 6 output channels are ADM's
``learn_sigma`` width.  ``params`` is a flat ``{name: tensor}`` dict
under the port's ``state_dict`` names; ``param_specs`` lists them with
their kind (``kernel``, ``norm``, ``bias``, ``zero_init``: ADM's
zero-initialised layers)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

GROUPS = 32


def _layers(cfg):
    """[(stage, [(prefix, kind, cin, cout, extra)])] in forward order, and
    the width before ``out``; kind ``stem``, ``res`` (extra "up", "down"
    or None) or ``attn`` (extra: heads)."""
    mc, hc = cfg["model_channels"], cfg["num_head_channels"]
    mults = cfg["channel_mult"]
    ch, res = mc * mults[0], cfg["image_size"]
    out = [("input_blocks.0", [("input_blocks.0.0", "stem",
                                cfg["in_channel"], ch, None)])]
    chans = [ch]

    def blk(name, cin, cout, res):
        layers = [(name + ".0", "res", cin, cout, None)]
        if res in cfg["attention_resolutions"]:
            layers.append((name + ".1", "attn", cout, cout, cout // hc))
        return layers

    for level, mult in enumerate(mults):
        for _ in range(cfg["num_res_blocks"]):
            name = f"input_blocks.{len(out)}"
            out.append((name, blk(name, ch, mc * mult, res)))
            ch = mc * mult
            chans.append(ch)
        if level < len(mults) - 1:
            name = f"input_blocks.{len(out)}"
            out.append((name, [(name + ".0", "res", ch, ch, "down")]))
            chans.append(ch)
            res //= 2
    out.append(("middle_block", [("middle_block.0", "res", ch, ch, None),
                                 ("middle_block.1", "attn", ch, ch, ch // hc),
                                 ("middle_block.2", "res", ch, ch, None)]))
    n = 0
    for level in reversed(range(len(mults))):
        for i in range(cfg["num_res_blocks"] + 1):
            name = f"output_blocks.{n}"
            layers = blk(name, ch + chans.pop(), mc * mults[level], res)
            ch = mc * mults[level]
            if level > 0 and i == cfg["num_res_blocks"]:
                layers.append((f"{name}.{len(layers)}", "res", ch, ch, "up"))
                res *= 2
            out.append((name, layers))
            n += 1
    return out, ch


def param_specs(cfg):
    """[(name, shape, kind)] of every parameter."""
    mc = cfg["model_channels"]
    specs = []

    def add(p, wshape, kind="kernel", bias_kind="bias"):
        specs.append((p + ".weight", wshape, kind))
        specs.append((p + ".bias", (wshape[0],), bias_kind))

    add("time_embed.0", (4 * mc, mc))
    add("time_embed.2", (4 * mc, 4 * mc))
    stages, ch = _layers(cfg)
    for _, layers in stages:
        for p, kind, cin, cout, _ in layers:
            if kind == "stem":
                add(p, (cout, cin, 3, 3))
            elif kind == "res":
                add(p + ".in_layers.0", (cin,), "norm")
                add(p + ".in_layers.2", (cout, cin, 3, 3))
                add(p + ".emb_layers.1", (2 * cout, 4 * mc))
                add(p + ".out_layers.0", (cout,), "norm")
                add(p + ".out_layers.3", (cout, cout, 3, 3), "zero_init")
                if cin != cout:
                    add(p + ".skip_connection", (cout, cin, 1, 1))
            else:
                add(p + ".norm", (cin,), "norm")
                add(p + ".attn.qkv", (3 * cin, cin))
                add(p + ".attn.proj", (cin, cin), "zero_init")
    add("out.0", (ch,), "norm")
    add("out.2", (cfg["out_channel"], ch, 3, 3), "zero_init")
    return specs


def _encoding(v, dim):
    count = dim // 2
    step = torch.arange(count, dtype=torch.float32, device=v.device) / count
    e = v.float()[:, None] * torch.exp(-math.log(1e4) * step[None, :])
    return torch.cat([torch.sin(e), torch.cos(e)], dim=-1)


def forward(params, cfg, x, angle, level):
    """x (B, H, W, in) NHWC, angle and level (B,) -> (B, H, W, out)."""
    P = params
    mc = cfg["model_channels"]

    def conv(p, h):
        w = P[p + ".weight"]
        return F.conv2d(h, w, P[p + ".bias"], padding=w.shape[-1] // 2)

    def lin(p, h):
        return F.linear(h, P[p + ".weight"], P[p + ".bias"])

    def norm(p, h):
        return F.group_norm(h, GROUPS, P[p + ".weight"], P[p + ".bias"],
                            eps=1e-5)

    def updown(h, how):
        if how == "up":
            return F.interpolate(h, scale_factor=2, mode="nearest")
        if how == "down":
            return F.avg_pool2d(h, kernel_size=2, stride=2)
        return h

    emb = torch.cat([_encoding(level.reshape(-1), mc // 2),
                     _encoding(angle.reshape(-1), mc // 2)], dim=-1)
    emb = lin("time_embed.2", F.silu(lin("time_embed.0", emb)))
    h = x.float().permute(0, 3, 1, 2)
    stages, _ = _layers(cfg)
    skips = []
    for name, layers in stages:
        if name.startswith("output_blocks"):
            h = torch.cat([h, skips.pop()], dim=1)
        for p, kind, _, _, extra in layers:
            if kind == "stem":
                h = conv(p, h)
            elif kind == "res":
                y = updown(F.silu(norm(p + ".in_layers.0", h)), extra)
                y = conv(p + ".in_layers.2", y)
                h = updown(h, extra)
                ss = lin(p + ".emb_layers.1", F.silu(emb))[:, :, None, None]
                scale, shift = ss.chunk(2, dim=1)
                y = norm(p + ".out_layers.0", y) * (1 + scale) + shift
                y = conv(p + ".out_layers.3", F.silu(y))
                if p + ".skip_connection.weight" in P:
                    h = conv(p + ".skip_connection", h)
                h = h + y
            else:
                b, c, hh, ww = h.shape
                hd = c // extra
                t = norm(p + ".norm", h).reshape(b, c, -1).transpose(1, 2)
                qkv = lin(p + ".attn.qkv", t)
                q, k, v = (u.reshape(b, -1, extra, hd).transpose(1, 2)
                           for u in qkv.chunk(3, dim=-1))
                a = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd),
                                  dim=-1) @ v
                a = lin(p + ".attn.proj",
                        a.transpose(1, 2).reshape(b, -1, c))
                h = h + a.transpose(1, 2).reshape(b, c, hh, ww)
        if name.startswith("input_blocks"):
            skips.append(h)
    h = conv("out.2", F.silu(norm("out.0", h)))
    return h.permute(0, 2, 3, 1)
