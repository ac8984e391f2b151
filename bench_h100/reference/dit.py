"""The DiT denoiser in plain float32 PyTorch, from Peebles & Xie (arXiv
2212.09748) as ViewFusion's denoiser: the WaveGrad encodings of the noise
level and the angle (half the width each) through a Linear-SiLU-Linear
conditioning MLP; a p x p stride-p patchify conv plus the fixed 2-D
sin-cos position table; ``depth`` adaLN-Zero blocks (LayerNorm without
scale or bias, eps 1e-6; shift, scale and gate from a Linear of
SiLU(cond); multi-head attention; an MLP of ratio 4 with tanh GELU); a
modulated LayerNorm, the linear head and the pixel shuffle.

Parameters are a flat ``{name: tensor}`` dict under the names of the
program's ``state_dict``; ``param_specs`` lists them with their initial
scale (the adaLN-Zero layers, zero in a fresh model, are given small
weights so the model is not the zero map)."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from bench_h100.reference.precision import FLOAT32
from bench_h100.reference.unet import positional_encoding


def sincos_2d(h: int, w: int, dim: int) -> torch.Tensor:
    quarter = dim // 4
    omega = 1.0 / (10000 ** (np.arange(quarter) / quarter))
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    out = []
    for coords in (ys.reshape(-1), xs.reshape(-1)):
        ang = coords[:, None] * omega[None, :]
        out += [np.sin(ang), np.cos(ang)]
    return torch.from_numpy(np.concatenate(out, axis=1).astype(np.float32))


def param_specs(cfg):
    d, p = cfg["hidden_size"], cfg["patch_size"]
    mlp = cfg.get("mlp_ratio", 4) * d
    specs = []

    def lin(name, cin, cout, kind="kernel"):
        specs.append((f"{name}.weight", (cout, cin), kind))
        specs.append((f"{name}.bias", (cout,), "bias"))

    lin("cond_mlp.0", d, 4 * d)
    lin("cond_mlp.2", 4 * d, d)
    specs.append(("patchify.weight", (d, cfg["in_channel"], p, p), "kernel"))
    specs.append(("patchify.bias", (d,), "bias"))
    for i in range(cfg["depth"]):
        b = f"blocks.{i}"
        lin(b + ".adaLN", d, 6 * d, "zero_init")
        lin(b + ".attn.qkv", d, 3 * d)
        lin(b + ".attn.proj", d, d)
        lin(b + ".fc1", d, mlp)
        lin(b + ".fc2", mlp, d)
    lin("final_adaLN", d, 2 * d, "zero_init")
    lin("unpatchify", d, p * p * cfg["out_channel"], "zero_init")
    return specs


def _layer_norm(x):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6)


def forward(params, cfg, x, angle, level, prec=FLOAT32):
    """x (B, H, W, in) NHWC, angle and level (B,) -> (B, H, W, out) f32."""
    P = params
    d, p, heads = cfg["hidden_size"], cfg["patch_size"], cfg["num_heads"]
    b, hh, ww, _ = x.shape
    gh, gw = hh // p, ww // p
    hd = d // heads

    def lin(name, h):
        return F.linear(prec.op(h), prec.op(P[name + ".weight"]),
                        P[name + ".bias"])

    emb = torch.cat([positional_encoding(level.reshape(-1), d // 2),
                     positional_encoding(angle.reshape(-1), d // 2)], -1)
    cond = lin("cond_mlp.2", F.silu(lin("cond_mlp.0", emb)))
    tok = F.conv2d(prec.op(x.float().permute(0, 3, 1, 2)),
                   prec.op(P["patchify.weight"]), P["patchify.bias"],
                   stride=p)
    tok = tok.permute(0, 2, 3, 1).reshape(b, gh * gw, d)
    tok = tok + sincos_2d(gh, gw, d).to(tok.device)
    for i in range(cfg["depth"]):
        blk = f"blocks.{i}"
        mod = lin(blk + ".adaLN", F.silu(cond))[:, None, :]
        sh1, sc1, g1, sh2, sc2, g2 = mod.chunk(6, dim=-1)
        h = _layer_norm(tok) * (1 + sc1) + sh1
        qkv = lin(blk + ".attn.qkv", h).view(b, -1, 3, heads, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        s = torch.matmul(prec.op(q), prec.op(k).transpose(-1, -2))
        a = torch.matmul(prec.op(torch.softmax(s / math.sqrt(hd), dim=-1)),
                         prec.op(v))
        a = a.transpose(1, 2).reshape(b, -1, d)
        tok = tok + g1 * lin(blk + ".attn.proj", a)
        h = _layer_norm(tok) * (1 + sc2) + sh2
        h = lin(blk + ".fc2", F.gelu(lin(blk + ".fc1", h), approximate="tanh"))
        tok = tok + g2 * h
    shift, scale = lin("final_adaLN", F.silu(cond))[:, None, :].chunk(2, -1)
    tok = lin("unpatchify", _layer_norm(tok) * (1 + scale) + shift)
    out = tok.view(b, gh, gw, p, p, cfg["out_channel"])
    return out.permute(0, 1, 3, 2, 4, 5).reshape(b, hh, ww, -1).float()
