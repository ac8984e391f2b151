"""JAX (flax) UNet params -> the port's UNet ``state_dict``.

The inverse of ``viewfusion_tpu.utils.torch_convert.convert_unet_state_dict``
(the port keeps its own copy of the name map):

  * conv kernel (kh, kw, I, O) -> weight (O, I, kh, kw)
  * Dense kernel (I, O)        -> Linear weight (O, I)
  * GroupNorm scale / bias     -> weight / bias

The input is the JAX package's ``{"params": {...}}`` tree as nested
dicts of numpy arrays (anything ``np.asarray`` takes).
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch

__all__ = ["unet_state_dict_from_jax"]


def unet_state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    p = params["params"] if "params" in params else params
    sd: Dict[str, np.ndarray] = {}

    def linear(dst, src):
        sd[f"{dst}.weight"] = np.transpose(np.asarray(src["kernel"]), (1, 0))
        sd[f"{dst}.bias"] = np.asarray(src["bias"])

    def conv(dst, src):
        sd[f"{dst}.weight"] = np.transpose(np.asarray(src["kernel"]),
                                           (3, 2, 0, 1))
        if "bias" in src:
            sd[f"{dst}.bias"] = np.asarray(src["bias"])

    def norm(dst, src):
        sd[f"{dst}.weight"] = np.asarray(src["scale"])
        sd[f"{dst}.bias"] = np.asarray(src["bias"])

    def block(dst, src):
        norm(f"{dst}.block.0", src["GroupNorm_0"])
        conv(f"{dst}.block.3", src["Conv_0"])

    def block_with_attn(dst, src):
        r = src["ResnetBlock_0"]
        block(f"{dst}.res_block.block1", r["Block_0"])
        block(f"{dst}.res_block.block2", r["Block_1"])
        linear(f"{dst}.res_block.noise_func.noise_func.0",
               r["FeatureWiseAffine_0"]["noise_func"])
        if "res_conv" in r:
            conv(f"{dst}.res_block.res_conv", r["res_conv"])
        if "SelfAttention_0" in src:
            a = src["SelfAttention_0"]
            norm(f"{dst}.attn.norm", a["GroupNorm_0"])
            conv(f"{dst}.attn.qkv", a["qkv"])
            conv(f"{dst}.attn.out", a["out"])

    # the structure (scales, res blocks per scale) is read off the names
    downs = sorted({tuple(map(int, m.groups())) for m in
                    (re.fullmatch(r"down_(\d+)_(\d+)", k) for k in p) if m})
    num_mults = max(i for i, _ in downs) + 1
    res_blocks = max(j for _, j in downs) + 1

    linear("noise_level_mlp.0", p["noise_mlp_0"])
    linear("noise_level_mlp.2", p["noise_mlp_1"])
    conv("downs.0", p["stem"])
    idx = 1
    for ind in range(num_mults):
        for blk in range(res_blocks):
            block_with_attn(f"downs.{idx}", p[f"down_{ind}_{blk}"])
            idx += 1
        if ind != num_mults - 1:
            conv(f"downs.{idx}.conv", p[f"downsample_{ind}"]["Conv_0"])
            idx += 1
    block_with_attn("mid.0", p["mid_0"])
    block_with_attn("mid.1", p["mid_1"])
    idx = 0
    for ind in reversed(range(num_mults)):
        for blk in range(res_blocks + 1):
            block_with_attn(f"ups.{idx}", p[f"up_{ind}_{blk}"])
            idx += 1
        if ind >= 1:
            conv(f"ups.{idx}.conv", p[f"upsample_{ind}"]["Conv_0"])
            idx += 1
    block("final_conv", p["final_conv"])
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
            for k, v in sd.items()}
