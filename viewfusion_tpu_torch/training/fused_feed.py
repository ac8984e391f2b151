"""The fused feed of ``tpu.fused_feed`` (counterpart of
``viewfusion_tpu/training/fused_feed.py``): one train batch as three
arrays instead of six, so three host-to-device copies per step.

  * ``img``    (B, 1+N, H, W, C): the target in slot 0, cond in 1..N,
               uint8 or float32;
  * ``meta_b`` (B, 2) int32: [angle's f32 bits, view_count];
  * ``meta_r`` (2, rows) int32: [sample_idx, view_idx].

:func:`pack_batch` is the JAX function (numpy; the same bytes), and
:func:`unpack_batch` inverts it on tensors with slices and a same-size
bitcast, so the numbers equal the split feed's.  The packed path with
absolute conditioning only: relative mode's 6-channel cond cannot share
an array with the 3-channel target.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

__all__ = ["pack_batch", "unpack_batch"]


def pack_batch(prepped: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Fuse a host-side prepared train batch."""
    target, cond = prepped["target"], prepped["cond"]
    if target.dtype != cond.dtype:
        raise TypeError(
            f"fused feed needs matching image dtypes; got target "
            f"{target.dtype} vs cond {cond.dtype}"
        )
    if target.shape[-1] != cond.shape[-1]:
        raise ValueError(
            "fused feed supports absolute conditioning only (relative "
            "6-channel cond cannot share an array with the 3-channel "
            "target)"
        )
    angle = np.ascontiguousarray(prepped["angle"], np.float32)
    return {
        "img": np.concatenate([target[:, None], cond], axis=1),
        "meta_b": np.stack(
            [angle.view(np.int32),
             prepped["view_count"].astype(np.int32)], axis=1,
        ),
        "meta_r": np.stack(
            [np.asarray(prepped["sample_idx"], np.int32),
             np.asarray(prepped["view_idx"], np.int32)], axis=0,
        ),
    }


def unpack_batch(batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Invert :func:`pack_batch` on tensors (views of the fused ones)."""
    img, meta_b, meta_r = batch["img"], batch["meta_b"], batch["meta_r"]
    return {
        "target": img[:, 0],
        "cond": img[:, 1:],
        "angle": meta_b[:, 0].contiguous().view(torch.float32),
        "view_count": meta_b[:, 1],
        "sample_idx": meta_r[0],
        "view_idx": meta_r[1],
    }
