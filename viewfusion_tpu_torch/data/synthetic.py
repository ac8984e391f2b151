"""Synthetic micro-dataset for tests and smoke runs (the port's copy of
``viewfusion_tpu/data/synthetic.py``).

Writes NMR-format tar shards (keys ``0000.png..0023.png`` +
``cameras.npz``) of procedurally rendered objects, with the same pixels
as the JAX package's generator for the same arguments; PNGs go through
the port's encoder.  Two families:

``squares`` (default): a coloured square whose position encodes the view
azimuth, with the view index stamped into a corner pixel.

``shaded``: two anti-aliased shapes (square + disc) orbiting at different
radii and phases with view-dependent occlusion, Lambertian-style shading
against a fixed light azimuth and a smooth gradient background; every
pixel is a smooth function of a low-dimensional latent, so a small model
generalises to held-out objects.
"""

from __future__ import annotations

import io
import os
from typing import List

import numpy as np

from viewfusion_tpu_torch.data.tario import TarShardWriter
from viewfusion_tpu_torch.utils.png import encode_png

__all__ = ["make_synthetic_shards", "render_views", "render_views_shaded"]


def render_views(obj_seed: int, image_size: int = 16,
                 total_views: int = 24) -> np.ndarray:
    """(V, H, W, 3) uint8 views of one synthetic object."""
    rng = np.random.default_rng(obj_seed)
    color = rng.integers(64, 255, (3,))
    bg = rng.integers(0, 48, (3,))
    size = max(2, image_size // 4)
    views = np.zeros((total_views, image_size, image_size, 3), np.uint8)
    views[..., :] = bg
    for v in range(total_views):
        theta = 2 * np.pi * v / total_views
        cx = int((image_size - size) * (0.5 + 0.4 * np.cos(theta)))
        cy = int((image_size - size) * (0.5 + 0.4 * np.sin(theta)))
        views[v, cy : cy + size, cx : cx + size] = color
        # Stamp the view index into the corner so every view is unique
        # (integer position rounding can otherwise collide).
        views[v, 0, 0] = (v * 10 % 256, 255 - v * 10 % 256, v)
    return views


def render_views_shaded(obj_seed: int, image_size: int = 64,
                        total_views: int = 24) -> np.ndarray:
    """(V, H, W, 3) uint8 views of one "shaded" family object.

    Scene latent (drawn once per object from ``obj_seed``): two shape
    colors, two orbit radii, a disc phase, two sizes, and a background
    gradient.  Per view v (azimuth theta = 2*pi*v/V): the square orbits
    at angle theta, the disc at 2*theta + phase (twice the rate, so the
    two shapes overlap at some azimuths and not others); each shape is
    shaded by a Lambertian term against a FIXED global light azimuth
    (brightness varies smoothly with view), and the shape with the
    larger sin-depth occludes the other — occlusion order flips across
    the orbit.  Rendered 2x supersampled with soft edges, then
    box-downsampled: no hard aliasing, no per-view stamps.
    """
    rng = np.random.default_rng(obj_seed)
    col_sq = rng.uniform(0.45, 1.0, 3)
    col_di = rng.uniform(0.45, 1.0, 3)
    bg_top = rng.uniform(0.02, 0.22, 3)
    bg_bot = np.clip(bg_top + rng.uniform(0.05, 0.25, 3), 0.0, 0.5)
    phase = rng.uniform(0.0, 2.0 * np.pi)
    r_sq = rng.uniform(0.22, 0.32)
    r_di = rng.uniform(0.08, 0.18)
    half_sq = rng.uniform(0.10, 0.16)   # square half-side, fraction
    rad_di = rng.uniform(0.10, 0.17)    # disc radius, fraction
    light = 0.9  # global light azimuth shared by every object

    ss = 2
    n = image_size * ss
    soft = 1.5 / n  # edge softness ~0.75 output pixels
    ys, xs = (np.mgrid[0:n, 0:n].astype(np.float32) + 0.5) / n
    views = np.empty((total_views, image_size, image_size, 3), np.uint8)
    for v in range(total_views):
        theta = 2 * np.pi * v / total_views
        img = bg_top + (bg_bot - bg_top) * ys[..., None]
        shapes = []  # (depth, mask, rgb)
        angles = {"sq": theta, "di": 2 * theta + phase}
        for (name, r, col) in (("sq", r_sq, col_sq),
                               ("di", r_di, col_di)):
            a = angles[name]
            cx = 0.5 + r * np.cos(a)
            cy = 0.5 + r * np.sin(a)
            shade = 0.55 + 0.45 * np.cos(a - light)
            if name == "sq":  # square: Chebyshev distance field
                d = np.maximum(np.abs(xs - cx), np.abs(ys - cy))
                mask = np.clip((half_sq - d) / soft, 0.0, 1.0)
            else:  # disc: Euclidean distance field
                d = np.hypot(xs - cx, ys - cy)
                mask = np.clip((rad_di - d) / soft, 0.0, 1.0)
            shapes.append((np.sin(a), mask, col * shade))
        shapes.sort(key=lambda s: s[0])  # back-to-front composite
        for _, mask, rgb in shapes:
            img = img * (1 - mask[..., None]) + rgb * mask[..., None]
        down = img.reshape(image_size, ss, image_size, ss, 3).mean((1, 3))
        views[v] = (np.clip(down, 0.0, 1.0) * 255).round().astype(np.uint8)
    return views


_FAMILIES = {"squares": render_views, "shaded": render_views_shaded}


def make_synthetic_shards(
    dest_dir: str,
    mode: str = "train",
    num_objects: int = 8,
    num_shards: int = 1,
    image_size: int = 16,
    total_views: int = 24,
    seed: int = 0,
    family: str = "squares",
) -> List[str]:
    """Write ``NMR-{mode}-{NN}.tar`` shards; returns their paths."""
    render = _FAMILIES[family]
    os.makedirs(dest_dir, exist_ok=True)
    per_shard = num_objects // num_shards
    paths = []
    obj = 0
    for s in range(num_shards):
        path = os.path.join(dest_dir, f"NMR-{mode}-{s:02d}.tar")
        paths.append(path)
        with TarShardWriter(path) as sink:
            for _ in range(per_shard):
                views = render(seed * 10007 + obj, image_size,
                               total_views)
                sample = {"__key__": f"synth-{mode}-{obj:05d}"}
                for i in range(total_views):
                    sample[f"{i:04d}.png"] = encode_png(views[i])
                cams = io.BytesIO()
                np.savez(cams, world_mat_0=np.eye(4, dtype=np.float32))
                sample["cameras.npz"] = cams.getvalue()
                sink.write(sample)
                obj += 1
    return paths
