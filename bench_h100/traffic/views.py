"""Seeded synthetic views: 64 x 64 RGB renders of a shaded sphere on a
gradient background, one object per request and one light direction per
view, as uint8 (H, W, 3)."""

from __future__ import annotations

import numpy as np


def render_views(rng: np.random.Generator, n: int, size: int) -> np.ndarray:
    """(n, size, size, 3) uint8 views of one object."""
    yy, xx = np.meshgrid(np.linspace(-1, 1, size), np.linspace(-1, 1, size),
                         indexing="ij")
    color = rng.uniform(0.2, 1.0, 3)
    background = rng.uniform(0.0, 0.4, 3)
    radius = rng.uniform(0.45, 0.8)
    cx, cy = rng.uniform(-0.2, 0.2, 2)
    views = np.empty((n, size, size, 3), np.uint8)
    for i in range(n):
        light = rng.normal(size=3)
        light[2] = abs(light[2]) + 0.5
        light /= np.linalg.norm(light)
        dx, dy = (xx - cx) / radius, (yy - cy) / radius
        inside = dx * dx + dy * dy < 1.0
        dz = np.sqrt(np.clip(1.0 - dx * dx - dy * dy, 0.0, 1.0))
        shade = np.clip(dx * light[0] + dy * light[1] + dz * light[2], 0, 1)
        img = background * (0.6 + 0.4 * (yy[..., None] + 1) / 2)
        img = np.where(inside[..., None],
                       color * (0.15 + 0.85 * shade[..., None]), img)
        views[i] = np.clip(np.round(img * 255), 0, 255).astype(np.uint8)
    return views
