"""Synthetic data for the CNN benchmark (numpy, made from a seed)."""

from __future__ import annotations

import numpy as np


def image_batch(rng: np.random.Generator, n: int, hw: int = 32,
                n_classes: int = 10, noise: float = 0.32):
    """Structured synthetic images for the CNN benchmark: class-dependent
    oriented gratings + blobs + heavy noise.  The noise level is tuned so
    a small CNN lands ~90% — high enough to be meaningful, low enough
    that multiplier-level errors show up in the accuracy (Table IV).
    Returns (xs (n, hw, hw, 3) float32, ys (n,) int32); the same `rng`
    state gives the same bytes as the JAX package's `image_batch`."""
    ys = rng.integers(0, n_classes, n)
    xs = np.zeros((n, hw, hw, 3), np.float32)
    yy, xx = np.mgrid[0:hw, 0:hw] / hw
    for i, c in enumerate(ys):
        ang = np.pi * c / n_classes
        f = 3 + (c % 3) * 2
        g = np.sin(2 * np.pi * f * (xx * np.cos(ang) + yy * np.sin(ang)))
        cx, cy = rng.random(2) * 0.6 + 0.2
        blob = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2)
                        / (0.02 + 0.01 * (c % 4))))
        img = np.stack([g, blob, g * blob], axis=-1)
        xs[i] = 0.6 * img + noise * rng.standard_normal((hw, hw, 3))
    return xs, ys.astype(np.int32)
