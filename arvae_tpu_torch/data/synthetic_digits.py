"""Deterministic synthetic MNIST-like digit renderer.

A numpy copy of ``arvae_tpu/data/synthetic_digits.py``: the same
strokes, transforms and draws, so ``generate_digit_set(n, seed)`` gives
the JAX package's images and labels bit for bit. Each digit class is a
set of polyline strokes in the unit square, rasterized as a distance
field with per-sample random thickness, slant (horizontal shear), scale
and offset, the generative factors the Morpho-MNIST morphometrics
measure. It stands in for the Morpho-MNIST archives when none are
present (``arvae_tpu_torch.data.mnist``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

# Digit stroke templates: lists of polylines, coordinates in [0, 1]²
# with (0, 0) at top-left. Hand-drawn to be glyph-like.


def _circle(cx, cy, rx, ry, n=24, t0=0.0, t1=2 * np.pi):
    ts = np.linspace(t0, t1, n)
    return np.stack([cx + rx * np.cos(ts), cy + ry * np.sin(ts)], axis=1)


DIGIT_STROKES: Dict[int, List[np.ndarray]] = {
    0: [_circle(0.5, 0.5, 0.28, 0.42)],
    1: [np.array([[0.35, 0.25], [0.55, 0.08], [0.55, 0.92]])],
    2: [
        np.concatenate(
            [
                _circle(0.5, 0.3, 0.25, 0.22, n=14, t0=np.pi, t1=2.25 * np.pi),
                np.array([[0.25, 0.92], [0.78, 0.92]]),
            ]
        )
    ],
    3: [
        _circle(0.48, 0.3, 0.24, 0.22, n=14, t0=1.15 * np.pi, t1=2.6 * np.pi),
        _circle(0.48, 0.7, 0.26, 0.24, n=14, t0=1.4 * np.pi, t1=2.85 * np.pi),
    ],
    4: [
        np.array([[0.62, 0.08], [0.22, 0.62], [0.8, 0.62]]),
        np.array([[0.62, 0.08], [0.62, 0.92]]),
    ],
    5: [
        np.array([[0.75, 0.08], [0.3, 0.08], [0.27, 0.45]]),
        _circle(0.48, 0.65, 0.26, 0.25, n=16, t0=1.3 * np.pi, t1=2.9 * np.pi),
    ],
    6: [
        np.array([[0.68, 0.08], [0.38, 0.45], [0.3, 0.65]]),
        _circle(0.5, 0.68, 0.22, 0.22),
    ],
    7: [np.array([[0.22, 0.08], [0.78, 0.08], [0.42, 0.92]])],
    8: [
        _circle(0.5, 0.3, 0.2, 0.2),
        _circle(0.5, 0.71, 0.24, 0.21),
    ],
    9: [
        _circle(0.5, 0.32, 0.22, 0.22),
        np.array([[0.72, 0.32], [0.66, 0.92]]),
    ],
}


def _segments(strokes: List[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    a, b = [], []
    for line in strokes:
        a.append(line[:-1])
        b.append(line[1:])
    return np.concatenate(a, 0), np.concatenate(b, 0)


def render_digit(
    digit: int,
    thickness: float = 1.2,
    slant: float = 0.0,
    scale_x: float = 1.0,
    scale_y: float = 1.0,
    dx: float = 0.0,
    dy: float = 0.0,
    size: int = 28,
) -> np.ndarray:
    """Rasterizes a digit as a soft-edged stroke image in [0, 1].

    ``slant`` is the horizontal shear factor (x' = x + slant * (y_mid - y)),
    the same convention the morphometric ``slant = arctan(-shear)`` reads
    back. ``thickness`` is the stroke half-width in pixels (at 28×28).
    """
    a, b = _segments(DIGIT_STROKES[digit])
    # transform template -> pixel coords
    pts_y = lambda p: (p[:, 1] - 0.5) * scale_y * (size * 0.82) + size / 2 + dy
    pts_x = lambda p, y: (
        (p[:, 0] - 0.5) * scale_x * (size * 0.82)
        + size / 2
        + dx
        + slant * (size / 2 - y)
    )
    ay = pts_y(a)
    ax = pts_x(a, ay)
    by = pts_y(b)
    bx = pts_x(b, by)

    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    px = xx.reshape(-1, 1)
    py = yy.reshape(-1, 1)
    # distance from each pixel to each segment
    vx, vy = bx - ax, by - ay
    L2 = vx**2 + vy**2 + 1e-12
    t = ((px - ax) * vx + (py - ay) * vy) / L2
    t = np.clip(t, 0.0, 1.0)
    cx = ax + t * vx
    cy = ay + t * vy
    d = np.sqrt((px - cx) ** 2 + (py - cy) ** 2).min(axis=1).reshape(size, size)
    # soft stroke: 1 inside radius, smooth falloff ~0.8px
    img = np.clip((thickness - d) / 0.8 + 0.5, 0.0, 1.0)
    return img.astype(np.float32)


def generate_digit_set(
    n: int, seed: int = 0, size: int = 28
) -> Tuple[np.ndarray, np.ndarray]:
    """Renders ``n`` digits with randomized morphological factors.

    Returns (images (n, 1, size, size) float32 in [0,1], labels (n,) int64).
    """
    rng = np.random.RandomState(seed)
    digits = rng.randint(0, 10, size=n)
    imgs = np.zeros((n, 1, size, size), dtype=np.float32)
    for i in range(n):
        imgs[i, 0] = render_digit(
            int(digits[i]),
            thickness=rng.uniform(0.7, 2.2),
            slant=rng.uniform(-0.45, 0.45),
            scale_x=rng.uniform(0.75, 1.1),
            scale_y=rng.uniform(0.8, 1.1),
            dx=rng.uniform(-1.5, 1.5),
            dy=rng.uniform(-1.5, 1.5),
            size=size,
        )
    return imgs, digits.astype(np.int64)
