"""Image grids: ``make_grid``, copied from ``arvae_tpu/utils/plotting.py``
(torchvision's ``make_grid`` layout, in numpy).

The rest of that module is left out by design: ``save_image_grid``, the
latent scatters, the GIF writers, the paper's seaborn figures and the
pianoroll plots need matplotlib, seaborn, pandas or PIL, which the
card's machine does not have. The trainers' traversal grids
(``ImageVAETrainer.compute_latent_interpolations``, the fader's) return
``make_grid`` arrays, as the JAX trainers' do.
"""

from __future__ import annotations

import numpy as np


def make_grid(
    images: np.ndarray, nrow: int = 8, padding: int = 2, pad_value: float = 0.0
) -> np.ndarray:
    """(N, C, H, W) → (C, H', W') tiled grid, matching torchvision layout."""
    images = np.asarray(images)
    n, c, h, w = images.shape
    ncol = nrow
    nrows = (n + ncol - 1) // ncol
    gh = nrows * (h + padding) + padding
    gw = ncol * (w + padding) + padding
    grid = np.full((c, gh, gw), pad_value, dtype=images.dtype)
    for i in range(n):
        r, col = divmod(i, ncol)
        y = r * (h + padding) + padding
        x = col * (w + padding) + padding
        grid[:, y : y + h, x : x + w] = images[i]
    return grid
