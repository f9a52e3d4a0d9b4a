"""Skeleton utilities: a copy of ``arvae_tpu/data/morphomnist/skeleton.py``
(numpy and scipy.ndimage) on the port's ``ImageMorphology``: ``disk``,
the local stroke angle, neighbour counts, erasing disks around seeds and
random skeleton locations. ``LocationSampler`` draws from the
``RandomState`` it is given (``np.random``'s global one without), so a
seed gives the JAX package's locations."""

from __future__ import annotations

from typing import Optional

import numpy as np
from scipy import ndimage

from arvae_tpu_torch.data.morphomnist.morpho import ImageMoments, ImageMorphology

_NB_MASK = np.array([[1, 1, 1], [1, 0, 1], [1, 1, 1]], int)


def disk(radius: int) -> np.ndarray:
    """Binary disk structuring element (skimage.morphology.disk analog)."""
    y, x = np.ogrid[-radius : radius + 1, -radius : radius + 1]
    return (x * x + y * y <= radius * radius).astype(np.uint8)


def get_angle(skel, i: int, j: int, r: int) -> float:
    """Local skeleton angle inside a square window
    (reference skeleton.py:10-34)."""
    skel = np.asarray(skel)
    skel = np.pad(skel, pad_width=r, mode="constant", constant_values=0)
    nbs = skel[i : i + 2 * r + 1, j : j + 2 * r + 1]
    if nbs.sum() == 0:
        return 0.0
    return ImageMoments(nbs.astype(float)).angle


def num_neighbours(skel) -> np.ndarray:
    """#neighbours per skeleton pixel (reference skeleton.py:37-51)."""
    skel = np.asarray(skel, dtype=int)
    return ndimage.convolve(skel, _NB_MASK, mode="constant") * skel


def erase(skel, seeds, r: int) -> np.ndarray:
    """Erase disks around seed locations (reference skeleton.py:54-75)."""
    erased = np.pad(skel, pad_width=r, mode="constant",
                    constant_values=0).astype(bool)
    brush = ~disk(r).astype(bool)
    for i, j in zip(*np.where(seeds)):
        erased[i : i + 2 * r + 1, j : j + 2 * r + 1] &= brush
    if r == 0:
        return erased
    return erased[r:-r, r:-r]


class LocationSampler:
    """Random skeleton locations, optionally pruning tips/forks
    (reference skeleton.py:78-122)."""

    def __init__(self, prune_tips: Optional[float] = None,
                 prune_forks: Optional[float] = None,
                 rng: Optional[np.random.RandomState] = None):
        self.prune_tips = prune_tips
        self.prune_forks = prune_forks
        self.rng = rng or np.random

    def sample(self, morph: ImageMorphology, num: Optional[int] = None
               ) -> np.ndarray:
        skel = morph.skeleton
        if self.prune_tips is not None:
            up_prune = int(self.prune_tips * morph.scale)
            skel = erase(skel, num_neighbours(skel) == 1, up_prune)
        if self.prune_forks is not None:
            up_prune = int(self.prune_forks * morph.scale)
            skel = erase(skel, num_neighbours(skel) == 3, up_prune)
        coords = np.array(np.where(skel)).T
        if coords.shape[0] == 0:
            raise ValueError("Overpruned skeleton")
        centre_idx = self.rng.choice(coords.shape[0], size=num)
        return coords[centre_idx]
