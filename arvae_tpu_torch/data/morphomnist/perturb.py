"""Morphological perturbations: a copy of
``arvae_tpu/data/morphomnist/perturb.py`` on the port's
``ImageMorphology``: thinning and thickening (binary erosion and
dilation with a disk), swelling (a radial power warp through
``map_coordinates``) and fracture (Bresenham lines across the stroke),
numpy and scipy.ndimage only. ``Swelling`` and ``Fracture`` draw their
locations from the ``RandomState`` they are given, so a seed gives the
JAX package's images. No trainer uses them; the Morpho-MNIST library's
``util.py`` (matplotlib) is not ported."""

from __future__ import annotations

import numpy as np
from scipy import ndimage

from arvae_tpu_torch.data.morphomnist import skeleton
from arvae_tpu_torch.data.morphomnist.morpho import ImageMorphology
from arvae_tpu_torch.data.morphomnist.skeleton import LocationSampler, disk


class Perturbation:
    def __call__(self, morph: ImageMorphology) -> np.ndarray:
        raise NotImplementedError


class Thinning(Perturbation):
    """Erode by a fraction of the estimated thickness
    (reference perturb.py:26-41)."""

    def __init__(self, amount: float = 0.7):
        self.amount = amount

    def __call__(self, morph: ImageMorphology) -> np.ndarray:
        radius = int(self.amount * morph.scale * morph.mean_thickness / 2.0)
        if radius == 0:
            return morph.binary_image.copy()
        return ndimage.binary_erosion(morph.binary_image, structure=disk(radius))


class Thickening(Perturbation):
    """Dilate by a fraction of the estimated thickness
    (reference perturb.py:44-59)."""

    def __init__(self, amount: float = 1.0):
        self.amount = amount

    def __call__(self, morph: ImageMorphology) -> np.ndarray:
        radius = int(self.amount * morph.scale * morph.mean_thickness / 2.0)
        if radius == 0:
            return morph.binary_image.copy()
        return ndimage.binary_dilation(morph.binary_image, structure=disk(radius))


class Deformation(Perturbation):
    """Coordinate-warp perturbations (reference perturb.py:62-81)."""

    def __call__(self, morph: ImageMorphology) -> np.ndarray:
        h, w = morph.binary_image.shape
        yy, xx = np.mgrid[0:h, 0:w]
        xy = np.stack([xx.reshape(-1), yy.reshape(-1)], axis=1).astype(float)
        warped = self.warp(xy, morph)
        coords = np.stack(
            [warped[:, 1].reshape(h, w), warped[:, 0].reshape(h, w)], axis=0
        )
        out = ndimage.map_coordinates(
            morph.binary_image.astype(float), coords, order=1, mode="constant"
        )
        return out > 0.5

    def warp(self, xy: np.ndarray, morph: ImageMorphology) -> np.ndarray:
        raise NotImplementedError


class Swelling(Deformation):
    """Local radial power-transform swelling at a random skeleton point
    (reference perturb.py:84-113)."""

    def __init__(self, strength: float = 3, radius: float = 7, rng=None):
        self.strength = strength
        self.radius = radius
        self.loc_sampler = LocationSampler(rng=rng)

    def warp(self, xy: np.ndarray, morph: ImageMorphology) -> np.ndarray:
        centre = self.loc_sampler.sample(morph)[::-1].astype(float)
        radius = (self.radius * np.sqrt(morph.mean_thickness) / 2.0) * morph.scale
        offset_xy = xy - centre
        distance = np.hypot(*offset_xy.T)
        with np.errstate(divide="ignore", invalid="ignore"):
            weight = (distance / radius) ** (self.strength - 1)
        weight[distance > radius] = 1.0
        weight[~np.isfinite(weight)] = 0.0
        return centre + weight[:, None] * offset_xy


def _bresenham_line(p0, p1):
    """Integer pixel coordinates of the segment p0→p1 (skimage.draw.line)."""
    i0, j0 = int(p0[0]), int(p0[1])
    i1, j1 = int(p1[0]), int(p1[1])
    n = max(abs(i1 - i0), abs(j1 - j0)) + 1
    ii = np.round(np.linspace(i0, i1, n)).astype(int)
    jj = np.round(np.linspace(j0, j1, n)).astype(int)
    return ii, jj


class Fracture(Perturbation):
    """Pen-stroke fractures perpendicular to the skeleton
    (reference perturb.py:116-170)."""

    _ANGLE_WINDOW = 2
    _FRAC_EXTENSION = 0.5

    def __init__(self, thickness: float = 1.5, prune: float = 2,
                 num_frac: int = 3, rng=None):
        self.thickness = thickness
        self.prune = prune
        self.num_frac = num_frac
        self.loc_sampler = LocationSampler(prune, prune, rng=rng)
        self._rng = rng

    def __call__(self, morph: ImageMorphology) -> np.ndarray:
        up_thickness = self.thickness * morph.scale
        r = int(np.ceil((up_thickness - 1) / 2))
        brush = ~disk(r).astype(bool)
        frac_img = np.pad(morph.binary_image, pad_width=r, mode="constant",
                          constant_values=False)
        try:
            centres = self.loc_sampler.sample(morph, self.num_frac)
        except ValueError:  # overpruned skeleton: retry without pruning
            centres = LocationSampler(rng=self._rng).sample(
                morph, self.num_frac
            )
        for centre in centres:
            p0, p1 = self._endpoints(morph, centre)
            self._draw_line(frac_img, p0, p1, brush)
        if r == 0:
            return frac_img
        return frac_img[r:-r, r:-r]

    def _endpoints(self, morph, centre):
        angle = skeleton.get_angle(
            morph.skeleton, *centre, self._ANGLE_WINDOW * morph.scale
        )
        length = (
            morph.distance_map[centre[0], centre[1]]
            + self._FRAC_EXTENSION * morph.scale
        )
        angle += np.pi / 2.0  # perpendicular to the stroke
        normal = length * np.array([np.sin(angle), np.cos(angle)])
        p0 = (centre + normal).astype(int)
        p1 = (centre - normal).astype(int)
        return p0, p1

    @staticmethod
    def _draw_line(img, p0, p1, brush):
        h, w = brush.shape
        H, W = img.shape
        ii, jj = _bresenham_line(p0, p1)
        for i, j in zip(ii, jj):
            if 0 <= i and 0 <= j and i + h <= H and j + w <= W:
                img[i : i + h, j : j + w] &= brush
