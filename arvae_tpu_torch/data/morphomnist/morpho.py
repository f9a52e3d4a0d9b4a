"""Morphological image analysis (host-side, numpy/scipy).

A copy of ``arvae_tpu/data/morphomnist/morpho.py``, which measures like
the Morpho-MNIST library without skimage:

- upscaling: ``scipy.ndimage.zoom`` (cubic) + gaussian smoothing, the
  same smoothing window skimage's ``pyramid_expand`` uses
  (sigma = 2 * upscale / 6).
- skeleton: Zhang–Suen thinning, by the process's backend
  (:mod:`.native`): the C++ batch thinning of ``csrc/morpho_native.cpp``
  where g++ builds it, else the numpy one here, which gives the same
  skeleton bit for bit and is the tests' plain version.
- distance map: ``scipy.ndimage.distance_transform_edt``.

Measured quantities: area, stroke length, mean thickness, slant via
image moments, and the bounding parallelogram's width and height;
moments through the weighted mean and covariance of the pixel
coordinate cloud, extent CDFs through one weighted histogram + cumsum.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy import ndimage

from arvae_tpu_torch.data.morphomnist import native

_SKEL_LEN_MASK = np.array(
    [[0.0, 0.0, 0.0], [0.0, 0.0, 1.0], [np.sqrt(2.0), 1.0, np.sqrt(2.0)]]
)


def zhang_suen_thin(img: np.ndarray, max_iter: int = 200) -> np.ndarray:
    """Binary skeleton via Zhang–Suen thinning, by :func:`native.backend`:
    the native batch thinning, or :func:`zhang_suen_thin_numpy`."""
    if native.backend() == "native":
        return native.zhang_suen_thin_batch(img[None], max_iter=max_iter)[0]
    return zhang_suen_thin_numpy(img, max_iter)


def zhang_suen_thin_numpy(img: np.ndarray, max_iter: int = 200) -> np.ndarray:
    """Binary skeleton via Zhang–Suen thinning (vectorized numpy)."""
    img = img.astype(bool).copy()

    def neighbors(a):
        p = np.pad(a, 1, mode="constant").astype(np.uint8)
        # P2..P9 clockwise starting north
        P2 = p[:-2, 1:-1]
        P3 = p[:-2, 2:]
        P4 = p[1:-1, 2:]
        P5 = p[2:, 2:]
        P6 = p[2:, 1:-1]
        P7 = p[2:, :-2]
        P8 = p[1:-1, :-2]
        P9 = p[:-2, :-2]
        return P2, P3, P4, P5, P6, P7, P8, P9

    for _ in range(max_iter):
        changed = False
        for step in (0, 1):
            P2, P3, P4, P5, P6, P7, P8, P9 = neighbors(img)
            B = (
                P2.astype(np.int32) + P3 + P4 + P5 + P6 + P7 + P8 + P9
            )
            seq = [P2, P3, P4, P5, P6, P7, P8, P9, P2]
            A = np.zeros_like(B)
            for k in range(8):
                A += ((seq[k] == 0) & (seq[k + 1] == 1)).astype(np.int32)
            if step == 0:
                cond = (P2 * P4 * P6 == 0) & (P4 * P6 * P8 == 0)
            else:
                cond = (P2 * P4 * P8 == 0) & (P2 * P6 * P8 == 0)
            to_delete = img & (B >= 2) & (B <= 6) & (A == 1) & cond
            if to_delete.any():
                img[to_delete] = False
                changed = True
        if not changed:
            break
    return img


def _upscale(img: np.ndarray, scale: int) -> np.ndarray:
    """Cubic upscale + gaussian smoothing (skimage pyramid_expand analog)."""
    up = ndimage.zoom(img.astype(float), scale, order=3, mode="reflect")
    sigma = 2.0 * scale / 6.0
    up = ndimage.gaussian_filter(up, sigma=sigma)
    return np.clip(up, 0.0, None)


def _process_img_morph(img, threshold=0.5, scale=1):
    img = np.asarray(img, dtype=float)
    if scale > 1:
        img = _upscale(img, scale)
    img_min, img_max = img.min(), img.max()
    bin_img = img >= img_min + (img_max - img_min) * threshold
    skel = zhang_suen_thin(bin_img)
    dist_map = ndimage.distance_transform_edt(bin_img)
    return img, bin_img, skel, dist_map


class ImageMorphology:
    """Morphological processing pipeline for one image
    (reference morpho.py:20-102)."""

    def __init__(self, image, threshold: float = 0.5, scale: int = 1):
        self.image = np.asarray(image)
        self.threshold = threshold
        self.scale = scale
        (
            self.hires_image,
            self.binary_image,
            self.skeleton,
            self.distance_map,
        ) = _process_img_morph(self.image, threshold, scale)

    @property
    def area(self) -> float:
        return float(self.binary_image.sum()) / self.scale**2

    @property
    def stroke_length(self) -> float:
        skel = self.skeleton.astype(float)
        conv = ndimage.correlate(skel, _SKEL_LEN_MASK, mode="constant")
        up_length = float(np.einsum("ij,ij->", conv, skel))
        return up_length / self.scale

    @property
    def mean_thickness(self) -> float:
        if not self.skeleton.any():
            return 0.0
        return 2.0 * float(np.mean(self.distance_map[self.skeleton])) / self.scale

    @property
    def median_thickness(self) -> float:
        if not self.skeleton.any():
            return 0.0
        return 2.0 * float(np.median(self.distance_map[self.skeleton])) / self.scale


class ImageMoments:
    """Mass, centroid, and central covariance of a grayscale image.

    Treats the image as a 2-D probability mass over pixel-center
    coordinates (x = column index, y = row index) and derives the usual
    shape statistics from the weighted mean and weighted covariance.
    Capability parity with the reference's moments class
    (``morpho.py:105-175``); computed here via ``np.average``/``np.cov``
    over the flattened coordinate cloud rather than raw-moment sums.
    """

    def __init__(self, img: np.ndarray):
        weights = np.asarray(img, dtype=float).ravel()
        n_rows, n_cols = np.asarray(img).shape
        grid_y, grid_x = np.mgrid[0:n_rows, 0:n_cols]
        coords = np.stack([grid_x.ravel(), grid_y.ravel()])
        self.m00 = float(weights.sum())
        mean = np.average(coords, axis=1, weights=weights)
        cov = np.cov(coords, aweights=weights, ddof=0)
        self.m10, self.m01 = float(mean[0]), float(mean[1])
        self.u20 = float(cov[0, 0])
        self.u11 = float(cov[0, 1])
        self.u02 = float(cov[1, 1])

    @property
    def centroid(self) -> Tuple[float, float]:
        return self.m10, self.m01

    @property
    def covariance(self) -> Tuple[float, float, float]:
        return self.u20, self.u11, self.u02

    @property
    def axis_lengths(self) -> Tuple[float, float]:
        """(major, minor) std-dev along the principal axes."""
        eigs = np.linalg.eigvalsh(
            np.array([[self.u20, self.u11], [self.u11, self.u02]])
        )
        minor, major = np.sqrt(np.clip(eigs, 0.0, None))
        return float(major), float(minor)

    @property
    def angle(self) -> float:
        """Orientation of the major principal axis (standard
        second-moment formula)."""
        return np.arctan2(2.0 * self.u11, self.u20 - self.u02) / 2.0

    @property
    def horizontal_shear(self) -> float:
        """Regression slope of x on y: how far the shape leans per row."""
        return self.u11 / self.u02

    @property
    def vertical_shear(self) -> float:
        return self.u11 / self.u20


def _mass_cdf(values: np.ndarray, weights: np.ndarray, n_bins: int):
    """``cdf[t] = (mass with value < t) / total`` for integer t in
    [0, n_bins), via one weighted histogram + cumsum.

    A value v is first counted at the smallest integer t with v < t,
    i.e. bin floor(v)+1; everything at or beyond n_bins never lands in
    the returned range.
    """
    first_bin = np.clip(np.floor(values).astype(int) + 1, 0, n_bins)
    per_bin = np.bincount(first_bin, weights=weights, minlength=n_bins + 1)
    return np.cumsum(per_bin)[:n_bins] / weights.sum()


def bounding_parallelogram(img, frac: float, moments: ImageMoments = None):
    """Shear-aligned bounding parallelogram of an image's mass.

    Trims ``frac`` of the total mass (split between the two sides of
    each axis) for outlier robustness, measuring horizontal extent
    along the shear direction so slanted strokes aren't overcounted.
    Returns the four ``(x, y)`` corners clockwise from top-left —
    capability parity with reference ``morpho.py:193-233``.
    """
    img = np.asarray(img, dtype=float)
    n_rows, n_cols = img.shape
    if moments is None:
        moments = ImageMoments(img)
    y_mid = moments.centroid[1]
    shear = moments.horizontal_shear

    rows = np.arange(n_rows, dtype=float)
    cols = np.arange(n_cols, dtype=float)
    weights = img.ravel()
    # Pixel-center x, shifted back along the shear so columns compare on
    # a common (un-slanted) axis.
    sheared_x = (cols[None, :] + 0.5) - shear * (rows[:, None] - y_mid)
    hcdf = _mass_cdf(sheared_x.ravel(), weights, n_cols)
    vcdf = _mass_cdf(
        np.broadcast_to(rows[:, None], img.shape).ravel(), weights, n_rows
    )

    q = frac / 2.0  # half the trimmed mass on each side
    left, right = np.interp([q, 1.0 - q], hcdf, cols)
    top, bottom = np.interp([q, 1.0 - q], vcdf, rows)

    def _corner(x_edge, y_edge):
        # Map the un-slanted edge position back onto the sheared image.
        return np.array([x_edge + shear * (y_edge - y_mid), y_edge])

    return (
        _corner(left, top),
        _corner(right, top),
        _corner(right, bottom),
        _corner(left, bottom),
    )
