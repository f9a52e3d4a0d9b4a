"""Batch morphometric measurement, without pandas.

Counterpart of ``arvae_tpu/data/morphomnist/measure.py``: the same six
morphometrics (area, length, thickness, slant, width, height) an image,
measured the same way, but ``measure_batch`` returns an (n, 6) float64
array in ``COLUMNS`` order in place of a ``pandas.DataFrame``. A pool
passed to it (a ``multiprocessing`` pool or a process executor, anything
with ``map(fn, iterable, chunksize=)``) must start its workers from an
explicit ``spawn`` or ``forkserver`` context (``arvae_tpu_torch.data.mnist``
makes one): a worker forked after threads have started can deadlock on
a lock one of them held.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from arvae_tpu_torch.data.morphomnist.morpho import (ImageMoments, ImageMorphology,
                                                     bounding_parallelogram)

COLUMNS = ["area", "length", "thickness", "slant", "width", "height"]


def measure_image(image, threshold: float = 0.5, scale: int = 4,
                  bound_frac: float = 0.02, verbose: bool = False):
    """The six morphometrics of one image; all zero for a blank one."""
    image = np.asarray(image)
    if image.max() <= 0:
        return (0.0,) * 6
    morph = ImageMorphology(image, threshold, scale)
    moments = ImageMoments(morph.hires_image)
    thickness = morph.mean_thickness
    area = morph.area
    length = morph.stroke_length
    slant = float(np.arctan(-moments.horizontal_shear))

    corners = bounding_parallelogram(morph.hires_image, bound_frac, moments)
    width = (corners[1][0] - corners[0][0]) / morph.scale
    height = (corners[-1][1] - corners[0][1]) / morph.scale

    if verbose:
        print(
            f"Area {area:.1f}  Length {length:.1f}  Thickness {thickness:.2f}"
            f"  Slant {np.rad2deg(slant):.0f}deg  Dims {width:.1f}x{height:.1f}"
        )
    return area, length, thickness, slant, width, height


def _measure_image_unpack(arg):
    return measure_image(*arg)


def measure_batch(images, threshold: float = 0.5, scale: int = 4,
                  bound_frac: float = 0.02, pool: Optional[Any] = None,
                  chunksize: int = 100) -> np.ndarray:
    """(n, 6) float64 morphometrics of ``images`` in ``COLUMNS`` order,
    measured in ``pool`` when one is given, in order either way."""
    images = np.asarray(images)
    args = ((img, threshold, scale, bound_frac, False) for img in images)
    if pool is None:
        results = list(map(_measure_image_unpack, args))
    else:
        results = list(pool.map(_measure_image_unpack, args, chunksize=chunksize))
    return np.asarray(results, dtype=np.float64).reshape(len(images), len(COLUMNS))
