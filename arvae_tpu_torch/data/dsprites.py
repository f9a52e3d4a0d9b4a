"""dSprites dataset: real-archive loader + procedural generator (numpy).

A numpy-only copy of ``arvae_tpu/data/dsprites.py`` (that package's
``data`` imports pandas). It renders the same rows byte for byte, reads
and writes the same cache file under the same datasets root, prefers the
published ``.npz`` when it is present, and orders rows by the same
seed-0 permutation, so both packages train on identical splits.

The generator renders 1 color × 3 shapes (square, ellipse, heart) × 6
scales × 40 orientations × 32×32 positions with 4× supersampling,
thresholded to binary; images are kept bit-packed (512 uint8 per
64×64 image).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from arvae_tpu_torch.data.device_data import DeviceSplit

DSPRITES_NPZ = "dsprites_ndarray_co1sh3sc6or40x32y32_64x64.npz"

FULL_FACTOR_SIZES = (1, 3, 6, 40, 32, 32)  # color, shape, scale, orient, posX, posY
SHORT_FACTOR_SIZES = (1, 3, 3, 10, 16, 16)

_S = 4  # supersampling factor
_PAD = 176  # padded canvas (px): center±(32+52) must stay in bounds
_IMG = 64


def datasets_root() -> str:
    """``ARVAE_DATASETS_DIR``, else ``datasets/`` at the repo root — the
    same directory the JAX package resolves, so the caches are shared."""
    return os.environ.get(
        "ARVAE_DATASETS_DIR",
        os.path.normpath(os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            os.pardir,
            "datasets",
        )),
    )


def _factor_values(factor_sizes: Sequence[int]) -> Tuple[np.ndarray, ...]:
    c, sh, sc, orr, px, py = factor_sizes
    return (
        np.ones(c),
        np.arange(1, sh + 1, dtype=np.float64),
        np.linspace(0.5, 1.0, sc),
        np.linspace(0.0, 2.0 * np.pi, orr),
        np.linspace(0.0, 1.0, px),
        np.linspace(0.0, 1.0, py),
    )


def _shape_mask(shape_id: int, scale: float, theta: float) -> np.ndarray:
    """Renders one (shape, scale, orientation) on the padded hi-res canvas,
    centered. Returns float mask in [0, 1] at supersampled resolution."""
    n = _PAD * _S
    half = n / 2.0
    yy, xx = np.mgrid[0:n, 0:n]
    # canonical coords: sprite half-extent in pixels at scale 1 is 9
    r = 9.0 * scale * _S
    u = (xx - half + 0.5) / r
    v = (yy - half + 0.5) / r
    cu = np.cos(theta) * u + np.sin(theta) * v
    cv = -np.sin(theta) * u + np.cos(theta) * v
    if shape_id == 1:  # square
        m = (np.abs(cu) <= 0.82) & (np.abs(cv) <= 0.82)
    elif shape_id == 2:  # ellipse
        m = (cu / 1.0) ** 2 + (cv / 0.62) ** 2 <= 1.0
    elif shape_id == 3:  # heart
        hu, hv = cu * 1.3, -cv * 1.3 + 0.25
        m = (hu**2 + hv**2 - 1.0) ** 3 - (hu**2) * (hv**3) <= 0.0
    else:
        raise ValueError(f"bad shape id {shape_id}")
    return m.astype(np.float32)


def _phase_downsample(hi: np.ndarray, rx: int, ry: int) -> np.ndarray:
    """Shift by (rx, ry) subpixels then 4×4 block-mean to _PAD×_PAD."""
    if rx or ry:
        hi = np.roll(hi, shift=(ry, rx), axis=(0, 1))
    return hi.reshape(_PAD, _S, _PAD, _S).mean(axis=(1, 3))


def generate_dsprites(
    factor_sizes: Sequence[int] = FULL_FACTOR_SIZES,
    verbose: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Procedurally renders the dataset.

    Returns (packed_images (N, 512) uint8 bit-packed 64×64, latents
    (N, 6) float32) in row-major factor order, the archive's layout.
    """
    vals = _factor_values(factor_sizes)
    _, n_sh, n_sc, n_or, n_px, n_py = factor_sizes
    n_total = int(np.prod(factor_sizes))
    packed = np.zeros((n_total, _IMG * _IMG // 8), dtype=np.uint8)

    # Sprite centers span [12, 52] px: the position grid.
    cx_all = 12.0 + vals[4] * 40.0
    cy_all = 12.0 + vals[5] * 40.0

    idx = 0
    for sh_i in range(n_sh):
        for sc_i in range(n_sc):
            for or_i in range(n_or):
                hi = _shape_mask(sh_i + 1, vals[2][sc_i], vals[3][or_i])
                # 16 phase-shifted downsampled canvases
                phases = {
                    (rx, ry): _phase_downsample(hi, rx, ry)
                    for rx in range(_S)
                    for ry in range(_S)
                }
                for px_i in range(n_px):
                    # The sprite sits at canvas center; crop a 64-window
                    # starting at (center - cx) so the sprite lands at cx.
                    sx = int(round((_PAD / 2.0 - cx_all[px_i]) * _S))
                    kx, rx = divmod(sx, _S)
                    for py_i in range(n_py):
                        sy = int(round((_PAD / 2.0 - cy_all[py_i]) * _S))
                        ky, ry = divmod(sy, _S)
                        # residual subpixels: shift content left/up by r
                        canvas = phases[(-rx % _S, -ry % _S)]
                        extra_x = 1 if rx else 0
                        extra_y = 1 if ry else 0
                        x0, y0 = kx + extra_x, ky + extra_y
                        crop = canvas[y0 : y0 + _IMG, x0 : x0 + _IMG]
                        img = crop > 0.5
                        packed[idx] = np.packbits(img)
                        idx += 1
                if verbose and or_i % 10 == 0:
                    print(
                        f"dsprites gen: shape {sh_i+1}/{n_sh} scale {sc_i+1}/{n_sc}"
                        f" orient {or_i+1}/{n_or}"
                    )

    grids = np.meshgrid(*vals, indexing="ij")
    latents = np.stack([g.reshape(-1) for g in grids], axis=1).astype(np.float32)
    return packed, latents


class DspritesDataset:
    """dSprites rows (bit-packed images, (N, 6) float32 latents) in the
    seed-0 order, with device-resident train/val splits."""

    def __init__(
        self,
        root: Optional[str] = None,
        factor_sizes: Sequence[int] = FULL_FACTOR_SIZES,
        seed: int = 0,
    ):
        if root is None:
            root = os.path.join(datasets_root(), "dsprites")
        self.root = os.path.abspath(root)
        self.factor_sizes = tuple(factor_sizes)
        self.seed = seed
        self.packed: Optional[np.ndarray] = None
        self.latents: Optional[np.ndarray] = None
        self._order: Optional[np.ndarray] = None

    def _cache_path(self) -> str:
        tag = "x".join(map(str, self.factor_sizes))
        return os.path.join(self.root, f"dsprites_synth_{tag}.npz")

    def load_dataset(self) -> None:
        if self.packed is not None:
            return
        real = os.path.join(self.root, DSPRITES_NPZ)
        cache = self._cache_path()
        if os.path.exists(real) and self.factor_sizes == FULL_FACTOR_SIZES:
            data = np.load(real, encoding="bytes", allow_pickle=True)
            imgs = data["imgs"].astype(np.uint8)
            self.packed = np.packbits(imgs.reshape(len(imgs), -1), axis=1)
            self.latents = data["latents_values"].astype(np.float32)
        elif os.path.exists(cache):
            data = np.load(cache)
            self.packed = data["packed"]
            self.latents = data["latents"]
        else:
            self.packed, self.latents = generate_dsprites(self.factor_sizes)
            os.makedirs(self.root, exist_ok=True)
            np.savez_compressed(
                cache, packed=self.packed, latents=self.latents
            )
        rng = np.random.RandomState(self.seed)
        self._order = rng.permutation(len(self.packed))

    def device_splits(self, device: torch.device, split=(0.70, 0.20), ctx=None
                      ) -> Tuple[DeviceSplit, DeviceSplit]:
        """(train, val) splits uploaded once to ``device``, bit-packed,
        over the data axis ``ctx`` (``DeviceSplit``'s)."""
        self.load_dataset()
        n = len(self.packed)
        a, b = split
        i0, i1 = int(a * n), int((a + b) * n)
        order = self._order

        def make(sl):
            return DeviceSplit(self.packed[order[sl]],
                               self.latents[order[sl]].astype(np.float32),
                               (1, _IMG, _IMG), "packed", device, ctx)

        return make(slice(0, i0)), make(slice(i0, i1))

    def device_eval_split(self, device: torch.device, split=(0.80, 0.15)) -> DeviceSplit:
        """Device-resident eval split: the rows past ``sum(split)`` of the
        seed-0 order (the host loaders' test split), bit-packed."""
        self.load_dataset()
        n = len(self.packed)
        rows = self._order[int(sum(split) * n):]
        return DeviceSplit(self.packed[rows], self.latents[rows].astype(np.float32),
                           (1, _IMG, _IMG), "packed", device)
