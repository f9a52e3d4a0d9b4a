"""MNIST and Morpho-MNIST datasets, without pandas.

Counterpart of ``arvae_tpu/data/mnist.py``, with the same files under
the same root, ``<datasets root>/mnist_data/plain/``:
``{train,t10k}-images-idx3-ubyte.gz``, ``-labels-idx1-ubyte.gz`` and
``-morpho.csv`` (header ``digit_identity,area,length,thickness,slant,
width,height``). A cache written by either package loads in the other
as the same float32 arrays.

Data resolution order:
1. IDX archives at ``plain/`` (real Morpho-MNIST ones, when present);
2. otherwise the deterministic synthetic digit set
   (:mod:`arvae_tpu_torch.data.synthetic_digits`, the JAX package's
   images bit for bit), written there as IDX archives.

The morphometrics are measured (:mod:`.morphomnist`), not faked, on
first access, and cached as the CSV. A batch's labels are the 7
columns: the digit, then the six morphometrics.
"""

from __future__ import annotations

import contextlib
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from arvae_tpu_torch.data.device_data import DeviceSplit
from arvae_tpu_torch.data.dsprites import datasets_root
from arvae_tpu_torch.data.morphomnist import io as idx_io
from arvae_tpu_torch.data.morphomnist import native
from arvae_tpu_torch.data.morphomnist.measure import COLUMNS, measure_batch
from arvae_tpu_torch.data.synthetic_digits import generate_digit_set

# Synthetic set sizes (the JAX package's; its tests patch them)
SYNTH_TRAIN = 8192
SYNTH_TEST = 2048

MORPHO_COLUMNS = ["digit_identity"] + COLUMNS
# How the measuring pool starts its workers: a fresh interpreter each,
# never a fork of this process, whose threads (torch's, a CUDA
# context's) may hold locks a forked child would wait on forever.
POOL_START = "spawn"
# Images a measuring worker is worth: under this many the spawn costs
# more than it saves (about 7 ms an image on one core).
IMAGES_PER_WORKER = 512


# A measuring worker runs one image at a time on one core: BLAS threads
# of its own would only contend for the cores the other workers use.
_WORKER_ENV = {"OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


@contextlib.contextmanager
def _worker_env():
    """``_WORKER_ENV`` in the environment the workers spawned meanwhile
    inherit; this process's own settings restored after."""
    saved = {k: os.environ.get(k) for k in _WORKER_ENV}
    os.environ.update(_WORKER_ENV)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def measure_images(images: np.ndarray) -> np.ndarray:
    """(n, 6) float64 morphometrics of (n, H, W) images (uint8, or floats
    such as decoded digits), measured by up to one ``spawn`` worker a
    core when there are enough images. The thinning backend
    (``morphomnist/native.py``) is decided, and the native library built,
    here before any worker starts; the workers, with the same
    environment, make the same choice. A spawned worker imports the main
    module again, so a script that builds the set guards its entry point
    (``if __name__ == "__main__":``); a worker that cannot start raises
    ``BrokenProcessPool`` here."""
    native.backend()
    workers = min(os.cpu_count() or 1, -(-len(images) // IMAGES_PER_WORKER))
    if workers <= 1:
        return measure_batch(images)
    ctx = multiprocessing.get_context(POOL_START)
    with _worker_env(), ProcessPoolExecutor(workers, mp_context=ctx) as pool:
        return measure_batch(images, pool=pool, chunksize=64)


def _read_csv(path: str) -> np.ndarray:
    """The CSV's rows below its header as (rows, columns) float64."""
    with open(path) as fh:
        n_cols = len(fh.readline().split(","))
        rows = np.loadtxt(fh, delimiter=",", dtype=np.float64, ndmin=2)
    return rows.reshape(-1, n_cols)


def _write_csv(path: str, morpho: np.ndarray) -> None:
    """float32 columns under the 7-name header, each value in 9
    significant digits, which read back as the same float32."""
    np.savetxt(path, morpho, fmt="%.9g", delimiter=",",
               header=",".join(MORPHO_COLUMNS), comments="")


class MnistDataset:
    """Plain MNIST: float32 images (n, 1, 28, 28) in [0, 1] and int64
    digits, ``train`` and ``t10k``; morphometrics on first access."""

    def __init__(self, root: Optional[str] = None):
        root = os.path.abspath(root or os.path.join(datasets_root(), "mnist_data"))
        self.root_dir = os.path.join(root, "plain")
        self._arrays = {kind: self._load_or_generate(kind) for kind in ("train", "t10k")}
        self._morpho: Dict[str, np.ndarray] = {}

    def arrays(self, kind: str) -> Tuple[np.ndarray, np.ndarray]:
        """(images, digits) of ``kind`` (``train`` or ``t10k``)."""
        return self._arrays[kind]

    # Measuring a whole set costs a pool's seconds on a cold cache: pay it
    # on the first morphometric access (MorphoMnistDataset's constructor,
    # not the judge's CLI, which reads digits only).
    def _full(self, kind: str):
        images, labels = self._arrays[kind]
        if kind not in self._morpho:
            self._morpho[kind] = self._load_or_measure_morpho(kind, images, labels)
        return images, labels, self._morpho[kind]

    @property
    def _full_train(self):
        return self._full("train")

    @property
    def _full_test(self):
        return self._full("t10k")

    # -- loading ------------------------------------------------------------

    def _paths(self, kind: str) -> Tuple[str, str, str]:
        return (
            os.path.join(self.root_dir, f"{kind}-images-idx3-ubyte.gz"),
            os.path.join(self.root_dir, f"{kind}-labels-idx1-ubyte.gz"),
            os.path.join(self.root_dir, f"{kind}-morpho.csv"),
        )

    def _load_or_generate(self, kind: str):
        img_p, lab_p, mor_p = self._paths(kind)
        have_img, have_lab = os.path.exists(img_p), os.path.exists(lab_p)
        if have_img != have_lab:
            # never overwrite the surviving half of a real corpus with
            # synthetic data
            missing = lab_p if have_img else img_p
            raise FileNotFoundError(
                f"incomplete MNIST archive for {kind!r}: {missing} is "
                "missing — restore it, or remove the other archive to "
                "regenerate the synthetic set")
        if not have_img:
            self._generate_synthetic(kind)
            if os.path.exists(mor_p):
                # measured from whatever images were there before: stale
                os.remove(mor_p)
        images = idx_io.load_idx(img_p)
        images = np.expand_dims(images, 1).astype(np.float32) / 255.0
        labels = idx_io.load_idx(lab_p).astype(np.int64)
        return images, labels

    def _load_or_measure_morpho(self, kind: str, images, labels) -> np.ndarray:
        _, _, mor_p = self._paths(kind)
        morpho = None
        if os.path.exists(mor_p):
            # a CSV measured from another image set (the synthetic pair
            # replaced by real archives) must not load as misaligned labels
            morpho = _read_csv(mor_p)
            if len(morpho) != len(images):
                print(f"morphometrics cache {mor_p} does not match the "
                      f"{len(images)}-image archive; re-measuring")
                os.remove(mor_p)
                morpho = None
        if morpho is None:
            print(f"measuring morphometrics for {kind} ({len(images)} images)...")
            measured = measure_images((images[:, 0] * 255).astype(np.uint8))
            morpho = np.concatenate([labels[:, None].astype(np.float32),
                                     measured.astype(np.float32)], 1)
            _write_csv(mor_p, morpho)
        morpho = morpho.astype(np.float32)
        # the trainer's reg dims index the morphometrics as columns 1..6,
        # column 0 the digit: an older 6-column cache gains its digits
        if morpho.shape[1] == 6:
            morpho = np.concatenate([labels[:, None].astype(np.float32), morpho], 1)
        return morpho

    def _generate_synthetic(self, kind: str) -> None:
        os.makedirs(self.root_dir, exist_ok=True)
        n = SYNTH_TRAIN if kind == "train" else SYNTH_TEST
        seed = 0 if kind == "train" else 1
        print(f"generating synthetic digit set '{kind}' (n={n})...")
        imgs, labels = generate_digit_set(n, seed=seed)
        img_p, lab_p, _ = self._paths(kind)
        idx_io.save_idx((imgs[:, 0] * 255).astype(np.uint8), img_p)
        idx_io.save_idx(labels.astype(np.uint8), lab_p)


class MorphoMnistDataset(MnistDataset):
    """MNIST with its 7 morphometry columns, measured in the constructor;
    device splits of uint8 pixel rows with those columns as labels."""

    def __init__(self, root: Optional[str] = None):
        super().__init__(root=root)
        self.train_arrays = self._full_train
        self.val_arrays = self._full_test

    @staticmethod
    def _device_split(arrays, device: torch.device, ctx=None) -> DeviceSplit:
        images, _, morpho = arrays
        rows = (images[:, 0] * 255).astype(np.uint8).reshape(len(images), -1)
        return DeviceSplit(rows, morpho, (1, 28, 28), "bytes", device, ctx)

    def device_splits(self, device: torch.device, split=(0.70, 0.20), ctx=None
                      ) -> Tuple[DeviceSplit, DeviceSplit]:
        """(train, val) on ``device`` over the data axis ``ctx``: the train
        files and the t10k files; the files' fixed split stands in for
        ``split``."""
        del split
        return (self._device_split(self.train_arrays, device, ctx),
                self._device_split(self.val_arrays, device, ctx))

    def device_eval_split(self, device: torch.device, split=None) -> DeviceSplit:
        """The eval split: the t10k files only."""
        del split
        return self._device_split(self.val_arrays, device)
