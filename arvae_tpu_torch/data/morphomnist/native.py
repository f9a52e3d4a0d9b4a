"""The native Zhang–Suen batch thinning, the counterpart of
``arvae_tpu/data/morphomnist/native.py``: ``arvae_tpu_torch/csrc/
morpho_native.cpp`` built with g++ at first use and bound with ctypes.

The build, ``g++ -O3 -fopenmp -shared -fPIC``, writes
``arvae_tpu_torch/_build/<hash>/libmorpho_native.so`` (the port's
gitignored build root); the hash covers the source and the flags, so an
edit builds anew. There is no ``-march=native``: a library built on one
host must load on another CPU, and the thinning is integer work whose
result no instruction set changes. The library is written to a
temporary file and renamed into place, so processes building at once
never load a half-written one; ``data/mnist.py::measure_images`` builds
it in the parent before its workers start.

Which backend thins (:func:`backend`):

- ``ARVAE_NO_NATIVE`` set to anything but the empty string (the JAX
  package reads the same variable): numpy; spawned workers inherit it;
- no ``g++`` on the PATH: numpy, after one warning a process;
- otherwise the native library. A build that fails raises with the
  compiler's stderr; nothing falls back to numpy after a failure.

Both backends give the same skeleton bit for bit
(``tests/test_torch_morpho_native.py``). Importing this module builds
nothing.

The measuring path (``morpho.zhang_suen_thin``) thins one image a call,
on one thread: the source starts no OpenMP team for one image. Only
the tests and ``chip_smoke.py``'s timing thin a batch of several, over
an OpenMP team; ``-fopenmp`` and the batch API are kept as the JAX
package's source has them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import warnings
from pathlib import Path
from typing import Optional

import numpy as np

# ops/_build.py's build root, named here again: importing that module
# would import torch into every measuring worker
_PKG = Path(__file__).resolve().parents[2]
SOURCE = _PKG / "csrc" / "morpho_native.cpp"
BUILD_ROOT = _PKG / "_build"
CXX_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC")
ABI_VERSION = 1
NO_NATIVE_ENV = "ARVAE_NO_NATIVE"

_LOCK = threading.Lock()
_BACKEND: Optional[str] = None
_LIB: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    key = hashlib.sha256(SOURCE.read_bytes())
    key.update(" ".join(CXX_FLAGS).encode())
    return BUILD_ROOT / key.hexdigest()[:16] / "libmorpho_native.so"


def build(cxx: str) -> Path:
    """Compiles the source with ``cxx`` if it is not built yet → the
    library's path. Raises RuntimeError with the compiler's stderr."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed on {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.zhang_suen_thin_batch.argtypes = [u8p, u8p] + [ctypes.c_int] * 4
    lib.zhang_suen_thin_batch.restype = None
    lib.morpho_native_abi_version.argtypes = []
    lib.morpho_native_abi_version.restype = ctypes.c_int
    version = lib.morpho_native_abi_version()
    if version != ABI_VERSION:
        raise RuntimeError(f"{path}: ABI version {version}, expected {ABI_VERSION}")
    return lib


def backend() -> str:
    """``"native"`` or ``"numpy"``: which thinning this process runs now.
    ``ARVAE_NO_NATIVE`` is read on every call; the library is built and
    loaded on the first call that wants it."""
    global _BACKEND, _LIB
    if os.environ.get(NO_NATIVE_ENV):
        return "numpy"
    with _LOCK:
        if _BACKEND is None:
            cxx = shutil.which("g++")
            if cxx is None:
                warnings.warn("g++ is not on the PATH: Zhang–Suen thinning runs in "
                              "numpy", RuntimeWarning, stacklevel=2)
                _BACKEND = "numpy"
            else:
                _LIB = _load(build(cxx))
                _BACKEND = "native"
        return _BACKEND


def zhang_suen_thin_batch(images: np.ndarray, max_iter: int = 200) -> np.ndarray:
    """(N, H, W) images → their thinned (N, H, W) bool skeletons, any
    nonzero pixel foreground (as the numpy path's ``astype(bool)``).
    Raises unless :func:`backend` is ``"native"``."""
    if backend() != "native":
        raise RuntimeError("the native thinning is not this process's backend")
    imgs = np.ascontiguousarray(np.asarray(images).astype(bool).astype(np.uint8))
    if imgs.ndim != 3:
        raise ValueError(f"expected (N, H, W) images, got shape {imgs.shape}")
    n, h, w = imgs.shape
    out = np.empty_like(imgs)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    _LIB.zhang_suen_thin_batch(imgs.ctypes.data_as(u8p), out.ctypes.data_as(u8p),
                               n, h, w, max_iter)
    return out.astype(bool)
