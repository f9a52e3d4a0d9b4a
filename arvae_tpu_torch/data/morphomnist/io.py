"""IDX (MNIST) file IO: a copy of ``arvae_tpu/data/morphomnist/io.py``
(that package's ``data`` imports pandas), so both packages read and
write the same archives."""

from __future__ import annotations

import gzip
import struct

import numpy as np

_DTYPE_CODES = {
    0x08: np.uint8,
    0x09: np.int8,
    0x0B: np.int16,
    0x0C: np.int32,
    0x0D: np.float32,
    0x0E: np.float64,
}
_REV_CODES = {np.dtype(v): k for k, v in _DTYPE_CODES.items()}


def _open(path, mode="rb"):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def load_idx(path: str) -> np.ndarray:
    """Reads an (optionally gzipped) IDX-format array."""
    with _open(path, "rb") as f:
        zeros, dtype_code, ndim = struct.unpack(">HBB", f.read(4))
        if zeros != 0:
            raise ValueError(f"invalid IDX magic in {path}")
        dtype = _DTYPE_CODES[dtype_code]
        shape = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.dtype(dtype).newbyteorder(">"))
    return data.reshape(shape).astype(dtype)


def save_idx(arr: np.ndarray, path: str) -> None:
    """Writes an array in (optionally gzipped) IDX format."""
    arr = np.ascontiguousarray(arr)
    code = _REV_CODES[arr.dtype]
    with _open(path, "wb") as f:
        f.write(struct.pack(">HBB", 0, code, arr.ndim))
        f.write(struct.pack(f">{arr.ndim}I", *arr.shape))
        f.write(arr.astype(arr.dtype.newbyteorder(">")).tobytes())
