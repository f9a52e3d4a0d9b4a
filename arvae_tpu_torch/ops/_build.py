"""Build and load the port's hand-written CUDA libraries.

Each ``csrc/<name>.cu`` is compiled on first use with ``nvcc`` for
``sm_90a`` into ``arvae_tpu_torch/_build/<hash>/lib<name>.so`` and bound
with ``ctypes``. The hash covers the source, every shared header in
``csrc/`` and the flags, so an edit to any of them builds anew.
Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME/bin")


def source(name: str) -> Path:
    return CSRC / f"{name}.cu"


def library_path(name: str) -> Path:
    key = hashlib.sha256(source(name).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        key.update(header.name.encode() + header.read_bytes())
    key.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / key.hexdigest()[:16] / f"lib{name}.so"


def build(name: str) -> Tuple[Path, float, str]:
    """Compiles ``csrc/<name>.cu`` if it is not built yet.

    Returns (path, build seconds (0.0 when already built), nvcc's
    output, which holds ptxas's register and spill report)."""
    out = library_path(name)
    if out.exists():
        return out, 0.0, ""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(source(name))],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source(name)}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out, time.perf_counter() - t0, proc.stdout + proc.stderr


_loaded: Dict[str, ctypes.CDLL] = {}


def load(name: str) -> ctypes.CDLL:
    """The built library, loaded once per process. Every library exports
    ``<name>_error_string(int)``, which is bound here."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)[0]))
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def raise_on(lib: ctypes.CDLL, name: str, err: int, what: str) -> None:
    """Raises if a C entry returned a CUDA error (a refused launch)."""
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({err})")


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on the tensor's device, as an int."""
    return torch.cuda.current_stream(t.device).cuda_stream
