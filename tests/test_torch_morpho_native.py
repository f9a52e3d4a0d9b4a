"""The port's native Zhang–Suen thinning (``csrc/morpho_native.cpp``
through ``data/morphomnist/native.py``) against the numpy thinning, the
port's and the JAX package's ``_zhang_suen_thin_numpy``: the skeletons
bit for bit on the binary images of synthetic digits upscaled 2× and
4×, one image at a time and as one OpenMP batch; ``measure_images``
bitwise equal under both backends, serially and through spawn workers;
and how the backend is chosen: ``ARVAE_NO_NATIVE``, a missing g++ (one
warning, numpy), a compiler error (raised with its stderr), a build
left in place atomically. Tolerances: none, every comparison is exact.
"""

import shutil
import warnings

import numpy as np
import pytest

from arvae_tpu.data.morphomnist.morpho import _zhang_suen_thin_numpy as jax_thin_numpy
from arvae_tpu_torch.data import mnist
from arvae_tpu_torch.data.morphomnist import morpho, native
from arvae_tpu_torch.data.synthetic_digits import generate_digit_set


@pytest.fixture
def native_lib(monkeypatch):
    """The native backend, built from the port's source (g++ is needed)."""
    monkeypatch.delenv(native.NO_NATIVE_ENV, raising=False)
    if shutil.which("g++") is None:
        pytest.skip("no g++ on the PATH: the native thinning cannot be built here")
    assert native.backend() == "native"
    assert native.library_path().exists()


def _binary_images(scale, n=10, seed=3):
    imgs, _ = generate_digit_set(n, seed=seed)
    return [morpho.ImageMorphology((img * 255).astype(np.uint8), scale=scale).binary_image
            for img in imgs[:, 0]]


@pytest.mark.parametrize("scale", [2, 4])
def test_native_skeleton_is_the_numpy_skeleton(native_lib, scale):
    bins = _binary_images(scale)
    want = [morpho.zhang_suen_thin_numpy(b) for b in bins]
    for b, w in zip(bins, want):
        np.testing.assert_array_equal(jax_thin_numpy(b), w)
        got = native.zhang_suen_thin_batch(b[None])[0]
        assert got.dtype == bool and got.shape == b.shape
        np.testing.assert_array_equal(got, w)
        np.testing.assert_array_equal(morpho.zhang_suen_thin(b), w)  # the dispatch
    # one batch, thinned in parallel, image for image the same
    np.testing.assert_array_equal(native.zhang_suen_thin_batch(np.stack(bins)),
                                  np.stack(want))
    assert any(w.sum() < b.sum() for b, w in zip(bins, want))


def test_native_reads_any_nonzero_pixel_as_foreground(native_lib):
    gray = np.random.RandomState(0).rand(4, 40, 40)
    gray[gray < 0.4] = 0.0  # values in (0, 1) stay foreground, as astype(bool)
    for img in gray:
        np.testing.assert_array_equal(native.zhang_suen_thin_batch(img[None])[0],
                                      morpho.zhang_suen_thin_numpy(img))
    with pytest.raises(ValueError):
        native.zhang_suen_thin_batch(gray[0])


def _decoded_like(n=16, seed=4):
    """uint8 digits and float digits in [0, 1] as a decoder gives them."""
    imgs, _ = generate_digit_set(n, seed=seed)
    noisy = np.clip(imgs[:, 0] + 0.05 * np.random.RandomState(seed).randn(n, 28, 28), 0, 1)
    return (imgs[:, 0] * 255).astype(np.uint8), noisy.astype(np.float32)


@pytest.mark.parametrize("pooled", [False, True], ids=["serial", "spawn pool of 2"])
def test_measure_images_is_the_same_under_both_backends(native_lib, monkeypatch, pooled):
    if pooled:
        monkeypatch.setattr(mnist, "IMAGES_PER_WORKER", 8)  # 16 images: 2 workers
        monkeypatch.setattr(mnist.os, "cpu_count", lambda: 2)
    for images in _decoded_like():
        got = mnist.measure_images(images)
        monkeypatch.setenv(native.NO_NATIVE_ENV, "1")
        assert native.backend() == "numpy"
        want = mnist.measure_images(images)
        monkeypatch.delenv(native.NO_NATIVE_ENV)
        assert got.dtype == np.float64 and got.shape == (len(images), 6)
        np.testing.assert_array_equal(got, want)


def test_without_gpp_the_backend_is_numpy_after_one_warning(monkeypatch):
    monkeypatch.delenv(native.NO_NATIVE_ENV, raising=False)
    monkeypatch.setattr(native, "_BACKEND", None)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.warns(RuntimeWarning, match="g\\+\\+"):
        assert native.backend() == "numpy"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert native.backend() == "numpy"  # decided once: no second warning
    with pytest.raises(RuntimeError, match="not this process's backend"):
        native.zhang_suen_thin_batch(np.zeros((1, 8, 8)))
    img = _binary_images(2, n=1)[0]
    np.testing.assert_array_equal(morpho.zhang_suen_thin(img), morpho.zhang_suen_thin_numpy(img))


def test_a_failed_build_raises_with_the_compilers_stderr(monkeypatch, tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on the PATH")
    bad = tmp_path / "bad.cpp"
    bad.write_text("extern \"C\" int morpho_native_abi_version(void) { return }\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="error") as err:
        native.build(shutil.which("g++"))
    assert str(bad) in str(err.value)
    assert not any((tmp_path / "build").rglob("*.so"))


def test_the_build_is_atomic_and_named_by_source_and_flags(native_lib, monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    path = native.build(shutil.which("g++"))
    assert path == native.library_path() and path.exists()
    assert [p.name for p in path.parent.iterdir()] == ["libmorpho_native.so"]  # no temp left
    assert native.build("no-such-compiler") == path  # built: not compiled again
    assert "-march=native" not in native.CXX_FLAGS
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-g",))
    assert native.library_path() != path
