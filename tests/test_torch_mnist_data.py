"""The port's MNIST data against the JAX package's: the synthetic digits
bit for bit, the IDX archives both ways, the morphometry to 1e-12, the
cache across packages, the dataset's guards and its device splits.

The JAX side measures without a pool (``measure_batch(..., pool=None)``):
its ``multiprocessing.Pool()`` forks, which deadlocks after JAX has run
in the process (ROADMAP.md, Queue C notes). The port's own pool starts
its workers by spawn and is held to the serial measurement here."""

import os

import numpy as np
import pytest
import torch

import arvae_tpu.data.mnist as jax_mnist
from arvae_tpu.data.morphomnist import io as jax_io
from arvae_tpu.data.morphomnist.measure import measure_batch as jax_measure_batch
from arvae_tpu.data.synthetic_digits import generate_digit_set as jax_digit_set
from arvae_tpu.data.synthetic_digits import render_digit as jax_render_digit
from arvae_tpu_torch.data import mnist
from arvae_tpu_torch.data.morphomnist import io as idx_io
from arvae_tpu_torch.data.morphomnist.measure import COLUMNS, measure_batch, measure_image
from arvae_tpu_torch.data.synthetic_digits import generate_digit_set, render_digit

MORPHO_ATOL = 1e-12
N_TRAIN, N_TEST = 24, 16


@pytest.mark.parametrize("seed", [0, 1])
def test_digit_set_is_bitwise_the_jax_one(seed):
    imgs, labels = generate_digit_set(40, seed=seed)
    want_imgs, want_labels = jax_digit_set(40, seed=seed)
    assert imgs.dtype == np.float32 and imgs.shape == (40, 1, 28, 28)
    np.testing.assert_array_equal(imgs, want_imgs)
    np.testing.assert_array_equal(labels, want_labels)
    np.testing.assert_array_equal(render_digit(7, 1.5, 0.3, 0.9, 1.0, 1.0, -0.5),
                                  jax_render_digit(7, 1.5, 0.3, 0.9, 1.0, 1.0, -0.5))


@pytest.mark.parametrize("dtype", [np.uint8, np.int32, np.float32])
def test_idx_round_trip_and_across_packages(tmp_path, dtype):
    arr = (np.random.RandomState(0).rand(5, 4, 3) * 100).astype(dtype)
    for writer, reader in ((idx_io.save_idx, idx_io.load_idx),
                           (idx_io.save_idx, jax_io.load_idx),
                           (jax_io.save_idx, idx_io.load_idx)):
        for name in ("a.idx", "a.idx.gz"):
            path = str(tmp_path / name)
            writer(arr, path)
            back = reader(path)
            assert back.dtype == arr.dtype
            np.testing.assert_array_equal(back, arr)


def _digits_u8(n=32):
    imgs, _ = generate_digit_set(n, seed=3)
    u8 = (imgs[:, 0] * 255).astype(np.uint8)
    return np.concatenate([u8, np.zeros((1, 28, 28), np.uint8)])  # and a blank image


def test_measure_batch_matches_jax():
    u8 = _digits_u8()
    got = measure_batch(u8)
    want = jax_measure_batch(u8, pool=None)
    assert list(want.columns) == COLUMNS
    assert got.dtype == np.float64 and got.shape == (33, 6)
    np.testing.assert_allclose(got, want.values, atol=MORPHO_ATOL, rtol=0)
    assert measure_image(u8[-1]) == (0.0,) * 6
    assert np.all(got[:-1, 0] > 0)  # every digit has an area


def test_measure_images_pool_equals_serial(monkeypatch):
    u8 = _digits_u8(15)
    serial = mnist.measure_images(u8)
    monkeypatch.setattr(mnist, "IMAGES_PER_WORKER", 8)  # 16 images: a pool of 2
    monkeypatch.setattr(mnist.os, "cpu_count", lambda: 2)
    pooled = mnist.measure_images(u8)
    assert mnist.POOL_START in ("spawn", "forkserver")
    assert serial.dtype == np.float64  # measure_batch's, as JAX's DataFrame holds
    np.testing.assert_array_equal(pooled, serial)


@pytest.fixture
def tiny(monkeypatch):
    """Both packages' synthetic sets cut to tens of rows; the JAX side
    measures serially (its pool forks)."""
    for mod in (mnist, jax_mnist):
        monkeypatch.setattr(mod, "SYNTH_TRAIN", N_TRAIN)
        monkeypatch.setattr(mod, "SYNTH_TEST", N_TEST)
    monkeypatch.setattr(jax_mnist, "_measure_images", lambda imgs: jax_measure_batch(
        imgs, pool=None).values.astype(np.float32))


def _assert_same_sets(port, ref):
    for kind, want in (("train", ref._full_train), ("t10k", ref._full_test)):
        got = port._full(kind)
        assert got[2].dtype == np.float32 and got[2].shape == (len(got[0]), 7)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_cache_written_by_the_port_loads_in_jax(tmp_path, tiny):
    port = mnist.MorphoMnistDataset(root=str(tmp_path))
    with open(port._paths("train")[2]) as fh:
        assert fh.readline().strip() == ",".join(mnist.MORPHO_COLUMNS)
    ref = jax_mnist.MorphoMnistDataset(root=str(tmp_path))
    _assert_same_sets(port, ref)


def test_cache_written_by_jax_loads_in_the_port(tmp_path, tiny, monkeypatch):
    ref = jax_mnist.MorphoMnistDataset(root=str(tmp_path))

    def no_measuring(imgs):
        raise AssertionError("the port re-measured a valid cache")

    monkeypatch.setattr(mnist, "measure_images", no_measuring)
    port = mnist.MorphoMnistDataset(root=str(tmp_path))
    _assert_same_sets(port, ref)
    # both measured the same images to the same float32 labels
    np.testing.assert_array_equal(
        port._full_train[2][:, 1:],
        mnist.measure_batch((port._full_train[0][:, 0] * 255).astype(np.uint8))
        .astype(np.float32))


def test_incomplete_archive_raises(tmp_path, tiny):
    ds = mnist.MnistDataset(root=str(tmp_path))
    os.remove(ds._paths("train")[1])
    with pytest.raises(FileNotFoundError, match="incomplete MNIST"):
        mnist.MnistDataset(root=str(tmp_path))


def test_morphometrics_are_lazy_and_stale_csv_removed_on_regenerate(tmp_path, tiny):
    ds = mnist.MnistDataset(root=str(tmp_path))
    img_p, lab_p, mor_p = ds._paths("train")
    assert not os.path.exists(mor_p)  # measured on first access only
    assert ds._full_train[2].shape == (N_TRAIN, 7) and os.path.exists(mor_p)
    # a stale cache, then BOTH archives removed: the regenerated set must
    # not inherit the stale CSV
    np.savetxt(mor_p, np.zeros((5, 7)), delimiter=",", header="0,1,2,3,4,5,6", comments="")
    os.remove(img_p)
    os.remove(lab_p)
    again = mnist.MnistDataset(root=str(tmp_path))
    assert again._full_train[2].shape[0] == again._full_train[0].shape[0] == N_TRAIN
    np.testing.assert_array_equal(again._full_train[2], ds._full_train[2])


def test_mismatched_csv_is_remeasured(tmp_path, tiny, capsys):
    ds = mnist.MnistDataset(root=str(tmp_path))
    full = ds._full_train[2]
    mor_p = ds._paths("train")[2]
    with open(mor_p) as fh:
        lines = fh.readlines()
    with open(mor_p, "w") as fh:
        fh.writelines(lines[:6])  # the header and 5 rows
    again = mnist.MnistDataset(root=str(tmp_path))
    np.testing.assert_array_equal(again._full_train[2], full)
    assert "does not match the 24-image archive; re-measuring" in capsys.readouterr().out


def test_six_column_csv_gains_its_digit_column(tmp_path, tiny):
    ds = mnist.MnistDataset(root=str(tmp_path))
    full = ds._full_train[2]
    mor_p = ds._paths("train")[2]
    np.savetxt(mor_p, full[:, 1:], fmt="%.9g", delimiter=",", header=",".join(COLUMNS),
               comments="")
    for again in (mnist.MnistDataset(root=str(tmp_path)),
                  jax_mnist.MnistDataset(root=str(tmp_path))):
        np.testing.assert_array_equal(again._full_train[2], full)


def test_device_splits_are_the_files(tmp_path, tiny):
    port = mnist.MorphoMnistDataset(root=str(tmp_path))
    ref = jax_mnist.MorphoMnistDataset(root=str(tmp_path))
    cpu = torch.device("cpu")
    train, val = port.device_splits(cpu, split=(0.70, 0.20))
    ev = port.device_eval_split(cpu)
    for sp, (imgs, _, morpho) in ((train, ref._full_train), (val, ref._full_test),
                                  (ev, ref._full_test)):
        assert sp.kind == "bytes" and sp.n == len(imgs)
        x, labels = sp.gather_batch(torch.arange(sp.n))
        assert labels.dtype == torch.float32 and labels.shape == (sp.n, 7)
        np.testing.assert_array_equal(x.numpy(), imgs)
        np.testing.assert_array_equal(labels.numpy(), morpho)
