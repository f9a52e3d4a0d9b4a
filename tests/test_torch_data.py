"""The port's dSprites data path against the JAX package's: generated
rows byte for byte, the seed-0 train/val split order, the MSB-first
bit unpack, and one epoch of the device-resident runner."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arvae_tpu.data import device_data as jdd
from arvae_tpu.data import dsprites as jds
from arvae_tpu.parallel import create_mesh
from arvae_tpu_torch.data import device_data as tdd
from arvae_tpu_torch.data import dsprites as tds

TINY = (1, 3, 2, 2, 4, 4)


def test_generated_rows_are_byte_equal():
    jp, jl = jds.generate_dsprites(TINY)
    tp, tl = tds.generate_dsprites(TINY)
    assert tp.dtype == np.uint8 and tp.shape == (int(np.prod(TINY)), 512)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tl, jl)


def test_split_order_and_rows_match(tmp_path):
    # each package writes then reads the same cache file under its root
    jset = jds.DspritesDataset(root=str(tmp_path / "j"), factor_sizes=TINY)
    tset = tds.DspritesDataset(root=str(tmp_path / "t"), factor_sizes=TINY)
    jtrain, jval = jset.device_splits(create_mesh())
    ttrain, tval = tset.device_splits(torch.device("cpu"))
    assert (tmp_path / "t" / "dsprites_synth_1x3x2x2x4x4.npz").exists()
    np.testing.assert_array_equal(tset._order, jset._order)
    for jsp, tsp in ((jtrain, ttrain), (jval, tval)):
        assert tsp.n == jsp.n
        np.testing.assert_array_equal(tsp.images.numpy(),
                                      np.asarray(jsp.images)[:jsp.n])
        np.testing.assert_array_equal(tsp.labels.numpy(),
                                      np.asarray(jsp.labels)[:jsp.n])
    # a second dataset object reads the cache back unchanged
    again = tds.DspritesDataset(root=str(tmp_path / "t"), factor_sizes=TINY)
    again.load_dataset()
    np.testing.assert_array_equal(again.packed, tset.packed)


def test_unpack_bits_matches_jax_and_numpy():
    rng = np.random.RandomState(0)
    rows = rng.randint(0, 256, (5, 64)).astype(np.uint8)
    for n_bits in (512, 500):
        got = tdd.unpack_bits(torch.from_numpy(rows), n_bits)
        want = jdd.unpack_bits(jnp.asarray(rows), n_bits)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            got.numpy(), np.unpackbits(rows, axis=1)[:, :n_bits])


@pytest.mark.parametrize("kind", ["packed", "bytes"])
def test_runner_epoch_covers_split_once(kind):
    rng = np.random.RandomState(1)
    n, b = 70, 16
    width = 512 if kind == "packed" else 4096
    rows = rng.randint(0, 256, (n, width)).astype(np.uint8)
    labels = np.arange(n, dtype=np.float32)[:, None].repeat(6, 1)
    sp = tdd.DeviceSplit(rows, labels, (1, 64, 64), kind, torch.device("cpu"))
    seen, seen_val = [], []

    def train_step(batch):
        imgs, labs = batch
        assert imgs.shape == (b, 1, 64, 64) and imgs.dtype == torch.float32
        ids = labs[:, 0].long()
        if kind == "packed":
            want = np.unpackbits(rows[ids.numpy()], axis=1)
        else:
            want = rows[ids.numpy()] / np.float32(255.0)
        np.testing.assert_array_equal(imgs.reshape(b, -1).numpy(), want)
        seen.extend(ids.tolist())
        return {"loss": imgs.mean(), "accuracy": torch.ones(())}

    def eval_step(batch):
        seen_val.extend(batch[1][:, 0].long().tolist())
        return {"loss": torch.ones(()), "accuracy": torch.ones(())}

    runner = tdd.DeviceEpochRunner(sp, sp, b, train_step, eval_step,
                                   torch.Generator().manual_seed(0))
    totals, steps = runner.train_epoch()
    assert steps == n // b == 4
    assert len(seen) == len(set(seen)) == steps * b  # partial batch dropped
    vtot, vsteps = runner.eval_epoch()
    assert vsteps == 4 and seen_val == list(range(vsteps * b))
    assert float(vtot["loss"]) == 4.0
    # the next epoch draws a new permutation
    first = list(seen)
    seen.clear()
    runner.train_epoch()
    assert seen != first
