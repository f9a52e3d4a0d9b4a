"""The image and fader trainers' decodes and latent traversals against
the JAX trainers', from the JAX trainer's own initial weights (biases
made random, so a misplaced one shows) converted by
``arvae_tpu_torch/utils/convert.py``:

- ``ImageVAETrainer.decode`` and the 1-D and 2-D traversal grids
  (``compute_latent_interpolations``, ``..._interpolations2d``, both
  ``make_grid`` arrays) for ``DspritesVAE`` and ``MnistVAE`` (dropout
  0.5, off in a decode): float32 within rtol 1e-5 / atol 1e-6, and with
  the models' ``compute_dtype`` at bfloat16 (the CLI's ``--bf16``)
  within 1e-2 (sigmoid outputs in [0, 1]; both packages round each
  bfloat16 layer, in other summation orders; measured 1.2e-4 on
  dSprites' decodes and 2.6e-3 on MNIST's, float32's 6e-8 and 2.7e-7);
- ``compute_mnist_morpho_labels`` bitwise on the same decoded digits
  (the JAX one measures serially here: its fork pool can deadlock after
  JAX has run in the process; the port's through two spawn workers);
- the fader's label traversal grid within the float32 tolerances;
- ``make_grid`` exactly, on ragged rows and another padding.
"""

import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arvae_tpu.models import DspritesFaderNetwork as FlaxDspritesFader
from arvae_tpu.models import DspritesVAE as FlaxDspritesVAE
from arvae_tpu.models import ImageFaderDiscriminator as FlaxDisc
from arvae_tpu.models import MnistFaderNetwork as FlaxMnistFader
from arvae_tpu.models.image_vae import MnistVAE as FlaxMnistVAE
from arvae_tpu.parallel import create_mesh
from arvae_tpu.training.fader_trainer import ImageFaderTrainer as JaxFaderTrainer
from arvae_tpu.training.image_trainer import ImageVAETrainer as JaxImageTrainer
from arvae_tpu.utils.plotting import make_grid as jax_make_grid
from arvae_tpu_torch.data import mnist
from arvae_tpu_torch.models.image_fader import DspritesFaderNetwork, MnistFaderNetwork
from arvae_tpu_torch.models.image_vae import DspritesVAE, MnistVAE
from arvae_tpu_torch.training.fader_trainer import ImageFaderTrainer
from arvae_tpu_torch.training.image_trainer import ImageVAETrainer
from arvae_tpu_torch.utils.convert import (dsprites_vae_from_flax, fader_from_flax,
                                           mnist_vae_from_flax)
from arvae_tpu_torch.utils.plotting import make_grid

F32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=0.0, atol=1e-2)
CPU = torch.device("cpu")


class MorphoMnistDataset:
    """Only its class name: how the JAX trainers tell MNIST apart."""


class DspritesDataset:
    pass


KINDS = {
    "dsprites": dict(flax=FlaxDspritesVAE, port=DspritesVAE, convert=dsprites_vae_from_flax,
                     dataset=DspritesDataset, z=10, fader=(FlaxDspritesFader,
                                                          DspritesFaderNetwork, 5)),
    "mnist": dict(flax=FlaxMnistVAE, port=MnistVAE, convert=mnist_vae_from_flax,
                  dataset=MorphoMnistDataset, z=16, fader=(FlaxMnistFader, MnistFaderNetwork,
                                                           6)),
}
DTYPES = {"f32": (jnp.float32, torch.float32, F32), "bf16": (jnp.bfloat16, torch.bfloat16,
                                                             BF16)}


def _random_biases(params, seed):
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.RandomState(seed)
    leaves = [x if np.ndim(x) > 1 else
              jnp.asarray(0.05 * rng.randn(*np.shape(x)).astype(np.float32)) for x in leaves]
    return jax.tree_util.tree_unflatten(tree, leaves)


def _trainers(kind, dtype="f32"):
    """The JAX image trainer and the port's, on the same weights."""
    k = KINDS[kind]
    jdt, tdt, _ = DTYPES[dtype]
    jtr = JaxImageTrainer(k["dataset"](), k["flax"](compute_dtype=jdt), reg_type=("all",),
                          rand=0, mesh=create_mesh(jax.devices()[:1]))
    state = jtr.ensure_state()
    jtr.state = state.replace(params=_random_biases(state.params, 1))
    model = k["port"](compute_dtype=tdt)
    model.load_state_dict(k["convert"](jtr.state.params))
    return jtr, ImageVAETrainer(None, model, CPU, reg_type=("all",), rand=0)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", list(KINDS))
def test_decode_and_grids_match_jax(kind, dtype):
    jtr, tr = _trainers(kind, dtype)
    tol, z_dim = DTYPES[dtype][2], KINDS[kind]["z"]
    rng = np.random.RandomState(2)
    z = 2 * rng.randn(6, z_dim).astype(np.float32)
    got, want = tr.decode(z), np.asarray(jtr.decode(z))
    side = 64 if kind == "dsprites" else 28
    assert got.dtype == np.float32 and got.shape == (6, 1, side, side)
    np.testing.assert_allclose(got, want, **tol)
    code = rng.randn(1, z_dim).astype(np.float32)
    grid = tr.compute_latent_interpolations(code, dim1=3, num_points=7)
    assert grid.shape == (1, side + 4, 7 * (side + 2) + 2)
    np.testing.assert_allclose(grid, jtr.compute_latent_interpolations(code, dim1=3,
                                                                       num_points=7), **tol)
    grid2 = tr.compute_latent_interpolations2d(code, dim1=1, dim2=4, num_points=4)
    assert grid2.shape == (1, 4 * (side + 2) + 2, 4 * (side + 2) + 2)
    np.testing.assert_allclose(grid2, jtr.compute_latent_interpolations2d(
        code, dim1=1, dim2=4, num_points=4), **tol)
    # the decode is eval mode, whatever mode the model was left in
    tr.model.train()
    np.testing.assert_array_equal(tr.decode(z), got)


class _SerialPool:
    """``multiprocessing.Pool()`` measured in this process."""

    def __init__(self, *args, **kwargs):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def imap(self, fn, iterable, chunksize=1):
        return map(fn, iterable)


def test_mnist_morpho_labels_match_jax(monkeypatch):
    jtr, tr = _trainers("mnist")
    z = 1.5 * np.random.RandomState(3).randn(12, 16).astype(np.float32)
    outputs = np.asarray(jtr.decode(z))
    monkeypatch.setattr(multiprocessing, "Pool", _SerialPool)
    monkeypatch.setattr(mnist, "IMAGES_PER_WORKER", 6)  # 12 digits: 2 spawn workers
    monkeypatch.setattr(mnist.os, "cpu_count", lambda: 2)
    got, want = tr.compute_mnist_morpho_labels(outputs), jtr.compute_mnist_morpho_labels(outputs)
    assert got.dtype == want.dtype == np.float64 and got.shape == (12, 6)
    np.testing.assert_array_equal(got, want)
    assert np.all(np.isfinite(got))
    monkeypatch.setattr(mnist, "IMAGES_PER_WORKER", 512)  # serially from here
    for attr in ("area", "thickness", "height"):
        col = tr.compute_mnist_morpho_labels(outputs, attr)
        np.testing.assert_array_equal(col, jtr.compute_mnist_morpho_labels(outputs, attr))
        np.testing.assert_array_equal(col, got[:, tr.attr_dict[attr] - 1])


@pytest.mark.parametrize("kind", list(KINDS))
def test_fader_label_traversal_matches_jax(kind):
    k = KINDS[kind]
    flax_cls, port_cls, a = k["fader"]
    flax_model = flax_cls(dropout_rate=0.5) if kind == "mnist" else flax_cls()
    jtr = JaxFaderTrainer(k["dataset"](), flax_model, disc_model=FlaxDisc(a), rand=0,
                          mesh=create_mesh(jax.devices()[:1]))
    state = jtr.ensure_state()
    jtr.state = state.replace(params=_random_biases(state.params, 2))
    model = port_cls(dropout_rate=0.5) if kind == "mnist" else port_cls()
    model.load_state_dict(fader_from_flax(jtr.state.params))
    tr = ImageFaderTrainer(None, model, CPU, rand=0)
    rng = np.random.RandomState(4)
    codes = rng.randn(3, k["z"]).astype(np.float32)
    labels = rng.rand(3, a).astype(np.float32)
    for dim in (0, a - 1):
        got = tr.compute_latent_interpolations(codes, labels, dim1=dim)
        want = jtr.compute_latent_interpolations(codes, labels, dim1=dim)
        side = 64 if kind == "dsprites" else 28
        assert got.shape == (1, 11 * (side + 2) + 2, side + 4)
        np.testing.assert_allclose(got, want, **F32)
    # the sweep changed the decode: the label reaches the decoder
    assert not np.array_equal(got[:, 2:2 + side], got[:, -2 - side:-2])


@pytest.mark.parametrize("n,nrow,padding,pad_value", [(7, 3, 2, 1.0), (4, 8, 0, 0.0),
                                                      (1, 1, 5, 0.5)])
def test_make_grid_is_jaxs(n, nrow, padding, pad_value):
    images = np.random.RandomState(n).rand(n, 3, 5, 6).astype(np.float32)
    got = make_grid(images, nrow=nrow, padding=padding, pad_value=pad_value)
    want = jax_make_grid(images, nrow=nrow, padding=padding, pad_value=pad_value)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
