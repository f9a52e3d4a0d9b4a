"""The port's ``morphomnist/{perturb,skeleton}.py`` against the JAX
package's: each perturbation, each skeleton helper and each
``LocationSampler`` draw, on the same digit measured by each package's
``ImageMorphology`` and with a ``RandomState`` of the same seed, gives
the same array exactly (the draws come from the seed alone, and the
morphologies' skeletons and distance maps are equal bit for bit)."""

import numpy as np
import pytest

from arvae_tpu.data.morphomnist import perturb as jax_perturb
from arvae_tpu.data.morphomnist import skeleton as jax_skeleton
from arvae_tpu.data.morphomnist.morpho import ImageMorphology as JaxMorphology
from arvae_tpu_torch.data.morphomnist import perturb, skeleton
from arvae_tpu_torch.data.morphomnist.morpho import ImageMorphology
from arvae_tpu_torch.data.synthetic_digits import generate_digit_set, render_digit


def _digit(kind):
    if kind == "zero":
        return (render_digit(0, thickness=1.8) * 255).astype(np.uint8)
    imgs, _ = generate_digit_set(6, seed=11)
    return (imgs[int(kind[-1]), 0] * 255).astype(np.uint8)


RNG = np.random.RandomState

# name → f(module with perturb's and skeleton's names, morphology, seed)
CASES = {
    "thinning": lambda m, mo, s: m.Thinning(amount=0.7)(mo),
    "thinning_small": lambda m, mo, s: m.Thinning(amount=0.1)(mo),
    "thickening": lambda m, mo, s: m.Thickening(amount=1.0)(mo),
    "swelling": lambda m, mo, s: m.Swelling(rng=RNG(s))(mo),
    "swelling_strong": lambda m, mo, s: m.Swelling(strength=5, radius=9, rng=RNG(s))(mo),
    "fracture": lambda m, mo, s: m.Fracture(num_frac=3, rng=RNG(s))(mo),
    "fracture_unpruned_retry": lambda m, mo, s: m.Fracture(prune=40, num_frac=2,
                                                           rng=RNG(s))(mo),
    "sampler": lambda m, mo, s: m.LocationSampler(rng=RNG(s)).sample(mo, 7),
    "sampler_one": lambda m, mo, s: m.LocationSampler(rng=RNG(s)).sample(mo),
    "sampler_pruned": lambda m, mo, s: m.LocationSampler(2, 2, rng=RNG(s)).sample(mo, 5),
    "num_neighbours": lambda m, mo, s: m.num_neighbours(mo.skeleton),
    "erase_tips": lambda m, mo, s: m.erase(mo.skeleton, m.num_neighbours(mo.skeleton) == 1,
                                           4),
    "get_angle": lambda m, mo, s: np.array([m.get_angle(mo.skeleton, i, j, 8) for i, j in
                                            zip(*np.where(mo.skeleton))][:40]),
    "disk": lambda m, mo, s: m.disk(s % 5),
}


class _Names:
    """perturb's and skeleton's public names in one namespace."""

    def __init__(self, *mods):
        for mod in mods:
            for k in dir(mod):
                if not k.startswith("_"):
                    setattr(self, k, getattr(mod, k))


PORT, JAX = _Names(skeleton, perturb), _Names(jax_skeleton, jax_perturb)


@pytest.mark.parametrize("digit", ["zero", "set1", "set4"])
@pytest.mark.parametrize("case", list(CASES))
def test_matches_jax(case, digit):
    img, seed = _digit(digit), 7
    port_morph, jax_morph = ImageMorphology(img, scale=4), JaxMorphology(img, scale=4)
    np.testing.assert_array_equal(port_morph.skeleton, jax_morph.skeleton)
    got = np.asarray(CASES[case](PORT, port_morph, seed))
    want = np.asarray(CASES[case](JAX, jax_morph, seed))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if case in ("thinning", "thickening", "swelling", "fracture"):
        assert got.shape == port_morph.binary_image.shape
        assert (got != port_morph.binary_image).any()  # the perturbation did something


def test_overpruned_sampler_raises():
    morph = ImageMorphology(_digit("zero"), scale=4)
    with pytest.raises(ValueError, match="Overpruned"):
        skeleton.LocationSampler(prune_tips=40, prune_forks=40).sample(morph, 3)
