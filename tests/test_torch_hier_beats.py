"""The tick-loop backward's decomposition (``hier_tick_chain_bwd_by_beats``:
products over all rows at once, then each layer as independent chains of
``ticks_per_beat`` ticks, one a beat) against autograd through the plain
loop ``tick_chain_reference`` and, with dropout off, against the JAX
Pallas ``hier_tick_chain`` in interpret mode. B=8 and a ragged B=5,
H=32, E=10, V=34, T=24; ticks_per_beat 6, 24 (one beat) and 5 (T is no
multiple of it: the last beat's padded ticks). The two packages draw
different dropout bits, so dropout 0.5 is held plain against plain.

Tolerance: the 13 gradients rtol 1e-4 / atol 1e-5 (sums in another
order). The decodes run free, so the backward's fed tokens are the
forward's own samples."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arvae_tpu.ops.hier_decoder_pallas import hier_tick_chain as jax_chain
from arvae_tpu_torch.ops import hier_decoder_kernel as hk

H, E, V, T = 32, 10, 34, 24
TPBS = (6, 24, 5)


def _operands(seed, tpb, b):
    rng = np.random.RandomState(seed)
    nb = -(-T // tpb)

    def w(*shape, s=None):
        return (rng.randn(*shape) * (s if s is not None else 1 / np.sqrt(shape[0]))
                ).astype(np.float32)

    floats = [w(nb, b, 3 * H, s=0.5), w(nb, 2, b, H, s=0.5), w(b, E, s=0.5),
              w(V, E, s=1.0), w(E, 3 * H), w(H, 3 * H), w(3 * H, s=0.1),
              w(H, 3 * H), w(3 * H, s=0.1), w(H, 3 * H), w(3 * H, s=0.1),
              w(H, V), w(V, s=0.1)]
    score = rng.randint(0, V, (T, b)).astype(np.int32)
    ct = rng.randn(T, b, V).astype(np.float32)
    return score, floats, ct


def _by_beats_and_autograd(tpb, rate, score, floats, ct):
    """A free-running decode → (samples, the decomposition's 13
    gradients, autograd's 13)."""
    ints = [torch.tensor([0], dtype=torch.int32), torch.tensor([5], dtype=torch.int32)]
    leaves = [torch.from_numpy(f).requires_grad_(True) for f in floats]
    weights, samples, h0_all, h1_all = hk.tick_chain_reference(
        True, rate, tpb, "argmax", *ints, torch.from_numpy(score), *hk.chain_operands(leaves),
        hiddens=True)
    cot = torch.from_numpy(ct)
    (weights * cot).sum().backward()
    got = hk.hier_tick_chain_bwd_by_beats(
        True, rate, tpb, ints[1], samples, h0_all.detach(), h1_all.detach(),
        weights.detach(), cot, *(torch.from_numpy(f) for f in floats))
    return samples, [g.numpy() for g in got], [x.grad.numpy() for x in leaves]


def _check(got, want):
    for g, w, name in zip(got, want, hk.FLOAT_OPERANDS):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("b", [8, 5])
@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("tpb", TPBS)
def test_by_beats_matches_autograd(tpb, rate, b):
    score, floats, ct = _operands(tpb * 10 + b, tpb, b)
    _, got, want = _by_beats_and_autograd(tpb, rate, score, floats, ct)
    _check(got, want)


@pytest.mark.parametrize("tpb", TPBS)
def test_by_beats_matches_jax(tpb):
    score, floats, ct = _operands(tpb, tpb, 8)
    samples, got, _ = _by_beats_and_autograd(tpb, 0.0, score, floats, ct)

    def run(*f):
        return jax_chain(T, True, 0.0, tpb, "argmax", jnp.int32(0), jnp.int32(5),
                         jnp.asarray(score), *f)

    _, vjp, jax_samples = jax.vjp(run, *(jnp.asarray(f) for f in floats), has_aux=True)
    # the same free-running decode on both sides
    np.testing.assert_array_equal(samples.numpy(), np.asarray(jax_samples))
    _check(got, [np.asarray(g) for g in vjp(jnp.asarray(ct))])


def test_chain_layout_pads_the_last_beat():
    x = torch.arange(24 * 2 * 3, dtype=torch.float32).reshape(24, 2, 3) + 1
    c = hk.to_chain(x, 5)  # 5 beats, the last of 4 ticks
    assert c.shape == (5, 5 * 2, 3)
    for t in range(24):
        beat, k = divmod(t, 5)
        assert torch.equal(c[k, beat * 2:(beat + 1) * 2], x[t])
    assert not c[4, 8:].any()  # tick 24 does not exist
