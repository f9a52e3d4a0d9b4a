"""The plain tick loop (``tick_chain_reference``, what ``tick_chain``
runs on a CPU tensor) against the JAX Pallas
``hier_tick_chain`` in interpret mode, at B=8, H=128, E=10, V=34, T=24,
6 ticks per beat, dropout 0 (the two packages draw different random
bits, so dropout is checked on its own below).

Tolerances: forward rtol 1e-5 / atol 1e-5 (24 steps of two GRU layers,
sums in another order); the 13 gradients under a random cotangent rtol
1e-4 / atol 1e-5. A free-running decode is compared by the teacher
trick: the port runs teacher-forced on the JAX side's samples, whose
logits must then match, and each of the port's own free-running samples
must be the lowest-index argmax of its own logits, exactly. At H=256,
the widest tick loop the TPU ran fused (its ``supports`` admits it at
B=256) and one the card's kernels now plan, teacher-forced forward and
gradients are held alike. The wave layout's argmax over V slices
(``argmax_by_slices``: per-slice partials combined as the kernel
combines them) equals ``argmax_lowest`` on ties that straddle slices,
all-equal rows and NaN rows, and takes the JAX kernel's token on a tie
across the first slice edge."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arvae_tpu.ops.hier_decoder_pallas import hier_tick_chain as jax_chain
from arvae_tpu_torch.ops import hier_decoder_kernel as hk

B, H, E, V, T, TPB = 8, 128, 10, 34, 24, 6


def _operands(seed, tpb=TPB, b=B, h=H, e=E, v=V, t=T):
    rng = np.random.RandomState(seed)
    nb = -(-t // tpb)

    def w(*shape, s=None):
        return (rng.randn(*shape) * (s if s is not None else 1 / np.sqrt(shape[0]))
                ).astype(np.float32)

    floats = [w(nb, b, 3 * h, s=0.5), w(nb, 2, b, h, s=0.5), w(b, e, s=0.5),
              w(v, e, s=1.0), w(e, 3 * h), w(h, 3 * h), w(3 * h, s=0.1),
              w(h, 3 * h), w(3 * h, s=0.1), w(h, 3 * h), w(3 * h, s=0.1),
              w(h, v), w(v, s=0.1)]
    score = rng.randint(0, v, (t, b)).astype(np.int32)
    return score, floats


def _port(teacher, score, floats, tpb=TPB, grad_ct=None, **kw):
    ts = [torch.from_numpy(f).requires_grad_(grad_ct is not None) for f in floats]
    weights, samples = hk.tick_chain(
        score.shape[0], kw.get("train", True), kw.get("rate", 0.0), tpb,
        kw.get("sampling", "argmax"), torch.tensor([teacher], dtype=torch.int32),
        torch.tensor([kw.get("seed", 5)], dtype=torch.int32), torch.from_numpy(score),
        *hk.chain_operands(ts))
    grads = None
    if grad_ct is not None:
        (weights * torch.from_numpy(grad_ct)).sum().backward()
        grads = [t.grad.numpy() for t in ts]
    return weights.detach().numpy(), samples.numpy(), grads


def _jax(teacher, score, floats, tpb=TPB, grad_ct=None):
    def run(*f):
        return jax_chain(score.shape[0], True, 0.0, tpb, "argmax", jnp.int32(teacher),
                         jnp.int32(5), jnp.asarray(score), *f)

    jf = [jnp.asarray(f) for f in floats]
    weights, samples = run(*jf)
    grads = None
    if grad_ct is not None:
        _, vjp = jax.vjp(lambda *f: run(*f)[0], *jf)
        grads = [np.asarray(g) for g in vjp(jnp.asarray(grad_ct))]
    return np.asarray(weights), np.array(samples), grads


def test_wide_teacher_forced_forward_and_grads_match_jax():
    h = 256
    # the card's plan at the music step's B: the wave layout
    assert isinstance(hk.hier_plan(256, h, E, V), hk.WavePlan)
    score, floats = _operands(21, h=h)
    ct = np.random.RandomState(22).randn(T, B, V).astype(np.float32)
    w_got, s_got, g_got = _port(1, score, floats, TPB, grad_ct=ct)
    w_want, s_want, g_want = _jax(1, score, floats, TPB, grad_ct=ct)
    np.testing.assert_array_equal(s_got, s_want)
    np.testing.assert_allclose(w_got, w_want, rtol=1e-5, atol=1e-5)
    _check_grads(g_got, g_want)


def _check_grads(got, want):
    for g, w, name in zip(got, want, hk.FLOAT_OPERANDS):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("tpb", [TPB, T], ids=["hier", "one_beat"])
def test_teacher_forced_forward_and_grads_match_jax(tpb):
    score, floats = _operands(1, tpb=tpb)
    ct = np.random.RandomState(2).randn(T, B, V).astype(np.float32)
    hk.reset_launches()
    w_got, s_got, g_got = _port(1, score, floats, tpb, grad_ct=ct)
    w_want, s_want, g_want = _jax(1, score, floats, tpb, grad_ct=ct)
    assert hk.LAUNCHES == {"fwd": 0, "bwd": 0}  # the CPU runs the plain loop
    np.testing.assert_array_equal(s_got, s_want)
    np.testing.assert_array_equal(s_got, score)
    np.testing.assert_allclose(w_got, w_want, rtol=1e-5, atol=1e-5)
    _check_grads(g_got, g_want)


def test_free_running_matches_jax_by_the_teacher_trick():
    score, floats = _operands(3)
    ct = np.random.RandomState(4).randn(T, B, V).astype(np.float32)
    w_jax, s_jax, g_jax = _jax(0, score, floats, grad_ct=ct)
    # the port teacher-forced on JAX's samples feeds the same tokens
    w_got, s_got, g_got = _port(1, s_jax, floats, grad_ct=ct)
    np.testing.assert_array_equal(s_got, s_jax)
    np.testing.assert_allclose(w_got, w_jax, rtol=1e-5, atol=1e-5)
    _check_grads(g_got, g_jax)
    # the port's own free-running decode samples its own logits' argmax
    w_free, s_free, _ = _port(0, score, floats)
    want = hk.argmax_lowest(torch.from_numpy(w_free)).clamp(0, V - 1).numpy()
    np.testing.assert_array_equal(s_free, want)


def test_argmax_lowest_index_and_nan():
    scores = torch.tensor([[0.0, 0.0, 0.0], [1.0, 3.0, 3.0], [2.0, float("nan"), 5.0]])
    assert hk.argmax_lowest(scores).tolist() == [0, 1, 3]  # 3 = V: clamped by the caller


def _argmax_edge_rows(v, width):
    """Score rows at the edges of ``argmax_lowest``: ties that straddle a
    slice edge (and ties inside a slice), all-equal rows, a NaN inside the
    winning slice and one after it, a row of -inf, and random rows."""
    rng = np.random.RandomState(v + width)
    rows = [np.zeros(v), np.full(v, -np.inf)]
    for edge in range(width, v, width):
        r = rng.rand(v)
        r[edge - 1] = r[edge] = 2.0  # the lower, in the earlier slice, wins
        rows.append(r)
        r = rng.rand(v)
        r[edge] = r[min(edge + 1, v - 1)] = 2.0
        rows.append(r)
    r = rng.rand(v)
    r[width + 1] = np.nan  # V, whatever comes before or after
    rows.append(r)
    r = rng.rand(v)
    r[0], r[v - 1] = 3.0, np.nan
    rows.append(r)
    rows += list(rng.rand(8, v))
    rows += list(np.round(rng.rand(8, v) * 3))  # many ties
    return torch.tensor(np.array(rows), dtype=torch.float32)


@pytest.mark.parametrize("v,width", [(130, 8), (34, 8), (130, 16), (130, 40), (34, 16)])
def test_argmax_by_slices_is_argmax_lowest(v, width):
    # the wave layout's head: a partial (max, lowest index) a slice of
    # ``width`` columns, combined across slices as the kernel does
    scores = _argmax_edge_rows(v, width)
    got = hk.argmax_by_slices(scores, width)
    assert torch.equal(got, hk.argmax_lowest(scores))
    assert got[:2].tolist() == [0, 0] and got[2].item() == width - 1
    assert int(got[-18]) == v and int(got[-17]) == v  # NaN rows give V


def test_argmax_by_slices_takes_the_jax_kernels_token_on_a_tie():
    # flat logits (zero weights, logits = out_b) peaked at two columns that
    # straddle the first 8-column slice edge: the JAX Pallas kernel in
    # interpret mode feeds the lower, as the slices' combine picks it
    out_b = np.zeros(130, np.float32)
    out_b[7] = out_b[8] = 5.0
    score, floats = _flat_chain(out_b)
    w_jax, s_jax, _ = _jax(0, score, floats)
    assert (s_jax == 7).all()
    by_slices = hk.argmax_by_slices(torch.tensor(w_jax), 8)
    np.testing.assert_array_equal(by_slices.numpy(), s_jax)


def _uniform_python(seed, t, salt, row, col):
    """The hash in plain Python integers mod 2**32."""
    def mix(x):
        x ^= x >> 16
        x = (x * 0x7FEB352D) & 0xFFFFFFFF
        x ^= x >> 15
        x = (x * 0x846CA68B) & 0xFFFFFFFF
        return x ^ (x >> 16)

    h = mix(mix(mix(seed & 0xFFFFFFFF) ^ t) ^ salt)
    h = mix(mix(h ^ row) ^ col)
    u = np.float32(h >> 8) * np.float32(1.0 / 16777216.0)
    return np.float32(np.float32(u * np.float32(1.0 - 2.0 / 16777216.0))
                      + np.float32(1.0 / 16777216.0))


@pytest.mark.parametrize("seed", [0, 123456789, 2**31 - 2])
def test_uniform01_is_the_uint32_hash(seed):
    u = hk.uniform01(torch.tensor([seed], dtype=torch.int32), 7, hk.SALT_GUMBEL, 5, 9)
    want = np.array([[_uniform_python(seed, 7, hk.SALT_GUMBEL, r, c) for c in range(9)]
                     for r in range(5)], np.float32)
    assert u.dtype == torch.float32
    np.testing.assert_array_equal(u.numpy(), want)
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0


def test_dropout_mask_statistics():
    seed = torch.tensor([11], dtype=torch.int32)
    masks = torch.stack([hk.dropout_mask(seed, t, 256, 128, 0.5) for t in range(4)])
    assert set(masks.unique().tolist()) == {0.0, 2.0}  # scale 1 / (1 - rate)
    kept = float((masks > 0).float().mean())
    # 131,072 Bernoulli(0.5) draws: sd 0.0014, so 0.01 is a 7-sigma bound
    assert abs(kept - 0.5) < 0.01
    assert not torch.equal(masks[0], masks[1])  # a new mask every step
    other = hk.dropout_mask(torch.tensor([12], dtype=torch.int32), 0, 256, 128, 0.5)
    assert not torch.equal(masks[0], other)  # and for every seed


def test_dropout_only_between_layers_and_only_in_training():
    score, floats = _operands(5)
    base = _port(1, score, floats, train=True, rate=0.0)[0]
    dropped = _port(1, score, floats, train=True, rate=0.5)[0]
    evaluated = _port(1, score, floats, train=False, rate=0.5)[0]
    assert not np.allclose(dropped, base)
    np.testing.assert_array_equal(evaluated, base)
    # with layer 1 blind to its input, the mask (on that input only) is moot
    blind = list(floats)
    blind[7] = np.zeros_like(floats[7])  # w_ih1
    np.testing.assert_array_equal(_port(1, score, blind, train=True, rate=0.5)[0],
                                  _port(1, score, blind, train=True, rate=0.0)[0])


def _flat_chain(out_b):
    score, floats = _operands(6, v=130)
    floats = [np.zeros_like(f) for f in floats]
    floats[-1] = np.asarray(out_b, np.float32)
    return score, floats


def test_multinomial_in_distribution():
    out_b = np.zeros(130, np.float32)
    out_b[37] = 1e4
    score, floats = _flat_chain(out_b)
    s_multi = _port(0, score, floats, sampling="multinomial")[1]
    s_arg = _port(0, score, floats, sampling="argmax")[1]
    np.testing.assert_array_equal(s_multi, s_arg)  # peaked logits: deterministic
    assert int(s_multi[0, 0]) == 37
    score, floats = _flat_chain(np.zeros(130, np.float32))
    toks = _port(0, score, floats, sampling="multinomial")[1].ravel()  # 192 samples
    assert len(np.unique(toks)) > 50  # argmax would give {0}
    assert np.bincount(toks, minlength=130).max() <= 12


def test_cuda_wrappers_refuse_cpu_tensors():
    score, floats = _operands(7, t=6, tpb=6)
    ints = [torch.tensor([1], dtype=torch.int32)] * 2
    ts = [torch.from_numpy(f) for f in floats]
    with pytest.raises(ValueError, match="must lie on"):
        hk.hier_tick_chain_fwd_cuda(True, 0.0, 6, "argmax", *ints,
                                    torch.from_numpy(score), *ts)
    with pytest.raises(ValueError, match="gi_beat must be"):
        hk.hier_tick_chain_fwd_cuda(True, 0.0, 3, "argmax", *ints,
                                    torch.from_numpy(score), *ts)
    with pytest.raises(NotImplementedError):
        hk.hier_tick_chain_fwd_cuda(True, 0.0, 6, "topk", *ints,
                                    torch.from_numpy(score), *ts)


@pytest.mark.parametrize("sampling", ["argmax", "multinomial"])
def test_row_base_gives_the_rows_of_the_whole_call(sampling):
    """A data-parallel rank's call (``row_base`` = its first global row)
    draws the dropout masks and Gumbel noise of those rows in a call over
    the whole batch: the same samples, and logits and per-row gradients
    within the forward and gradient tolerances of the whole call's rows
    (products over fewer rows sum in another order; a mask drawn for
    another row would zero or double a unit), and
    ``hier_tick_chain_bwd_by_beats`` at that ``row_base`` agrees with
    autograd."""
    score, floats = _operands(11)
    ct = np.random.RandomState(12).randn(T, B, V).astype(np.float32)
    kw = dict(rate=0.5, sampling=sampling)
    whole = _port(0, score, floats, grad_ct=ct, **kw)
    for r0, r1 in ((0, 3), (3, 8), (5, 6)):
        part = [f[:, r0:r1] if i == 0 else f[:, :, r0:r1] if i == 1 else f[r0:r1] if i == 2
                else f for i, f in enumerate(floats)]
        part = [np.ascontiguousarray(f) for f in part]
        leaves = [torch.from_numpy(f).requires_grad_(True) for f in part]
        weights, samples, *hiddens = hk.tick_chain_reference(
            True, 0.5, TPB, sampling, torch.tensor([0], dtype=torch.int32),
            torch.tensor([5], dtype=torch.int32), torch.from_numpy(score[:, r0:r1]),
            *hk.chain_operands(leaves), hiddens=True, row_base=r0)
        np.testing.assert_array_equal(samples.numpy(), whole[1][:, r0:r1])
        np.testing.assert_allclose(weights.detach().numpy(), whole[0][:, r0:r1], rtol=1e-5,
                                   atol=1e-5)
        ct_part = torch.from_numpy(np.ascontiguousarray(ct[:, r0:r1]))
        (weights * ct_part).sum().backward()
        for i in range(3):  # the per-row operands: gi_beat, tick_h0, x0
            want = whole[2][i][:, r0:r1] if i == 0 else (whole[2][i][:, :, r0:r1] if i == 1
                                                         else whole[2][i][r0:r1])
            np.testing.assert_allclose(leaves[i].grad.numpy(), want, rtol=1e-4, atol=1e-5)
        by_beats = hk.hier_tick_chain_bwd_by_beats(
            True, 0.5, TPB, torch.tensor([5], dtype=torch.int32), samples,
            [h.detach() for h in hiddens], weights.detach(), ct_part,
            *[torch.from_numpy(f) for f in part], row_base=r0)
        for got, leaf in zip(by_beats, leaves):
            np.testing.assert_allclose(got.numpy(), leaf.grad.numpy(), rtol=1e-4, atol=1e-5)
    # a rank that ignored its row_base would draw row 0's masks for its rows
    other = hk.tick_chain_reference(
        True, 0.5, TPB, sampling, torch.tensor([0], dtype=torch.int32),
        torch.tensor([5], dtype=torch.int32), torch.from_numpy(score[:, 3:8]),
        *hk.chain_operands([torch.from_numpy(np.ascontiguousarray(
            f[:, 3:8] if i == 0 else f[:, :, 3:8] if i == 1 else f[3:8] if i == 2 else f))
            for i, f in enumerate(floats)]))[0]
    assert not np.allclose(other.numpy(), whole[0][:, 3:8], rtol=1e-5, atol=1e-5)
