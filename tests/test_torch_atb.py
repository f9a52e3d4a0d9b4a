"""The plain version of the backwards' weight-gradient GEMM
(``gru_kernel.atb_reference``, the A^T X form of ``csrc/tc_gemm.cuh``) and
of its row product (``rows_reference``) against the JAX package.

Inputs are made from a seed with numpy. Every operand form the kernels
take is covered: a dense A, the state one step back (``a0`` at t = 0),
the one-hot of fed tokens (shifted by ``tok_shift``, -1 for none), the
bias (the column sums of X), D = 2 slices, and ragged M, N and K.

Against ``hier_decoder_pallas._matT_a_b`` and ``_a_bT`` (what the tick
loop's Pallas backward sums its weight gradients and transposed products
with) and against ``gru_pallas``'s backward dW_hh / db_hh in interpret
mode, as the JAX tests run it on the CPU: float32, rtol 1e-5 with an
absolute floor of 1e-6 of the largest JAX magnitude, because the two sum
the terms in different orders. Against float64 numpy: 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arvae_tpu.ops import gru_pallas
from arvae_tpu.ops.hier_decoder_pallas import _a_bT, _matT_a_b
from arvae_tpu_torch.ops import gru_kernel as gk

RTOL, FLOOR = 1e-5, 1e-6

# (T, D, B, M, N): the tick loop's shapes cut down, D = 2 as the encoder's
# biGRU, and ragged M, N and K = T·B
SHAPES = [(6, 1, 16, 32, 96), (4, 2, 8, 24, 72), (5, 1, 7, 13, 21), (3, 2, 5, 10, 11)]
FORMS = ("dense", "prev", "tokens")


def _close(got, want):
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=FLOOR * float(np.abs(want).max()))


def _operands(form, t, d, b, m, n, seed, tok_shift=0):
    """x (T, D, B, N); the keywords of ``atb_reference``; and A per slice
    (D, T·B, M) built in numpy, independently of the port."""
    rng = np.random.RandomState(seed)
    x = rng.randn(t, d, b, n).astype(np.float32)
    if form == "tokens":
        tok = rng.randint(-1, m, t * b - tok_shift).astype(np.int32)
        full = np.concatenate([np.full(tok_shift, -1), tok])
        onehot = (full[:, None] == np.arange(m)[None]).astype(np.float32)
        return x, {"tokens": torch.from_numpy(tok), "tok_shift": tok_shift, "M": m}, onehot[None]
    a = rng.randn(t, d, b, m).astype(np.float32)
    kw = {"a": torch.from_numpy(a)}
    if form == "prev":
        a0 = rng.randn(d, b, m).astype(np.float32)
        kw["a0"] = torch.from_numpy(a0)
        a = np.concatenate([a0[None], a[:-1]])
    return x, kw, a.transpose(1, 0, 2, 3).reshape(d, t * b, m)


# the one-hot form has one slice, as the tick loop's embedding gradient
@pytest.mark.parametrize("form,shape", [(f, s) for f in FORMS for s in SHAPES
                                        if f != "tokens" or s[1] == 1])
def test_atb_matches_jax_matT_a_b(form, shape):
    t, d, b, m, n = shape
    x, kw, a_np = _operands(form, t, d, b, m, n, seed=sum(shape),
                            tok_shift=3 * (form == "tokens"))
    out, bias = gk.atb_reference(torch.from_numpy(x), **kw, bias=True)
    assert out.shape == (d, m, n) and bias.shape == (d, n)
    xs = x.transpose(1, 0, 2, 3).reshape(d, t * b, n)
    for k in range(d):
        _close(out[k], _matT_a_b(jnp.asarray(a_np[k]), jnp.asarray(xs[k])))
        _close(bias[k], jnp.sum(jnp.asarray(xs[k]), axis=0))


def test_atb_without_a_bias_returns_none():
    x, kw, _ = _operands("dense", 2, 1, 3, 4, 5, seed=1)
    assert gk.atb_reference(torch.from_numpy(x), **kw)[1] is None


@pytest.mark.parametrize("form", FORMS)
def test_atb_matches_float64_numpy(form):
    t, d, b, m, n = (5, 1, 7, 13, 21) if form == "tokens" else (4, 2, 6, 13, 21)
    x, kw, a_np = _operands(form, t, d, b, m, n, seed=7, tok_shift=2 * (form == "tokens"))
    kw = {k: v.double() if isinstance(v, torch.Tensor) and v.is_floating_point() else v
          for k, v in kw.items()}
    out, bias = gk.atb_reference(torch.from_numpy(x).double(), **kw, bias=True)
    xs = x.astype(np.float64).transpose(1, 0, 2, 3).reshape(d, t * b, n)
    want = np.einsum("dkm,dkn->dmn", a_np.astype(np.float64), xs)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(bias.numpy(), xs.sum(1), rtol=1e-12, atol=1e-12)


def _jax_dgh(gi, w_hh, b_hh, h0, outs, douts):
    """dgh_t of gru_pallas's backward, step by step with its own gate and
    cell functions (what its kernel sums into dW_hh)."""
    T, D = gi.shape[:2]
    dgh = np.zeros_like(gi)
    for d in range(D):
        dh = jnp.zeros_like(h0[d])
        for t in reversed(range(T)):
            h_prev = h0[d] if t == 0 else outs[t - 1, d]
            gh = jnp.dot(h_prev, w_hh[d]) + b_hh[d]
            r, z, n, h_n = gru_pallas._gates(gi[t, d], gh)
            _, g, dh = gru_pallas._gru_bwd(douts[t, d] + dh, r, z, n, h_n, h_prev, w_hh[d])
            dgh[t, d] = np.asarray(g)
    return dgh


@pytest.mark.parametrize("d", [1, 2])
def test_atb_matches_the_gru_pallas_backwards_weight_gradient(d):
    """gru_chain's dW_hh = sum_t h_{t-1}^T dgh_t and db_hh = sum dgh_t: the
    plain GEMM in the prev-with-a0 form (outs one step back, h0 first)
    against the Pallas backward kernel in interpret mode."""
    T, B, H = 6, 8, 128
    rng = np.random.RandomState(10 + d)
    gi = (rng.randn(T, d, B, 3 * H) * 0.5).astype(np.float32)
    w_hh = (rng.randn(d, H, 3 * H) / np.sqrt(H)).astype(np.float32)
    b_hh = (rng.randn(d, 3 * H) * 0.1).astype(np.float32)
    h0 = (rng.randn(d, B, H) * 0.3).astype(np.float32)
    douts = rng.randn(T, d, B, H).astype(np.float32)
    args = [jnp.asarray(v) for v in (gi, w_hh, b_hh, h0)]
    outs = gru_pallas._fwd_value(*args)
    _, _, dw, db = gru_pallas._bwd_value(*args, outs, jnp.asarray(douts))
    dgh = _jax_dgh(gi, w_hh, b_hh, h0, np.asarray(outs), douts)
    got, bias = gk.atb_reference(torch.from_numpy(dgh), a=torch.from_numpy(np.array(outs)),
                                 a0=torch.from_numpy(h0), bias=True)
    _close(got, dw)
    _close(bias, db)


@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("m,k,n", [(64, 32, 96), (37, 13, 10), (24, 130, 16)])
def test_rows_matches_jax(trans, m, k, n):
    rng = np.random.RandomState(m + k + n)
    a = rng.randn(m, k).astype(np.float32)
    w = rng.randn(*((n, k) if trans else (k, n))).astype(np.float32)
    got = gk.rows_reference(torch.from_numpy(a), torch.from_numpy(w), trans)
    want = _a_bT(jnp.asarray(a), jnp.asarray(w)) if trans else jnp.dot(a, w)
    _close(got, want)
