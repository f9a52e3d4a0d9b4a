"""The port's GRU ops against the JAX package's.

``gru_chain_reference`` (the plain version of the CUDA chain kernel, and
what ``gru_chain`` runs on a CPU tensor) is held against the JAX Pallas
``gru_chain`` in interpret mode at T=6, B=8, H=128, D∈{1,2}, and against
JAX's scan reference at an unaligned B=5, H=24: forward rtol 1e-5,
gradients under a random cotangent rtol 1e-4 (atol 1e-5 and 1e-6: sums
over T·B terms in another order). ``gru_forward`` is held against JAX's
biGRU stack with dropout 0, and the port's ``GRU`` module against
``torch.nn.GRU`` loaded with the same state_dict."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arvae_tpu.ops import gru as jax_gru
from arvae_tpu.ops import gru_pallas
from arvae_tpu_torch.ops import gru_kernel
from arvae_tpu_torch.ops.gru import GRU, gru_forward, gru_layer

T, B, H = 6, 8, 128


def _inputs(d, seed=0, t=T, b=B, h=H):
    rng = np.random.RandomState(seed)
    gi = (rng.randn(t, d, b, 3 * h) * 0.5).astype(np.float32)
    w_hh = (rng.randn(d, h, 3 * h) / np.sqrt(h)).astype(np.float32)
    b_hh = (rng.randn(d, 3 * h) * 0.1).astype(np.float32)
    h0 = (rng.randn(d, b, h) * 0.3).astype(np.float32)
    ct = rng.randn(t, d, b, h).astype(np.float32)
    return (gi, w_hh, b_hh, h0), ct


def _port_value_and_grads(args, ct):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    outs = gru_kernel.gru_chain(*ts)
    (outs * torch.from_numpy(ct)).sum().backward()
    return outs.detach().numpy(), [t.grad.numpy() for t in ts]


def _jax_value_and_grads(fn, args, ct):
    jargs = [jnp.asarray(a) for a in args]
    outs = fn(*jargs)
    grads = jax.grad(lambda *a: jnp.sum(fn(*a) * ct), argnums=(0, 1, 2, 3))(*jargs)
    return np.asarray(outs), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("case", ["pallas_d1", "pallas_d2", "unaligned_d2"])
def test_chain_reference_matches_jax(case):
    if case == "unaligned_d2":
        args, ct = _inputs(2, seed=4, b=5, h=24)
        fn = gru_pallas.gru_chain_reference
    else:
        args, ct = _inputs(int(case[-1]), seed=3)
        fn = gru_pallas.gru_chain  # interpret mode off the TPU
    gru_kernel.reset_launches()
    got, g_got = _port_value_and_grads(args, ct)
    want, g_want = _jax_value_and_grads(fn, args, ct)
    assert gru_kernel.LAUNCHES == {"fwd": 0, "bwd": 0}  # the CPU runs the plain loop
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for a, b, name in zip(g_got, g_want, ["dgi", "dw_hh", "db_hh", "dh0"]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=name)


def _jax_stack(rng, in_dim, h, layers, dirs):
    def p(i):
        return {"w_ih": (rng.randn(i, 3 * h) / np.sqrt(i)).astype(np.float32),
                "w_hh": (rng.randn(h, 3 * h) / np.sqrt(h)).astype(np.float32),
                "b_ih": (rng.randn(3 * h) * 0.1).astype(np.float32),
                "b_hh": (rng.randn(3 * h) * 0.1).astype(np.float32)}
    out = []
    for layer in range(layers):
        i = in_dim if layer == 0 else h * dirs
        out.append([p(i) for _ in range(dirs)] if dirs == 2 else p(i))
    return out


@pytest.mark.parametrize("bidirectional", [True, False])
def test_gru_forward_matches_jax(bidirectional):
    rng = np.random.RandomState(7)
    dirs, layers, h, b, t, i = (2 if bidirectional else 1), 2, 16, 5, 24, 10
    params = _jax_stack(rng, i, h, layers, dirs)
    xs = rng.randn(b, t, i).astype(np.float32)
    h0 = (rng.randn(layers * dirs, b, h) * 0.3).astype(np.float32)
    want_out, want_hn = jax_gru.gru_forward(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(xs), jnp.asarray(h0),
        bidirectional=bidirectional)
    tparams = jax.tree_util.tree_map(torch.from_numpy, params)
    got_out, got_hn = gru_forward(tparams, torch.from_numpy(xs), torch.from_numpy(h0),
                                  bidirectional=bidirectional, dropout_rate=0.5,
                                  train=False)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_hn.numpy(), np.asarray(want_hn), rtol=1e-5, atol=1e-6)


def test_gru_layer_reverse_matches_jax():
    rng = np.random.RandomState(8)
    p = _jax_stack(rng, 6, 12, 1, 1)[0]
    xs = rng.randn(3, 7, 6).astype(np.float32)
    h0 = rng.randn(3, 12).astype(np.float32)
    want = jax_gru.gru_layer({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(xs), jnp.asarray(h0), reverse=True)
    got = gru_layer({k: torch.from_numpy(v) for k, v in p.items()},
                    torch.from_numpy(xs), torch.from_numpy(h0), reverse=True)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bidirectional", [True, False])
def test_module_matches_torch_nn_gru(bidirectional):
    torch.manual_seed(0)
    ref = torch.nn.GRU(10, 16, num_layers=2, bidirectional=bidirectional,
                       batch_first=True, dropout=0.5).eval()
    port = GRU(10, 16, 2, bidirectional=bidirectional, dropout=0.5).eval()
    port.load_state_dict(ref.state_dict())  # same names and shapes
    xs = torch.randn(4, 24, 10)
    h0 = torch.randn(2 * (2 if bidirectional else 1), 4, 16)
    with torch.no_grad():
        want_out, want_hn = ref(xs, h0)
        got_out, got_hn = port(xs, h0)
    torch.testing.assert_close(got_out, want_out, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got_hn, want_hn, rtol=1e-5, atol=1e-5)


def test_training_dropout_only_between_layers():
    port = GRU(10, 16, 2, dropout=0.5).train()
    xs, h0 = torch.randn(64, 24, 10), torch.zeros(2, 64, 16)
    out_a, hn_a = port(xs, h0, torch.Generator().manual_seed(1))
    out_b, hn_b = port(xs, h0, torch.Generator().manual_seed(1))
    out_c, hn_c = port(xs, h0, torch.Generator().manual_seed(2))
    assert torch.equal(out_a, out_b) and torch.equal(hn_a, hn_b)  # draws from the generator
    assert torch.equal(hn_a[0], hn_c[0])  # layer 0 sees no dropout
    assert not torch.equal(hn_a[1], hn_c[1])  # layer 1 reads a dropped-out input
    port.eval()
    out_e, _ = port(xs, h0)
    out_f, _ = gru_forward(port.params(), xs, h0)
    assert torch.equal(out_e, out_f)  # eval: no dropout at all


def test_cuda_wrappers_refuse_cpu_tensors():
    args, ct = _inputs(1, t=2, b=4, h=8)
    ts = [torch.from_numpy(a) for a in args]
    with pytest.raises(ValueError, match="must lie on"):
        gru_kernel.gru_chain_fwd_cuda(*ts)
    with pytest.raises(ValueError, match="must lie on"):
        gru_kernel.gru_chain_bwd_cuda(*ts, torch.zeros(2, 1, 4, 8), torch.from_numpy(ct))
    with pytest.raises(ValueError, match="w_hh must be"):
        gru_kernel.gru_chain_fwd_cuda(ts[0], ts[1][:, :4], ts[2], ts[3])
