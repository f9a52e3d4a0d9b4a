"""The hand-written CUDA reg kernels against their plain PyTorch versions,
on the card. Marked ``gpu``: without a CUDA card every case skips.

Run on the card with ``python -m pytest --noconftest
tests/test_torch_reg_kernel_cuda.py``. Tolerances as ``chip_smoke.py``
states them: losses rtol 1e-5 (1e-4 at B=8192, where each loss sums 67M
float32 terms in another order), the gradient and its factors rtol 1e-4,
atol 1e-6; repeats must be bitwise equal."""

import numpy as np
import pytest
import torch

from arvae_tpu_torch.ops import hier_decoder_kernel as hk
from arvae_tpu_torch.ops import reg_kernel as rk

pytestmark = pytest.mark.gpu

BWD = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(r, b, dev):
    rng = np.random.RandomState(r * 7919 + b)
    z = torch.tensor(rng.randn(r, b), dtype=torch.float32, device=dev)
    a = torch.tensor(rng.randint(0, 4, (r, b)), dtype=torch.float32, device=dev)
    ct = torch.tensor(rng.randn(r), dtype=torch.float32, device=dev)
    return z, a, ct


def _stacked(r):
    return tuple((i, i) for i in range(r))


@pytest.mark.parametrize("delta", [1.0, 10.0])
@pytest.mark.parametrize("r,b", [(5, 128), (4, 256), (5, 100), (3, 700), (2, 8192)])
def test_kernels_match_plain_and_repeat_bitwise(dev, r, b, delta):
    z, a, ct = _inputs(r, b, dev)
    d = torch.tensor([delta], device=dev)
    dims = _stacked(r)
    runs = []
    for _ in range(2):
        loss, g, dd = rk.reg_fwd_cuda(z.t(), a.t(), dims, d)
        dz, ddelta = rk.reg_bwd_cuda(g, dd, ct, dims, r, col_major=True)
        runs.append((loss, g, dd, dz, ddelta))
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(*runs))
    loss, g, dd, dz, ddelta = runs[0]
    fwd_rtol = 1e-4 if b > 1024 else 1e-5
    loss_ref, g_ref, d_ref = rk.reg_fwd_factors_reference(z, a, d)
    torch.testing.assert_close(loss, loss_ref, rtol=fwd_rtol, atol=1e-6)
    torch.testing.assert_close(g, g_ref, **BWD)
    torch.testing.assert_close(dd, d_ref, **BWD)
    # the backward against its plain version on the kernel's factors, and
    # the pair against the golden VJP
    dz_scale, dd_scale = rk.reg_bwd_scale_reference(g, dd, ct)
    torch.testing.assert_close(dz.t(), dz_scale, **BWD)
    torch.testing.assert_close(ddelta.reshape(()), dd_scale, **BWD)
    dz_ref, dd_ref = rk.reg_loss_bwd_reference(z, a, d, ct)
    torch.testing.assert_close(dz.t(), dz_ref, **BWD)
    torch.testing.assert_close(ddelta.reshape(()), dd_ref, **BWD)
    # without factors: the same losses, bitwise
    alone, g0, d0 = rk.reg_fwd_cuda(z.t(), a.t(), dims, d, factors=False)
    assert g0 is None and d0 is None and torch.equal(alone, loss)


# the in-place entry: (z_tilde shape, label columns, dims, label dtype, strided)
COLUMN_CASES = {
    "dsprites": ((128, 10), 6, tuple((c, c) for c in range(1, 6)), torch.float32, False),
    "music": ((256, 32), 4, tuple((c, c) for c in range(4)), torch.float32, False),
    "repeated_dim_strided": ((128, 10), 6, ((1, 1), (3, 2), (1, 4)), torch.float32, True),
    "int64_labels": ((128, 10), 6, tuple((c, c) for c in range(1, 6)), torch.int64, False),
}


@pytest.mark.parametrize("case", list(COLUMN_CASES))
@pytest.mark.parametrize("delta", [1.0, 10.0])
def test_in_place_entry_matches_stacked_plain_path(dev, case, delta):
    (b, zd), nl, dims, ldtype, strided = COLUMN_CASES[case]
    rng = np.random.RandomState(b + zd + nl)
    wide = torch.tensor(rng.randn(b, 2 * zd), dtype=torch.float32, device=dev)
    z = wide[:, ::2] if strided else wide[:, :zd].contiguous()
    labels = torch.tensor(rng.randint(0, 4, (b, nl)), device=dev).to(ldtype)
    ct = torch.tensor(rng.randn(len(dims)), dtype=torch.float32, device=dev)
    d = torch.tensor(delta, device=dev)

    runs = []
    for _ in range(2):
        zg = z.detach().clone().requires_grad_(True) if not strided else \
            wide.detach().clone().requires_grad_(True)
        rk.reset_launches()
        losses = rk.reg_losses(zg[:, ::2] if strided else zg, labels, dims, d)
        (losses * ct).sum().backward()
        assert rk.LAUNCHES == {"fwd": 1, "bwd": 1}
        runs.append((losses.detach(), zg.grad[:, ::2] if strided else zg.grad))
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(*runs))
    losses, dz = runs[0]

    z_cols, a_cols = rk.stack_columns(z, labels.float(), dims)
    torch.testing.assert_close(losses, rk.reg_loss_fwd_reference(z_cols, a_cols, d),
                               rtol=1e-5, atol=1e-6)
    dz_cols, _ = rk.reg_loss_bwd_reference(z_cols, a_cols, d, ct)
    torch.testing.assert_close(dz, rk.scatter_columns(dz_cols, dims, zd), **BWD)
    named = {c for c, _ in dims}
    for c in range(zd):
        if c not in named:
            assert torch.equal(dz[:, c], torch.zeros_like(dz[:, c]))


def test_autograd_function_launches_kernels(dev):
    z, a, ct = _inputs(5, 128, dev)
    zg = z.clone().requires_grad_(True)
    dg = torch.tensor(1.0, device=dev, requires_grad=True)
    rk.reset_launches()
    (rk.fused_reg_loss(zg, a.long(), dg) * ct).sum().backward()
    assert rk.LAUNCHES == {"fwd": 1, "bwd": 1}
    dz_ref, dd_ref = rk.reg_loss_bwd_reference(z, a, torch.ones(1, device=dev), ct)
    torch.testing.assert_close(zg.grad, dz_ref, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(dg.grad, dd_ref, rtol=1e-4, atol=1e-6)
    # under no_grad one forward launch, without factors
    rk.reset_launches()
    with torch.no_grad():
        rk.fused_reg_loss(zg, a, dg)
    assert rk.LAUNCHES == {"fwd": 1, "bwd": 0}


def test_plan_runs_in_one_wave_of_resident_clusters(dev):
    for r, b in ((5, 128), (4, 256), (2, 8192), (32, 128)):
        plan = rk.reg_plan(r, b)
        held = rk.resident_clusters(plan.clusters, plan.threads)
        assert held >= hk.RESIDENT_CLUSTERS[plan.clusters] and r <= held


def test_wrapper_rejects_bad_inputs(dev):
    z, a, ct = _inputs(2, 64, dev)
    d = torch.ones(1, device=dev)
    dims = _stacked(2)
    with pytest.raises(ValueError):
        rk.reg_fwd_cuda(z.t().double(), a.t(), dims, d)
    with pytest.raises(ValueError):
        rk.reg_fwd_cuda(z.t(), a.t(), ((2, 0),), d)  # no latent column 2
    with pytest.raises(ValueError):
        rk.reg_fwd_cuda(z.t(), a.t(), _stacked(2) * 17, d)  # 34 dims
    _, g, dd = rk.reg_fwd_cuda(z.t(), a.t(), dims, d)
    with pytest.raises(ValueError):
        rk.reg_bwd_cuda(g, dd, ct[:1], dims, 2)
