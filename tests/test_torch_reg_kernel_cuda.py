"""The hand-written CUDA reg kernels against their plain PyTorch versions,
on the card. Marked ``gpu``: without a CUDA card every case skips.

Run on the card with ``python -m pytest tests/test_torch_reg_kernel_cuda.py``.
Tolerances as ``chip_smoke.py`` states them: fwd rtol 1e-5 (1e-4 at
B=8192, where each loss sums 67M float32 terms in another order), bwd
rtol 1e-4, atol 1e-6; repeats must be bitwise equal."""

import numpy as np
import pytest
import torch

from arvae_tpu_torch.ops import reg_kernel as rk

pytestmark = pytest.mark.gpu


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


@pytest.mark.parametrize("delta", [1.0, 10.0])
@pytest.mark.parametrize("r,b", [(5, 128), (4, 256), (5, 100), (3, 700), (2, 8192)])
def test_kernels_match_plain_and_repeat_bitwise(dev, r, b, delta):
    z, a, ct = _inputs(r, b, dev)
    d = torch.tensor([delta], device=dev)
    f1, f2 = rk.reg_loss_fwd_cuda(z, a, d), rk.reg_loss_fwd_cuda(z, a, d)
    (dz1, dd1), (dz2, dd2) = (rk.reg_loss_bwd_cuda(z, a, d, ct),
                              rk.reg_loss_bwd_cuda(z, a, d, ct))
    torch.cuda.synchronize()
    assert torch.equal(f1, f2) and torch.equal(dz1, dz2) and torch.equal(dd1, dd2)
    fwd_rtol = 1e-4 if b > 1024 else 1e-5
    torch.testing.assert_close(f1, rk.reg_loss_fwd_reference(z, a, d),
                               rtol=fwd_rtol, atol=1e-6)
    dz_ref, dd_ref = rk.reg_loss_bwd_reference(z, a, d, ct)
    torch.testing.assert_close(dz1, dz_ref, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(dd1.reshape(()), dd_ref, rtol=1e-4, atol=1e-6)


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


def test_wrapper_rejects_bad_inputs(dev):
    z, a, ct = _inputs(2, 64, dev)
    d = torch.ones(1, device=dev)
    with pytest.raises(ValueError):
        rk.reg_loss_fwd_cuda(z.double(), a, d)
    with pytest.raises(ValueError):
        rk.reg_loss_fwd_cuda(z.t(), a.t(), d)
    with pytest.raises(ValueError):
        rk.reg_loss_bwd_cuda(z, a, d, ct[:1])
