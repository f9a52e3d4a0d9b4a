"""The convolutions' weight-gradient kernel on the card. Marked ``gpu``:
without a CUDA card every case skips.

Run on the card with ``python -m pytest --noconftest
tests/test_torch_conv_wgrad_cuda.py``. At every conv layer shape of
``DspritesVAE`` and ``MnistVAE`` at B = 128, 120 and 64 (a rank's half at
two ranks) the kernel is held against the plain version in float64
within 1e-5 of the largest entry (fp32 sums of up to 131,072 terms in
another order), and two calls must be bitwise equal. Through the
Functions, the input and bias gradients must be bitwise those of
autograd's own call (cuDNN's deterministic dgrad and the bias's sum).
An eager dSprites step and an eager fader step run the kernel 8 times
(the 8 layers' weight gradients), a replay of the step's graph not at
all from its wrapper; a step repeats bitwise in a second process."""

import subprocess
import sys

import pytest
import torch

from arvae_tpu_torch.models.image_fader import DspritesFaderNetwork
from arvae_tpu_torch.models.image_vae import DspritesVAE, MnistVAE
from arvae_tpu_torch.ops import conv_wgrad_kernel as cw
from arvae_tpu_torch.training import base
from arvae_tpu_torch.training.fader_trainer import ImageFaderTrainer
from arvae_tpu_torch.training.image_trainer import ImageVAETrainer

pytestmark = pytest.mark.gpu

MODELS = {"dsprites": (DspritesVAE, 64), "mnist": (MnistVAE, 28)}
LAYERS = [(m, i) for m, n in (("dsprites", 8), ("mnist", 6)) for i in range(n)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    return torch.device("cuda", torch.cuda.current_device())


def _layer(model, index, batch, dev=None):
    cls, size = MODELS[model]
    net = cls(seed=0)
    if dev is not None:
        net = net.to(dev)
    z = torch.zeros(batch, net.z_dim, device=dev)
    return cw.conv_inputs(net, torch.zeros(batch, 1, size, size, device=dev), z, z)[index][1:]


def _maps(layer, x_shape, dev, seed):
    small, large = cw.layer_maps(layer, x_shape)
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(small, device=dev, generator=g),
            torch.randn(large, device=dev, generator=g))


def _assert_close(got, want):
    err = float((got.double() - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err


@pytest.mark.parametrize("batch", [128, 120, 64])
@pytest.mark.parametrize("model,index", LAYERS)
def test_kernel_matches_plain_and_repeats_bitwise(dev, model, index, batch):
    layer, x_shape = _layer(model, index, batch)
    s, l = _maps(layer, x_shape, dev, 17 * index + batch)
    first = cw.conv_wgrad_cuda(s, l, layer.stride, layer.padding)
    second = cw.conv_wgrad_cuda(s, l, layer.stride, layer.padding)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))
    assert first.shape == layer.weight.shape
    _assert_close(first, cw.conv_wgrad_reference(s.double(), l.double(), layer.stride,
                                                 layer.padding))


def test_library_counts_the_plans_shared_memory(dev):
    for model, index in LAYERS:
        layer, x_shape = _layer(model, index, 128)
        small, large = cw.layer_maps(layer, x_shape)
        plan = cw.conv_wgrad_plan(small, large, layer.stride, layer.padding)
        assert cw.smem_bytes(small[3], layer.stride[0], plan) == plan.smem


@pytest.mark.parametrize("model,index", LAYERS)
def test_input_and_bias_gradients_are_autograds_bitwise(dev, model, index):
    layer, x_shape = _layer(model, index, 128, dev)
    g = torch.Generator(device=dev).manual_seed(index)
    x = torch.randn(x_shape, device=dev, generator=g).requires_grad_()
    leaves = [x, layer.weight, layer.bias]
    want_y = layer(x)
    gy = torch.randn(want_y.shape, device=dev, generator=g)
    want = torch.autograd.grad(want_y, leaves, gy)
    cw.reset_launches()
    y = cw.conv_layer(layer, x)
    got = torch.autograd.grad(y, leaves, gy)
    torch.cuda.synchronize()
    assert cw.ROUTES["kernel"] == 1 and cw.LAUNCHES["wgrad"] == 1
    assert torch.equal(y, want_y)
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    _assert_close(got[1], want[1].double())


def _batches(dev, batch, n):
    g = torch.Generator().manual_seed(3)
    return [((torch.rand((batch, 1, 64, 64), generator=g) < 0.5).float().to(dev),
             torch.rand((batch, 6), generator=g).to(dev)) for _ in range(n)]


TRAINERS = {
    "dsprites": lambda dev: ImageVAETrainer(None, DspritesVAE(seed=0), dev, rand=7,
                                            reg_type=("all",), reg_dim=(1, 2, 3, 4, 5)),
    "fader": lambda dev: ImageFaderTrainer(None, DspritesFaderNetwork(seed=0), dev, rand=7),
}


@pytest.mark.parametrize("name", list(TRAINERS))
def test_an_eager_step_launches_8_and_a_replay_none(dev, name):
    tr = TRAINERS[name](dev)
    batches = _batches(dev, 128, base.WARMUP_STEPS + 2)
    base.reset_step_counts()
    for i, b in enumerate(batches):
        cw.reset_launches()
        tr.train_step(b)
        replay = i > base.WARMUP_STEPS
        assert cw.LAUNCHES["wgrad"] == (0 if replay else 8), i
        assert cw.ROUTES["kernel"] == (0 if replay else 8), i
    torch.cuda.synchronize()
    assert base.GRAPH_STEPS == {"captured": 1, "replayed": 2}


STEP_SCRIPT = """
import hashlib, torch
from arvae_tpu_torch.models.image_vae import DspritesVAE
from arvae_tpu_torch.training.image_trainer import ImageVAETrainer
dev = torch.device("cuda")
tr = ImageVAETrainer(None, DspritesVAE(seed=0), dev, rand=7, reg_type=("all",),
                     reg_dim=(1, 2, 3, 4, 5))
g = torch.Generator().manual_seed(3)
for _ in range(4):
    tr.train_step(((torch.rand((128, 1, 64, 64), generator=g) < 0.5).float().to(dev),
                   torch.rand((128, 6), generator=g).to(dev)))
h = hashlib.sha256()
for k, v in tr.model.state_dict().items():
    h.update(k.encode() + v.cpu().numpy().tobytes())
print(h.hexdigest())
"""


def test_a_dsprites_step_repeats_bitwise_across_processes(dev):
    digests = [subprocess.run([sys.executable, "-c", STEP_SCRIPT], capture_output=True,
                              text=True, check=True).stdout.split()[-1] for _ in range(2)]
    assert digests[0] == digests[1]
