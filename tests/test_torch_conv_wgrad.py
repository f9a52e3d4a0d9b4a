"""The convolutions' weight gradient on the CPU: the plain version against
autograd at every layer shape of the image VAEs, the launch plan's split
counts and refusals, the float32 route of ``_apply_layer`` on the CPU and
under bfloat16, and the models' parameters and ``state_dict`` keys.

The kernel itself runs only on a card (``test_torch_conv_wgrad_cuda.py``)."""

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from arvae_tpu_torch.models.image_vae import DspritesVAE, MaskedDropout, MnistVAE
from arvae_tpu_torch.ops import conv_wgrad_kernel as cw
from arvae_tpu_torch.utils import kernel_work as kw


def _assert_close(got, want):
    """Within 1e-5 of the largest entry: fp32 sums of thousands of terms
    in another order."""
    assert got.shape == want.shape
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err


def _conv_inputs(model, batch):
    """[(name, layer, input shape)] of each conv layer of ``model`` on a
    batch of ``batch`` images."""
    size = 64 if isinstance(model, DspritesVAE) else 28
    z = torch.zeros(batch, model.z_dim)
    return cw.conv_inputs(model, torch.zeros(batch, 1, size, size), z, z)


MODELS = {"dsprites": DspritesVAE, "mnist": MnistVAE}
LAYERS = [(m, i) for m, n in (("dsprites", 8), ("mnist", 6)) for i in range(n)]


def _layer(model, index, batch):
    return _conv_inputs(MODELS[model](seed=0), batch)[index]


@pytest.mark.parametrize("model,index", LAYERS)
def test_plain_version_matches_autograd_at_every_layer_shape(model, index):
    name, layer, x_shape = _layer(model, index, 3)
    g = torch.Generator().manual_seed(index)
    x = torch.randn(x_shape, generator=g)
    y = layer(x)
    gy = torch.randn(y.shape, generator=g)
    small, large = cw.layer_maps(layer, x_shape)
    transposed = isinstance(layer, nn.ConvTranspose2d)
    assert (small, large) == ((x_shape, tuple(y.shape)) if transposed else
                              (tuple(y.shape), x_shape))
    if transposed:
        w = layer.weight.detach().requires_grad_()
        want, = torch.autograd.grad(F.conv_transpose2d(x, w, None, layer.stride, layer.padding),
                                    w, gy)
        got = cw.conv_wgrad_reference(x, gy, layer.stride, layer.padding)
    else:
        want = torch.nn.grad.conv2d_weight(x, layer.weight.shape, gy, layer.stride,
                                           layer.padding)
        got = cw.conv_wgrad_reference(gy, x, layer.stride, layer.padding)
    assert got.shape == layer.weight.shape
    _assert_close(got, want)


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("bias", [True, False])
def test_functions_forward_the_layer_and_take_no_cpu_weight_gradient(transposed, bias):
    """The Functions' forward is the layer's own (bitwise: the same call);
    their weight gradient is the kernel's or a raise, never the plain
    version on a CPU tensor (the router keeps CPU tensors on ``layer(h)``;
    the card tests compare the gradients)."""
    torch.manual_seed(0)
    cls = nn.ConvTranspose2d if transposed else nn.Conv2d
    layer = cls(8, 16, 4, 2, 1, bias=bias)
    x = torch.randn(2, 8, 6, 6, requires_grad=True)
    fn = cw.ConvTranspose2dWgrad if transposed else cw.Conv2dWgrad
    args = (layer.stride, layer.padding) + ((layer.output_padding,) if transposed else ())
    y = fn.apply(x, layer.weight, layer.bias, *args)
    assert torch.equal(y, layer(x))
    cw.reset_launches()
    with pytest.raises(ValueError, match="CUDA device"):
        torch.autograd.grad(y, [x, layer.weight], torch.randn(y.shape))
    assert cw.LAUNCHES["wgrad"] == 0


def test_functions_skip_gradients_nobody_wants():
    """No weight gradient wanted: the kernel is not called (so this runs on
    the CPU), and the input and bias gradients are autograd's bitwise."""
    layer = nn.Conv2d(1, 8, 4, 2, 1)
    x = torch.randn(2, 1, 8, 8, requires_grad=True)
    layer.weight.requires_grad_(False)
    y = cw.Conv2dWgrad.apply(x, layer.weight, layer.bias, layer.stride, layer.padding)
    got = torch.autograd.grad(y.sum(), [x, layer.bias])
    want = torch.autograd.grad(layer(x).sum(), [x, layer.bias])
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("batch", [128, 120, 64])
@pytest.mark.parametrize("model,index", LAYERS)
def test_plans_fill_a_wave_and_fit_the_card(model, index, batch):
    """Every layer shape at the training batch, a data-parallel rank's
    half and a tail batch: one CTA an SM (a CTA takes a whole SM), at most
    one a row of positions, the staging ring within its budget and shared memory within
    a block's, the tile held by 512 threads."""
    _, layer, x_shape = _layer(model, index, batch)
    small, large = cw.layer_maps(layer, x_shape)
    plan = cw.conv_wgrad_plan(small, large, layer.stride, layer.padding)
    units = small[0] * small[2]
    assert plan.ctas == cw.SMS
    assert plan.splits <= units
    assert plan.groups * (plan.m_tile // 8) * 2 * plan.c_tile == cw.THREADS
    assert small[1] % plan.m_tile == 0 and large[1] % plan.c_tile == 0
    assert 1 <= plan.rows <= min(cw.MAX_ROWS, small[2])
    assert 1 <= plan.stages <= cw.MAX_STAGES
    buf = cw.buffer_bytes(small[3], layer.stride[0], plan.m_tile, plan.c_tile, plan.rows)
    assert plan.stages * buf <= max(cw.STAGING_BYTES, buf)
    assert plan.smem == cw.layout_smem(small[3], layer.stride[0], plan.m_tile, plan.c_tile,
                                       plan.rows, plan.stages) <= cw.MAX_SMEM
    assert plan.grid == (plan.splits, large[1] // plan.c_tile, small[1] // plan.m_tile)


# The dSprites VAE's plans at B=128, encoder then decoder: (ct, G, R,
# stages, splits)
DSPRITES_PLANS = [(1, 64, 8, 3, 132), (16, 4, 8, 2, 66), (8, 8, 8, 5, 33), (8, 8, 4, 5, 33),
                  (8, 8, 4, 5, 33), (8, 8, 8, 5, 33), (16, 4, 8, 2, 66), (1, 64, 8, 3, 132)]


@pytest.mark.parametrize("index", range(8))
def test_the_dsprites_plans_depend_on_the_shape_alone(index):
    _, layer, x_shape = _layer("dsprites", index, 128)
    small, large = cw.layer_maps(layer, x_shape)
    plan = cw.conv_wgrad_plan(small, large, layer.stride, layer.padding)
    assert (plan.c_tile, plan.groups, plan.rows, plan.stages, plan.splits) == \
        DSPRITES_PLANS[index]
    assert plan.m_tile == 32


REFUSED = {
    "groups": dict(groups=2),
    "dilation": dict(dilation=(2, 2)),
    "3x3 window": dict(kernel_size=(3, 3)),
    "5x5 window": dict(kernel_size=5),
    "stride (2, 1)": dict(stride=(2, 1)),
    "padding 4": dict(padding=4),
    "12 rows of dW": dict(small=(4, 12, 8, 8)),
    "48 channels": dict(large=(4, 48, 16, 16)),
    "two batches": dict(large=(5, 32, 16, 16)),
    "a row too wide for shared memory": dict(small=(1, 32, 1, 4096), large=(1, 32, 2, 8192)),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_plan_refuses_what_the_kernel_does_not_take(case):
    args = dict(small=(4, 32, 8, 8), large=(4, 32, 16, 16), stride=2, padding=1)
    args.update(REFUSED[case])
    assert cw.plan_refusal(**args) is not None
    with pytest.raises(ValueError, match="does not take"):
        cw.conv_wgrad_plan(**args)


def test_plan_accepts_the_layers_and_refuses_a_grouped_one():
    for model, index in LAYERS:
        _, layer, x_shape = _layer(model, index, 4)
        assert cw._layer_refusal(x_shape, layer.groups, layer.padding_mode,
                                 *cw._layer_args(layer)) is None
    grouped = nn.Conv2d(32, 32, 4, 2, 1, groups=2)
    assert cw._layer_refusal((4, 32, 16, 16), 2, "zeros", *cw._layer_args(grouped))
    circular = nn.Conv2d(32, 32, 4, 2, 1, padding_mode="circular")
    assert cw._layer_refusal((4, 32, 16, 16), 1, "circular", *cw._layer_args(circular))


@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("grad", [True, False])
def test_route_on_the_cpu_is_the_layer_itself(model, grad):
    """On the CPU every conv layer is ``layer(h)`` (route ``cpu``, no
    launch), so the step is bitwise the layers' own."""
    net = MODELS[model](seed=0)
    size = 64 if model == "dsprites" else 28
    x = torch.rand(2, 1, size, size)
    eps, prior = torch.randn(2, net.z_dim), torch.randn(2, net.z_dim)
    cw.reset_launches()
    with torch.set_grad_enabled(grad):
        out = net(x, eps, prior)
    n = 8 if model == "dsprites" else 6
    assert cw.ROUTES == {**{k: 0 for k in cw.ROUTES}, "cpu": n}
    assert cw.LAUNCHES == {"wgrad": 0}
    h = x
    with torch.set_grad_enabled(grad):
        for layer in net.enc_conv:
            h = layer(h, None) if isinstance(layer, MaskedDropout) else layer(h)
    assert torch.equal(net._stack(net.enc_conv, x, None) if model == "mnist"
                       else net._run(net.enc_conv, x), h)
    assert out.logits.dtype == torch.float32


def test_bfloat16_branch_takes_no_route():
    net = MnistVAE(seed=0, compute_dtype=torch.bfloat16)
    cw.reset_launches()
    net(torch.rand(2, 1, 28, 28), torch.randn(2, 16), torch.randn(2, 16))
    assert all(v == 0 for v in cw.ROUTES.values())


STATE_KEYS = {
    "dsprites": [f"{s}.{i}.{p}" for s, idx in (("enc_conv", (0, 2, 4, 6)),) for i in idx
                 for p in ("weight", "bias")]
    + [f"enc_lin.{i}.{p}" for i in (0, 2) for p in ("weight", "bias")]
    + [f"{h}.{p}" for h in ("enc_mean", "enc_log_std") for p in ("weight", "bias")]
    + [f"dec_lin.{i}.{p}" for i in (0, 2, 4) for p in ("weight", "bias")]
    + [f"dec_conv.{i}.{p}" for i in (0, 2, 4, 6) for p in ("weight", "bias")],
    "mnist": [f"enc_conv.{i}.{p}" for i in (0, 3, 6) for p in ("weight", "bias")]
    + [f"enc_lin.0.{p}" for p in ("weight", "bias")]
    + [f"{h}.{p}" for h in ("enc_mean", "enc_log_std") for p in ("weight", "bias")]
    + [f"dec_lin.{i}.{p}" for i in (0, 2) for p in ("weight", "bias")]
    + [f"dec_conv.{i}.{p}" for i in (0, 3, 6) for p in ("weight", "bias")],
}


@pytest.mark.parametrize("model", list(MODELS))
def test_state_dict_keys_and_parameters_unchanged(model):
    net = MODELS[model](seed=0)
    sd = net.state_dict(keep_vars=True)
    assert list(sd) == STATE_KEYS[model]
    params = dict(net.named_parameters())
    assert all(sd[k] is params[k] for k in sd)
    for _, layer, _ in _conv_inputs(net, 2):
        assert layer.weight is params[next(k for k, v in params.items() if v is layer.weight)]


def test_work_of_the_dsprites_weight_gradients():
    """The 8 layers at B=128: 3.09 GFLOP (the issue's sizing)."""
    total = 0
    for _, layer, x_shape in _conv_inputs(DspritesVAE(seed=0), 128):
        small, large = cw.layer_maps(layer, x_shape)
        total += kw.conv_wgrad(*small, *large[1:]).flop
    assert total == 3_087_007_744
