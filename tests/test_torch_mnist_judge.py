"""The port's MNIST digit judge against the JAX package's, from the same
variables, and its numpy scores against scikit-learn.

- The 1×1 residual projections: Flax's 'SAME' padding at stride 2 on
  the judge's sides 7, 4 and 2 is torch's padding 0, exactly.
- An eval-mode forward (running statistics random, so they matter)
  within atol 1e-5 of JAX's probabilities.
- One train-mode Adadelta(0.5) step, the port's ``test_mnist.train_step``
  against the JAX CLI's step (``optax.adadelta``, the NLL of the clipped
  softmax, Flax's BatchNorm): the loss within rtol 1e-5; every
  parameter within rtol 1e-4 and lr·1e-5 of its gradient's largest
  magnitude (Adadelta's first step moves a weight by
  lr·√eps·g/√(0.1·g² + eps), whose slope in g is at most lr, and the
  gradients agree to 1e-5 of their largest); the BatchNorm running mean
  and variance within rtol 1e-4 and atol 1e-6.
- ``judge_accuracy``: its three numbers equal JAX's exactly, from the
  same VAE and judge weights and the same injected draws, over a tail
  batch and over the 21-batch cap; JAX's ``judge_accuracy`` runs as it
  is, on a stand-in trainer whose forward uses the injected ε. The
  digits are labelled as the (random) judge reads them, so the inputs
  score 1 and the other two numbers fall strictly between 0 and 1.
- The macro precision, recall and F1 and the accuracy equal
  ``sklearn.metrics``' to the last bit, a class never predicted and a
  predicted class never true included.
"""

from types import SimpleNamespace

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from sklearn.metrics import accuracy_score, f1_score, precision_score, recall_score

from arvae_tpu.data.loaders import EpochLoader
from arvae_tpu.models.image_vae import MnistVAE as FlaxMnistVAE
from arvae_tpu.training import resnet_judge as jax_judge
from arvae_tpu_torch import test_mnist
from arvae_tpu_torch.data.device_data import DeviceSplit
from arvae_tpu_torch.data.synthetic_digits import generate_digit_set
from arvae_tpu_torch.eval.classification import accuracy, precision_recall_f1
from arvae_tpu_torch.models.image_vae import MnistVAE
from arvae_tpu_torch.training.image_trainer import ImageVAETrainer
from arvae_tpu_torch.training.resnet_judge import MnistResNet, judge_accuracy
from arvae_tpu_torch.utils.convert import mnist_vae_from_flax, resnet_judge_from_flax

ATOL = 1e-5
LR = 0.5
# the two packages' gradients agree to this share of each one's largest
# magnitude, as in the other gradient tests
GRAD_ATOL_FRAC = 1e-5


def _flax_judge(seed=0):
    """JAX judge variables with random BatchNorm scales, biases and
    running statistics."""
    model = jax_judge.MnistResNet()
    variables = model.init(jax.random.key(seed), jnp.zeros((1, 1, 28, 28)), train=False)
    rng = np.random.RandomState(seed + 1)

    def jitter(path, x):
        name = path[-1].key
        shape = np.shape(x)
        if name in ("scale", "var"):
            return jnp.asarray(rng.uniform(0.5, 1.5, shape).astype(np.float32))
        if name in ("bias", "mean"):
            return jnp.asarray(0.1 * rng.randn(*shape).astype(np.float32))
        return x

    return model, jax.tree_util.tree_map_with_path(jitter, variables)


def _port_judge(variables):
    judge = MnistResNet()
    judge.load_state_dict(resnet_judge_from_flax(variables))
    return judge


def _digits(n, seed=2):
    imgs, digits = generate_digit_set(n, seed=seed)
    return (imgs[:, 0] * 255).astype(np.uint8), digits


@pytest.mark.parametrize("side", [7, 4, 2])
def test_same_padded_projection_is_torch_padding_zero(side):
    x = np.random.RandomState(side).randn(2, side, side, 3).astype(np.float32)
    conv = fnn.Conv(5, (1, 1), strides=2, use_bias=False)
    params = conv.init(jax.random.key(0), jnp.asarray(x))
    want = np.asarray(conv.apply(params, jnp.asarray(x)))
    w = torch.from_numpy(np.transpose(np.array(params["params"]["kernel"]), (3, 2, 0, 1)).copy())
    got = torch.nn.functional.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), w, stride=2)
    assert want.shape[1] == -(-side // 2) == got.shape[2]
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-6)


def test_eval_forward_matches_jax():
    model, variables = _flax_judge(0)
    judge = _port_judge(variables).eval()
    u8, _ = _digits(12)
    x = u8[:, None].astype(np.float32) / 255.0
    want = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = judge(torch.from_numpy(x))
    assert got.shape == (12, 10)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(got.argmax(-1).numpy(), want.argmax(-1))


def test_one_adadelta_step_matches_jax():
    model, variables = _flax_judge(3)
    judge = _port_judge(variables)
    u8, digits = _digits(16, seed=4)
    x = u8[:, None].astype(np.float32) / 255.0
    params, stats = variables["params"], variables["batch_stats"]
    optimizer = optax.adadelta(LR)

    def loss_fn(p):  # the JAX CLI's (test_mnist.py)
        probs, updates = model.apply({"params": p, "batch_stats": stats}, jnp.asarray(x),
                                     train=True, mutable=["batch_stats"])
        logp = jnp.log(jnp.clip(probs, 1e-8))
        nll = -jnp.take_along_axis(logp, jnp.asarray(digits)[:, None], axis=1).mean()
        return nll, updates["batch_stats"]

    (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    updates, _ = optimizer.update(grads, optimizer.init(params), params)
    want = resnet_judge_from_flax({"params": optax.apply_updates(params, updates),
                                   "batch_stats": new_stats})
    before = resnet_judge_from_flax(variables)
    gmax = {k: float(g.abs().max()) for k, g in resnet_judge_from_flax(
        {"params": grads, "batch_stats": stats}).items() if "running" not in k}

    opt = torch.optim.Adadelta(judge.parameters(), lr=LR, rho=0.9, eps=1e-6)
    got_loss = test_mnist.train_step(judge, opt, torch.from_numpy(x), torch.from_numpy(digits))
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-5)
    got = judge.state_dict()
    moved = 0
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        # Adadelta's step moves by at most lr per unit of gradient error,
        # and the gradients agree to GRAD_ATOL_FRAC of their largest
        atol = LR * GRAD_ATOL_FRAC * gmax[k] if k in gmax else 1e-6
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-4, atol=atol, err_msg=k)
        moved += k.endswith("running_var") and not torch.equal(w, before[k])
    assert moved == 20  # every BatchNorm's running variance moved


class MorphoMnistDataset:
    """The eval split the port's trainer reads; the class name is how the
    trainer tells MNIST apart."""

    def __init__(self, u8, digits):
        self.rows = u8.reshape(len(u8), -1)
        self.labels = np.concatenate([digits[:, None], np.zeros((len(u8), 6))], 1)

    def device_eval_split(self, device):
        return DeviceSplit(self.rows, self.labels.astype(np.float32), (1, 28, 28), "bytes",
                           device)


INTERP = {"area": [3, 0.4], "length": [0, 0.1], "thickness": [15, 0.2], "slant": [7, 0.3],
          "width": [2, 0.1], "height": [9, 0.2], "mean": [-1, 0.2]}


@pytest.mark.parametrize("n, batch", [(20, 8), (23, 1)])  # a tail batch; the 21-batch cap
def test_judge_accuracy_equals_jax(n, batch):
    flax_vae = FlaxMnistVAE()
    vae_params = flax_vae.init({"params": jax.random.key(5), "dropout": jax.random.key(6),
                                "sample": jax.random.key(7)}, jnp.zeros((1, 1, 28, 28)),
                               train=False)["params"]
    model, variables = _flax_judge(1)  # a random judge that tells 0 from 6
    u8, _ = _digits(n, seed=8)
    images = u8[:, None].astype(np.float32) / 255.0
    # label each digit as the judge reads it, so that the inputs score 1
    # and the reconstructions and traversals land in between
    digits = np.asarray(jax_judge.predict_digits((model, variables), jnp.asarray(images)))
    bounds = [(a, min(a + batch, n)) for a in range(0, n, batch)][:21]
    rng = np.random.RandomState(9)
    draws = [(rng.randn(b - a, 16).astype(np.float32), rng.randn(b - a, 16).astype(np.float32))
             for a, b in bounds]

    queue = list(draws)

    def fwd(params, inputs, key):  # the JAX trainer's forward, ε injected
        eps = jnp.asarray(queue.pop(0)[0])
        mean, log_std = flax_vae.apply({"params": params}, inputs, train=False,
                                       method="encode")
        z = mean + jnp.exp(log_std) * eps
        return SimpleNamespace(z_tilde=z, logits=flax_vae.apply(
            {"params": params}, z, train=False, method="decode"))

    def decode(z):
        return np.asarray(jax.nn.sigmoid(flax_vae.apply(
            {"params": vae_params}, jnp.asarray(z), train=False, method="decode")))

    stand_in = SimpleNamespace(
        dataset=SimpleNamespace(data_loaders=lambda batch_size: (
            None, None, EpochLoader((images, digits), batch_size, shuffle=False))),
        metrics={"interpretability": INTERP}, ensure_state=lambda: SimpleNamespace(
            params=vae_params), _forward_fn=lambda: fwd, decode=decode)
    want = jax_judge.judge_accuracy(stand_in, (model, variables), batch_size=batch)
    assert not queue  # one draw a batch, every batch the port sweeps

    port = MnistVAE()
    port.load_state_dict(mnist_vae_from_flax(vae_params))
    trainer = ImageVAETrainer(MorphoMnistDataset(u8, digits), port, torch.device("cpu"),
                              reg_type=("all",), reg_dim=(1, 2, 3, 4, 5, 6))
    trainer.metrics = {"interpretability": INTERP}
    got = judge_accuracy(trainer, _port_judge(variables), batch_size=batch,
                         noise=[tuple(torch.from_numpy(d) for d in pair) for pair in draws])
    assert got == want
    acc = got["digit_pred_acc"]
    assert acc["inputs"] == 1.0 and len(set(digits)) > 1
    assert 0.0 < acc["recons"] < 1.0 and 0.0 < acc["interp"] < 1.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scores_equal_sklearn(seed):
    rng = np.random.RandomState(seed)
    y_true = rng.randint(0, 10, 500)
    y_pred = np.where(rng.rand(500) < 0.7, y_true, rng.randint(0, 10, 500))
    y_pred[y_pred == 3] = 4  # class 3 is never predicted
    y_pred[:3] = 11  # a predicted class that is never true
    got = precision_recall_f1(y_true, y_pred)
    kw = dict(average="macro", zero_division=0)
    assert got == {"precision": precision_score(y_true, y_pred, **kw),
                   "recall": recall_score(y_true, y_pred, **kw),
                   "f1": f1_score(y_true, y_pred, **kw)}
    assert accuracy(y_true, y_pred) == accuracy_score(y_true, y_pred)
