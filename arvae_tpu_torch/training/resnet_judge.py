"""The MNIST digit judge: a ResNet-18 on 1×28×28 digits with a softmax
output.

Counterpart of ``arvae_tpu/training/resnet_judge.py``: the same network
(a 7×7 stride-2 stem, a 3×3 stride-2 max pool, eight basic blocks of
64, 64, 128, 128, 256, 256, 512, 512 channels with 1×1 projections
where the shape changes, global mean pool, a 10-way dense layer), with
torchvision's ResNet-18 layer names, so ``utils/convert.py``'s
``resnet_judge_from_flax`` maps the Flax variables onto it. The judge
scores how well a VAE keeps digit identity in its reconstructions and
latent traversals (``judge_accuracy``, behind the MNIST evaluation's
``digit_pred_acc``). ``arvae_tpu_torch/test_mnist.py`` trains it and
saves ``ckpt.pt`` under ``<models_root>/torch/MnistRESNET/``; ``load_judge``
reads that file (the JAX judge's orbax directory is not read).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from arvae_tpu_torch.core.checkpoint import Checkpointer
from arvae_tpu_torch.core.config import run_dir

JUDGE_REPR = "MnistRESNET"
# Flax's BatchNorm defaults: running = 0.99·running + 0.01·batch
BN_MOMENTUM, BN_EPS = 0.99, 1e-5
# judge_accuracy's sweep: at most this many eval batches (the JAX cap)
JUDGE_BATCHES = 21
# Offset of the sweep's draws' seed from ``rand``
_JUDGE_SEED_OFFSET = 11_000_000


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm as Flax's ``nn.BatchNorm`` computes it: the batch's mean
    and its biased variance E[x²] − E[x]² normalise in training and move
    the running statistics by ``BN_MOMENTUM``; eval mode normalises by
    the running ones. (``nn.BatchNorm2d`` would move them by 0.1 with
    the unbiased variance.)"""

    def __init__(self, channels: int):
        super().__init__(channels, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp_min((x * x).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
            with torch.no_grad():
                self.running_mean.copy_(BN_MOMENTUM * self.running_mean
                                        + (1 - BN_MOMENTUM) * mean)
                self.running_var.copy_(BN_MOMENTUM * self.running_var
                                       + (1 - BN_MOMENTUM) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = FlaxBatchNorm2d(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = FlaxBatchNorm2d(cout)
        # Flax's 1×1 projection pads 'SAME', which at stride 2 on the
        # judge's sides (7, 4, 2) pads nothing: padding 0 here
        self.downsample = (nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False),
                                         FlaxBatchNorm2d(cout))
                           if stride != 1 or cin != cout else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + (x if self.downsample is None else self.downsample(x)))


class MnistResNet(nn.Module):
    """ResNet-18 for (B, 1, 28, 28) digits → (B, 10) softmax probabilities."""

    WIDTHS = (64, 128, 256, 512)

    def __init__(self, num_classes: int = 10, seed: int = 0):
        super().__init__()
        self.conv1 = nn.Conv2d(1, 64, 7, 2, 3, bias=False)
        self.bn1 = FlaxBatchNorm2d(64)
        cin = 64
        for i, cout in enumerate(self.WIDTHS):
            stride = 1 if i == 0 else 2
            setattr(self, f"layer{i + 1}", nn.Sequential(BasicBlock(cin, cout, stride),
                                                        BasicBlock(cout, cout, 1)))
            cin = cout
        self.fc = nn.Linear(cin, num_classes)
        self.init_weights(torch.Generator().manual_seed(seed))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Flax's defaults: LeCun-normal kernels (a normal truncated at ±2σ,
        σ rescaled to keep the variance 1/fan_in) and zero biases."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for i in range(len(self.WIDTHS)):
            x = getattr(self, f"layer{i + 1}")(x)
        return torch.softmax(self.fc(x.mean(dim=(2, 3))), dim=-1)


def judge_run_dir() -> str:
    return run_dir(JUDGE_REPR)


def load_judge(device: torch.device) -> Optional[MnistResNet]:
    """The trained judge in eval mode on ``device``, or None when
    ``<models_root>/torch/MnistRESNET/ckpt.pt`` does not exist."""
    ckpt = Checkpointer(judge_run_dir())
    if not ckpt.exists():
        return None
    judge = MnistResNet()
    judge.load_state_dict(ckpt.restore(device)["model"])
    return judge.to(device).eval()


def predict_digits(judge: MnistResNet, images: torch.Tensor) -> torch.Tensor:
    """The judge's digit for each image (the lowest on a tie)."""
    return torch.argmax(judge(images), dim=-1)


@torch.no_grad()
def judge_accuracy(trainer, judge: MnistResNet, batch_size: int = 128,
                   num_interps: int = 10, noise: Optional[Sequence] = None) -> Dict:
    """The judge's digit accuracy on the eval split's inputs, on their
    reconstructions and on latent traversals, over at most
    ``JUDGE_BATCHES`` batches (the tail included) in order.

    A traversal sets one attribute's latent dim (the interpretability
    metric's ``trainer.metrics["interpretability"][attr][0]``) to each of
    ``num_interps`` points in [−4, 4] and decodes; its accuracy is the
    mean over the attributes. Each batch is encoded in eval mode with a
    sampled z: draws from a generator seeded from ``rand`` or, per
    batch, the injected ``noise``. The correct counts stay on the device
    until one host read; the means are the JAX package's float64 ones."""
    interp = trainer.metrics["interpretability"]
    dims = [v[0] for k, v in interp.items() if k != "mean"]
    sp = trainer.eval_split()
    dev = sp.device
    bounds = [(a, min(a + batch_size, sp.n))
              for a in range(0, sp.n, batch_size)][:JUDGE_BATCHES]
    draws = trainer._eval_draws(noise, len(bounds), _JUDGE_SEED_OFFSET)
    x1 = torch.from_numpy(np.linspace(-4.0, 4.0, num_interps).astype(np.float32)).to(dev)
    trainer.model.eval()
    judge.eval()
    counts = []
    for i, (a, b) in enumerate(bounds):
        imgs, labels = sp.gather_batch(torch.arange(a, b, device=dev))
        digits = labels[:, 0].long()
        out = trainer.model(imgs, *draws(i, b - a))
        row = [(predict_digits(judge, imgs) == digits).sum(),
               (predict_digits(judge, torch.sigmoid(out.logits)) == digits).sum()]
        z_rep = out.z_tilde.repeat(num_interps, 1)
        rep_digits = digits.repeat(num_interps)
        for dim in dims:
            z = z_rep.clone()
            z[:, dim] = x1.repeat_interleave(b - a)
            decoded = torch.sigmoid(trainer.model.decode(z))
            row.append((predict_digits(judge, decoded) == rep_digits).sum())
        counts.append(torch.stack(row))
    counts = torch.stack(counts).cpu().numpy()  # the sweep's one host read
    input_acc = recons_acc = interp_acc = 0.0
    for (a, b), row in zip(bounds, counts):
        n = b - a
        input_acc += float(row[0] / n)
        recons_acc += float(row[1] / n)
        dummy = 0.0
        for c in row[2:]:
            dummy += float(c / (n * num_interps))
        interp_acc += dummy / max(len(dims), 1)
    nb = max(len(bounds), 1)
    return {"digit_pred_acc": {"inputs": input_acc / nb, "recons": recons_acc / nb,
                               "interp": interp_acc / nb}}
