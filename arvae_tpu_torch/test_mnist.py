"""Train the MNIST digit judge (a ResNet-18) with the PyTorch port.

Flag names follow the root ``test_mnist.py``. Run as a module:

    python -m arvae_tpu_torch.test_mnist --batch_size 256 --num_epochs 5

Each epoch takes Adadelta(lr, rho 0.9, eps 1e-6) steps (optax's
``adadelta``) on the NLL of the clipped softmax over the shuffled train
digits, then prints the macro precision, recall, F1 and the accuracy on
the t10k digits and saves the judge to ``<models_root>/torch/MnistRESNET/ckpt.pt``,
which the MNIST AR-VAE's evaluation reads for ``digit_pred_acc``.
``--augment`` shifts each training image by up to 2 pixels each way.
``--device`` defaults to ``cuda``; without a card the script raises
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from arvae_tpu_torch.core.checkpoint import Checkpointer
from arvae_tpu_torch.core.config import add_switch
from arvae_tpu_torch.data.mnist import MnistDataset
from arvae_tpu_torch.eval.classification import accuracy, precision_recall_f1
from arvae_tpu_torch.training.resnet_judge import (MnistResNet, judge_run_dir,
                                                   predict_digits)

SHIFT = 2  # --augment's largest shift, pixels each way


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch_size", type=int, default=256, help="training batch size")
    p.add_argument("--num_epochs", type=int, default=5, help="number of training epochs")
    p.add_argument("--lr", type=float, default=0.5, help="adadelta learning rate")
    add_switch(p, "--augment", "--no_augment", "augment", False,
               "random ±2px translations during training")
    p.add_argument("--device", default="cuda",
                   help="torch device; `cpu` must be asked for explicitly")
    return p.parse_args(argv)


def nll_of_probs(probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean −log(clip(p, 1e-8)) of each row's true class."""
    logp = torch.log(torch.clamp_min(probs, 1e-8))
    return -logp.gather(1, labels[:, None])[:, 0].mean()


def random_shift(images: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Each (1, H, W) image moved by its own offset in [−2, 2]² (pad by 2,
    crop back)."""
    b, _, h, w = images.shape
    dev = images.device
    pad = F.pad(images, (SHIFT,) * 4)
    off = torch.randint(0, 2 * SHIFT + 1, (b, 2), generator=generator, device=dev)
    rows = off[:, :1] + torch.arange(h, device=dev)
    cols = off[:, 1:] + torch.arange(w, device=dev)
    return pad[torch.arange(b, device=dev)[:, None, None], 0,
               rows[:, :, None], cols[:, None, :]][:, None]


def train_step(model: MnistResNet, optimizer: torch.optim.Optimizer,
               images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """One optimizer step in training mode (BatchNorm's running statistics
    move); returns the detached loss."""
    model.train()
    loss = nll_of_probs(model(images), labels)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    return loss.detach()


@torch.no_grad()
def predict_all(model: MnistResNet, images: torch.Tensor, batch_size: int) -> torch.Tensor:
    model.eval()
    return torch.cat([predict_digits(model, images[a:a + batch_size])
                      for a in range(0, len(images), batch_size)])


def main(argv: Optional[Sequence[str]] = None) -> Tuple[MnistResNet, List[Dict[str, float]]]:
    """Runs the CLI; returns the trained judge and each epoch's scores."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to "
                           "train on the CPU")
    # float32 throughout, as the JAX package's judge, and repeatable
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    start = time.time()
    dataset = MnistDataset()
    train_x, train_y = (torch.from_numpy(a).to(device) for a in dataset.arrays("train"))
    test_x, test_y = (torch.from_numpy(a).to(device) for a in dataset.arrays("t10k"))
    model = MnistResNet(seed=0).to(device)
    optimizer = torch.optim.Adadelta(model.parameters(), lr=args.lr, rho=0.9, eps=1e-6)
    generator = torch.Generator(device).manual_seed(0)
    ckpt = Checkpointer(judge_run_dir())
    history = []
    b = args.batch_size
    for epoch in range(args.num_epochs):
        perm = torch.randperm(len(train_x), generator=generator, device=device)
        loss = None
        for a in range(0, len(train_x), b):  # the partial tail batch included
            idx = perm[a:a + b]
            images = train_x[idx]
            if args.augment:
                images = random_shift(images, generator)
            loss = train_step(model, optimizer, images, train_y[idx])
        preds = predict_all(model, test_x, b).cpu().numpy()
        gts = test_y.cpu().numpy()
        scores = dict(loss=float(loss), **precision_recall_f1(gts, preds),
                      accuracy=accuracy(gts, preds))
        history.append(scores)
        print(f"epoch {epoch + 1}/{args.num_epochs}  loss {scores['loss']:.4f}  "
              f"precision {scores['precision']:.4f}  recall {scores['recall']:.4f}  "
              f"f1 {scores['f1']:.4f}  accuracy {scores['accuracy']:.4f}")
        ckpt.save({"model": model.state_dict(), "epoch": epoch + 1})
    print(f"total time: {time.time() - start:.1f}s")
    return model, history


if __name__ == "__main__":
    main()
