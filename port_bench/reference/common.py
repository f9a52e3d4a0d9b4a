"""Pieces both references share: precision, Adam, the GRU cell, the losses."""

from __future__ import annotations

import contextlib
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.nn.functional as F

# The port's trainers seed their epoch permutation generator with
# ``rand + 2**30`` and their noise generator with ``rand`` (the run's
# seed is the trainer's ``rand``): the reference draws the same rows and
# the same noise from generators seeded alike.
PERM_SEED_OFFSET = 1 << 30

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


class Steps(NamedTuple):
    """What the reference's (or the program's) first steps give."""

    losses: List[float]  # the loss of each step
    grad1: Dict[str, torch.Tensor]  # every leaf's gradient at step 1
    params: Dict[str, torch.Tensor]  # every leaf after the last step
    # the tokens each step fed back (a decoder that samples), the widest
    # gap by which a fed token's logit lay below the best one, and each
    # step's output head
    fed: Optional[List[torch.Tensor]] = None
    token_gap: float = 0.0
    logits: Optional[List[torch.Tensor]] = None


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 with TF32 off (the configurations' precision), or with
    TF32 on for matmuls and cuDNN (the control)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Adam:
    """``torch.optim.Adam``'s update with its defaults, written out."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float):
        self.params, self.lr, self.t = params, lr, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        b1, b2 = ADAM_BETAS
        self.t += 1
        c1, c2 = 1.0 - b1 ** self.t, 1.0 - b2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1.0 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = self.v[k].sqrt() / (c2 ** 0.5) + ADAM_EPS
            p.addcdiv_(self.m[k], denom, value=-self.lr / c1)


def gru_cell(gi: torch.Tensor, h: torch.Tensor, w_hh: torch.Tensor,
             b_hh: torch.Tensor) -> torch.Tensor:
    """torch.nn.GRU's cell, gates (r, z, n), given the input projection
    ``gi`` (B, 3H) and the (3H, H) recurrent weight."""
    hr, hz, hn = (h @ w_hh.t() + b_hh).chunk(3, dim=1)
    ir, iz, inn = gi.chunk(3, dim=1)
    r = torch.sigmoid(ir + hr)
    z = torch.sigmoid(iz + hz)
    n = torch.tanh(inn + r * hn)
    return (1.0 - z) * n + z * h


def kld(z_mean: torch.Tensor, z_log_std: torch.Tensor, beta: float,
        capacity: float) -> torch.Tensor:
    """β·|mean over rows of Σ_dims KL(N(μ, σ) ‖ N(0, 1)) − c|."""
    kl = -z_log_std + 0.5 * (torch.exp(2.0 * z_log_std) + z_mean ** 2) - 0.5
    return beta * torch.abs(kl.sum(dim=1).mean() - capacity)


def ar_term(z: torch.Tensor, labels: torch.Tensor, dims, gamma: float,
            delta: float) -> torch.Tensor:
    """γ·Σ_r mean over all B² ordered pairs of
    |tanh(δ·(z_i − z_j)) − sign(a_i − a_j)|, latent column r against
    label column r."""
    total = z.new_zeros(())
    for r in dims:
        dz = z[:, r, None] - z[None, :, r]
        da = labels[:, r, None] - labels[None, :, r]
        total = total + torch.mean(torch.abs(torch.tanh(delta * dz) - torch.sign(da)))
    return gamma * total


def bernoulli_recon(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Σ BCE-with-logits over every pixel, over the batch size."""
    return F.binary_cross_entropy_with_logits(logits, targets, reduction="sum") / logits.shape[0]


def leaves(weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Fresh float32 leaves that require a gradient, one per weight."""
    return {k: v.detach().clone().float().requires_grad_(True) for k, v in weights.items()}


def train(loss_fn, weights: Dict[str, torch.Tensor], lr: float, steps: int) -> Steps:
    """``steps`` Adam steps of ``loss_fn(params, step) -> (loss, {"fed":
    tokens fed back, "token_gap": their gap, "logits": the output head})``
    (the dict empty for a model that feeds nothing back) from
    ``weights``."""
    params = leaves(weights)
    adam = Adam(params, lr)
    losses, grad1, fed, logits, gap = [], {}, [], [], 0.0
    for i in range(steps):
        loss, extra = loss_fn(params, i)
        if extra:
            fed.append(extra["fed"])
            logits.append(extra["logits"])
            gap = max(gap, extra["token_gap"])
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {k: (g if g is not None else torch.zeros_like(params[k]))
                 for k, g in zip(params, grads)}
        if i == 0:
            grad1 = {k: g.detach().clone() for k, g in grads.items()}
        losses.append(float(loss.detach()))
        adam.step(grads)
    return Steps(losses, grad1, {k: v.detach().clone() for k, v in params.items()},
                 fed or None, gap, logits or None)
