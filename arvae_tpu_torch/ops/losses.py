"""Loss library — the AR-VAE objective in PyTorch.

Counterpart of ``arvae_tpu/ops/losses.py``, function for function:

    L = recon(x, x_hat)
      + beta * | sum_dims KL(q(z|x) || N(0, I)) - c |
      + gamma * sum_{r in reg_dims} L1( tanh(delta * D_z_r), sign(D_a_r) )

where ``D_z_r[i, j] = z_i[r] - z_j[r]`` and ``D_a_r[i, j] = a_i[r] - a_j[r]``
are B×B pairwise difference matrices. The AR term goes through
:func:`arvae_tpu_torch.ops.reg_kernel.reg_losses`, which reads the
latent and attribute columns in place: the CUDA kernels for CUDA
tensors, their plain PyTorch versions for CPU tensors.
Distributions are carried as ``(mean, log_std)`` pairs.

On a rank of a data-parallel step (``share``, the rank's
:class:`~arvae_tpu_torch.parallel.RowShare` of the global batch) each
loss is the global batch's: a batch mean is ``share.mean`` of this
rank's (its weight the rank's rows over the global count, as per-rank
row counts may differ), ``kld_loss`` takes ``|·−c|`` of the global mean
(it is not linear in the mean for c > 0), and the AR term runs on the
gathered (B, Z) latents and labels, so its pairs are the global batch's.
"""

from __future__ import annotations

from typing import Any, Sequence, Tuple

import torch
import torch.nn.functional as F

from arvae_tpu_torch.ops.reg_kernel import reg_losses

# ---------------------------------------------------------------------------
# Reconstruction losses
# ---------------------------------------------------------------------------


def bce_logits_recon_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Bernoulli decoder loss: summed BCE-with-logits divided by batch size,
    in the stable form ``max(x,0) - x*t + log1p(exp(-|x|))``."""
    batch = logits.shape[0]
    x = logits.float()
    t = targets.float()
    per_elem = torch.clamp_min(x, 0.0) - x * t + torch.log1p(torch.exp(-torch.abs(x)))
    return torch.sum(per_elem) / batch


def gaussian_recon_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Gaussian decoder loss: sigmoid then summed MSE divided by batch size."""
    batch = logits.shape[0]
    x = torch.sigmoid(logits.float())
    t = targets.float()
    return torch.sum(torch.square(x - t)) / batch


def reconstruction_loss(
    logits: torch.Tensor, targets: torch.Tensor, dec_dist: str = "bernoulli"
) -> torch.Tensor:
    if dec_dist == "bernoulli":
        return bce_logits_recon_loss(logits, targets)
    if dec_dist == "gaussian":
        return gaussian_recon_loss(logits, targets)
    raise AttributeError(f"invalid dist: {dec_dist}")


def token_cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean token-level cross entropy over all positions.

    Target ids index like the JAX package's
    ``take_along_axis(..., mode="clip")``: a negative id counts from the
    end, then ids clamp into [0, V-1], instead of raising."""
    v = logits.shape[-1]
    logits = logits.reshape(-1, v).float()
    targets = targets.reshape(-1).long()
    targets = torch.where(targets < 0, targets + v, targets).clamp(0, v - 1)
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, 1, targets[:, None])[:, 0]
    return torch.mean(nll)


def token_accuracy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Fraction of argmax-correct tokens (lowest index wins a tie)."""
    v = logits.shape[-1]
    pred = torch.argmax(logits.reshape(-1, v), dim=-1)
    return torch.mean((pred == targets.reshape(-1)).float())


def _check_rnn_pair(weights: torch.Tensor, targets: torch.Tensor) -> None:
    if weights.ndim != 3 or weights.shape != targets.shape:
        raise ValueError(
            f"expected matching (B, T, H) arrays, got {tuple(weights.shape)} "
            f"vs {tuple(targets.shape)}"
        )


def mean_l1_loss_rnn(weights: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean elementwise L1 over (B, T, H) sequences."""
    _check_rnn_pair(weights, targets)
    return torch.mean(torch.abs(weights.float() - targets.float()))


def mean_mse_loss_rnn(weights: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean elementwise MSE over (B, T, H) sequences."""
    _check_rnn_pair(weights, targets)
    return torch.mean(torch.square(weights.float() - targets.float()))


def _check_alt_pair(logits: torch.Tensor, targets: torch.Tensor) -> None:
    if logits.ndim != 4 or targets.ndim != 3 or logits.shape[:3] != targets.shape:
        raise ValueError(
            f"expected (B, M, T, V) logits with (B, M, T) targets, "
            f"got {tuple(logits.shape)} vs {tuple(targets.shape)}"
        )


def token_cross_entropy_loss_alt(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """4-D variant: mean CE over (B, M, T, V) logits vs (B, M, T) targets."""
    _check_alt_pair(logits, targets)
    return token_cross_entropy_loss(logits, targets)


def token_accuracy_alt(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """4-D variant: argmax accuracy over (B, M, T, V) logits."""
    _check_alt_pair(logits, targets)
    return token_accuracy(logits, targets)


def pixel_accuracy(probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Binary pixel accuracy at a 0.5 threshold on probabilities."""
    return torch.mean(((probs >= 0.5) == (targets >= 0.5)).float())


# ---------------------------------------------------------------------------
# KL divergence with capacity
# ---------------------------------------------------------------------------


def kld_loss(
    z_mean: torch.Tensor,
    z_log_std: torch.Tensor,
    beta: torch.Tensor | float,
    c: torch.Tensor | float = 0.0,
    share: Any = None,
) -> torch.Tensor:
    """beta * | mean_B( sum_D KL(N(mu, sigma) || N(0, 1)) ) - c |, the
    mean over the global batch when given a rank's ``share``."""
    mu = z_mean.float()
    log_s = z_log_std.float()
    kl = -log_s + 0.5 * (torch.exp(2.0 * log_s) + torch.square(mu)) - 0.5
    kld = torch.mean(torch.sum(kl, dim=-1))
    if share is not None:
        kld = share.mean(kld)
    return beta * torch.abs(kld - c)


# ---------------------------------------------------------------------------
# Attribute regularization (the AR in AR-VAE)
# ---------------------------------------------------------------------------


def attribute_reg_loss(
    z_r: torch.Tensor, attr: torch.Tensor, delta: torch.Tensor | float = 1.0
) -> torch.Tensor:
    """L1( tanh(delta * D_z), sign(D_a) ) over all B² ordered pairs of one
    (B,) latent column and its (B,) attribute; diagonal pairs count 0."""
    z_r = z_r.float()
    attr = attr.float()
    dz = z_r[:, None] - z_r[None, :]
    da = attr[:, None] - attr[None, :]
    return torch.mean(torch.abs(torch.tanh(delta * dz) - torch.sign(da)))


def total_reg_loss(
    z: torch.Tensor,
    labels: torch.Tensor,
    reg_dims: Sequence[Tuple[int, int]],
    gamma: torch.Tensor | float,
    delta: torch.Tensor | float,
    share: Any = None,
) -> torch.Tensor:
    """Sum of gamma-weighted AR losses over ``(latent_dim, attr_col)``
    pairs, through the kernel on the columns of ``z`` and ``labels`` read
    in place (no stack; float32 labels are not cast). Given a rank's
    ``share``, on the global batch's rows of both: the gathered latents
    (their gradient reaches this rank's rows) and labels."""
    if len(reg_dims) == 0:
        return torch.zeros((), dtype=torch.float32, device=z.device)
    if share is not None:
        z, labels = share.gather(z), share.gather_constant(labels)
    return gamma * torch.sum(reg_losses(z, labels, reg_dims, delta))
