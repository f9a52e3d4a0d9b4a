"""GRU primitives over explicit parameters, and the torch-named GRU module.

Counterpart of ``arvae_tpu/ops/gru.py``. Parameters per layer and
direction are ``w_ih (I, 3H)``, ``w_hh (H, 3H)``, ``b_ih (3H,)``,
``b_hh (3H,)`` in gate order (r, z, n), with torch's gate math::

    r = sigmoid(x W_ir + b_ir + h W_hr + b_hr)
    z = sigmoid(x W_iz + b_iz + h W_hz + b_hz)
    n = tanh(x W_in + b_in + r * (h W_hn + b_hn))
    h' = (1 - z) * n + z * h

The input projection of a whole sequence has no sequential dependence,
so it is one matmul outside the recurrence; the recurrence itself always
goes through :func:`arvae_tpu_torch.ops.gru_kernel.gru_chain` (the CUDA
kernel on the card, the plain loop on the CPU).

:class:`GRU` holds its parameters under ``torch.nn.GRU``'s names and
shapes (``weight_ih_l0_reverse`` (3H, I), ...), so a reference PyTorch
checkpoint loads as it is, but computes through these functions.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from arvae_tpu_torch.ops.gru_kernel import gru_chain, gru_gates

GRUParams = Dict[str, torch.Tensor]


def rand_rows(shape: Sequence[int], generator: Optional[torch.Generator],
              device: torch.device, rows: Any = None) -> torch.Tensor:
    """U(0, 1) draws of ``shape`` (batch first) from ``generator``. With
    ``rows``, a data-parallel rank's share of the global batch
    (:class:`arvae_tpu_torch.parallel.RowShare`), they are drawn for the
    whole global batch and this rank's rows taken: every rank advances the
    generator as one card does and holds that card's draws for its rows."""
    if rows is None:
        return torch.rand(tuple(shape), generator=generator, device=device)
    return rows.take(torch.rand((rows.total, *shape[1:]), generator=generator, device=device))


def gru_cell_from_gi(params: GRUParams, gi: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """GRU step given the precomputed input projection
    ``gi = x @ w_ih + b_ih``. gi: (B, 3H), h: (B, H) → h' (B, H)."""
    r, z, n = gru_gates(gi, h @ params["w_hh"] + params["b_hh"])
    return (1.0 - z) * n + z * h


def stacked_gru_step_from_gi(
    params_layers: Sequence[GRUParams],
    gi0: torch.Tensor,
    h: torch.Tensor,
    dropout_masks: Optional[Sequence[torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One time step through stacked layers, layer 0's input projection
    ``gi0`` given. h: (L, B, H) → (top (B, H), new h (L, B, H)).

    ``dropout_masks``, one keep-and-scale mask per gap between layers,
    multiplies each layer's output before the next layer reads it (the
    torch convention: not after the last layer)."""
    new_h = []
    inp: Optional[torch.Tensor] = None
    for i, p in enumerate(params_layers):
        gi = gi0 if i == 0 else inp @ p["w_ih"] + p["b_ih"]
        h_l = gru_cell_from_gi(p, gi, h[i])
        new_h.append(h_l)
        inp = h_l
        if dropout_masks is not None and i < len(params_layers) - 1:
            inp = inp * dropout_masks[i]
    return inp, torch.stack(new_h, 0)


def gru_layer(params: GRUParams, xs: torch.Tensor, h0: torch.Tensor,
              reverse: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """One direction over time. xs: (B, T, I), h0: (B, H) →
    (outputs (B, T, H), h_final (B, H)); one chain call with D = 1."""
    gi = (xs @ params["w_ih"] + params["b_ih"]).transpose(0, 1)  # (T, B, 3H)
    if reverse:
        gi = gi.flip(0)
    outs = gru_chain(gi[:, None], params["w_hh"][None], params["b_hh"][None],
                     h0[None])[:, 0]  # (T, B, H)
    h_final = outs[-1]
    if reverse:
        outs = outs.flip(0)
    return outs.transpose(0, 1), h_final


def bigru_layer(fwd_p: GRUParams, bwd_p: GRUParams, xs: torch.Tensor,
                h0_f: torch.Tensor, h0_b: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Both directions of one bidirectional layer in one chain call: the
    backward direction's input projections are time-flipped here and
    stacked with the forward's on a direction axis (D = 2).
    xs: (B, T, I) → (outputs (B, T, 2H), h_final_f (B, H), h_final_b)."""
    w_hh = torch.stack([fwd_p["w_hh"], bwd_p["w_hh"]])  # (2, H, 3H)
    b_hh = torch.stack([fwd_p["b_hh"], bwd_p["b_hh"]])  # (2, 3H)
    gi_f = (xs @ fwd_p["w_ih"] + fwd_p["b_ih"]).transpose(0, 1)  # (T, B, 3H)
    gi_b = (xs @ bwd_p["w_ih"] + bwd_p["b_ih"]).transpose(0, 1).flip(0)
    gi = torch.stack([gi_f, gi_b], dim=1)  # (T, 2, B, 3H)
    outs = gru_chain(gi, w_hh, b_hh, torch.stack([h0_f, h0_b]))  # (T, 2, B, H)
    out_f = outs[:, 0].transpose(0, 1)
    out_b = outs[:, 1].flip(0).transpose(0, 1)
    return torch.cat([out_f, out_b], dim=-1), outs[-1, 0], outs[-1, 1]


def gru_forward(
    params_layers: Sequence[Union[GRUParams, Sequence[GRUParams]]],
    xs: torch.Tensor,
    h0: torch.Tensor,
    bidirectional: bool = False,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    train: bool = False,
    rows: Any = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stacked (bi)GRU matching ``torch.nn.GRU(batch_first=True)``.

    xs: (B, T, I); h0: (L*D, B, H). Returns (outputs (B, T, H*D), h_n
    (L*D, B, H)) with h_n in torch's layout [l0_fwd, l0_bwd, l1_fwd, ...].
    In training with a rate > 0, dropout between layers (not after the
    last), its keep mask drawn on the device from ``generator``
    (:func:`rand_rows`, for a data-parallel rank's ``rows``)."""
    n_layers = len(params_layers)
    finals: List[torch.Tensor] = []
    out = xs
    for i, layer in enumerate(params_layers):
        if bidirectional:
            out, hf, hb = bigru_layer(layer[0], layer[1], out, h0[2 * i], h0[2 * i + 1])
            finals.extend([hf, hb])
        else:
            out, hf = gru_layer(layer, out, h0[i])
            finals.append(hf)
        if train and dropout_rate > 0.0 and i < n_layers - 1:
            keep = 1.0 - dropout_rate
            u = rand_rows(out.shape, generator, out.device, rows)
            out = out * ((u < keep).float() * (1.0 / keep))
    return out, torch.stack(finals, 0)


class GRU(nn.Module):
    """Stacked (bi)GRU with ``torch.nn.GRU``'s parameter names and shapes
    (``weight_ih_l{k}{_reverse}`` (3H, I_k), ``weight_hh_*`` (3H, H),
    ``bias_ih_*``, ``bias_hh_*`` (3H,)), batch-first, computing through
    :func:`gru_forward`. Weights are initialised Xavier-normal and biases
    zero, the JAX package's init."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 bidirectional: bool = False, dropout: float = 0.0):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.bidirectional = bidirectional
        self.dropout = dropout
        dirs = 2 if bidirectional else 1
        for layer in range(num_layers):
            in_sz = input_size if layer == 0 else hidden_size * dirs
            for d in range(dirs):
                sfx = self._suffix(layer, d)
                self.register_parameter(f"weight_ih{sfx}",
                                        nn.Parameter(torch.empty(3 * hidden_size, in_sz)))
                self.register_parameter(f"weight_hh{sfx}",
                                        nn.Parameter(torch.empty(3 * hidden_size, hidden_size)))
                self.register_parameter(f"bias_ih{sfx}",
                                        nn.Parameter(torch.zeros(3 * hidden_size)))
                self.register_parameter(f"bias_hh{sfx}",
                                        nn.Parameter(torch.zeros(3 * hidden_size)))
        # never uninitialised memory: a model re-initialises from its own seed
        self.init_weights(torch.Generator().manual_seed(0))

    @staticmethod
    def _suffix(layer: int, direction: int) -> str:
        return f"_l{layer}" + ("_reverse" if direction == 1 else "")

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        for name, p in self.named_parameters():
            if name.startswith("weight"):
                nn.init.xavier_normal_(p, generator=generator)
            else:
                nn.init.zeros_(p)

    def layer_params(self, layer: int, direction: int = 0) -> GRUParams:
        """One layer and direction in the (I, 3H) layout of the functions."""
        sfx = self._suffix(layer, direction)
        return {
            "w_ih": getattr(self, f"weight_ih{sfx}").t(),
            "w_hh": getattr(self, f"weight_hh{sfx}").t(),
            "b_ih": getattr(self, f"bias_ih{sfx}"),
            "b_hh": getattr(self, f"bias_hh{sfx}"),
        }

    def params(self) -> List[Union[GRUParams, List[GRUParams]]]:
        if self.bidirectional:
            return [[self.layer_params(i, 0), self.layer_params(i, 1)]
                    for i in range(self.num_layers)]
        return [self.layer_params(i) for i in range(self.num_layers)]

    def forward(self, xs: torch.Tensor, h0: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                train: Optional[bool] = None, rows: Any = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """xs (B, T, I), h0 (L*D, B, H) → (outputs (B, T, D*H), h_n).
        ``train`` (dropout between layers) defaults to the module's mode;
        ``rows`` as :func:`gru_forward` takes it."""
        return gru_forward(self.params(), xs, h0, self.bidirectional, self.dropout,
                           generator, self.training if train is None else train, rows)
