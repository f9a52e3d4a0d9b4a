"""MeasureVAE: seq-to-seq VAE over one music measure (24 tokens).

Counterpart of ``arvae_tpu/models/measure_vae.py`` with the hierarchical
decoder (the reference's default):

- ``Encoder``: Embedding(V, E) → 2-layer biGRU(H) → the final hiddens
  of every layer and direction → two (Linear → SELU → Linear) heads →
  (z_mean, z_log_std);
- ``HierarchicalDecoder``: z → beat-GRU init; the beat GRU unrolled 4
  steps over a learned input ``b_0``; per beat, tick-GRU inits and a
  beat embedding; then the 24-tick sampled-feedback loop as one call of
  :func:`arvae_tpu_torch.ops.hier_decoder_kernel.hier_tick_chain`
  (teacher forcing is one coin per batch);
- ``MeasureVAE`` composes the two.

Parameter names and shapes are the reference PyTorch module's
(``encoder.lstm.weight_ih_l0_reverse``, ``decoder.rnn_tick.*``,
``decoder.tick_emb_to_note_emb.0.*``, ...), so ``utils/convert.py`` maps
the JAX package's parameters onto it one to one. Every random draw of a
forward comes in through :class:`MeasureNoise`, so a test can hand both
packages the same draws; :func:`draw_measure_noise` makes them on the
device from a ``torch.Generator``.

The ``sr`` and ``sr-no-input`` decoders are not ported yet (ROADMAP).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from arvae_tpu_torch.models.image_vae import draw_noise, reparametrize
from arvae_tpu_torch.ops.gru import GRU
from arvae_tpu_torch.ops.hier_decoder_kernel import SAMPLING, hier_tick_chain

NUM_BEATS_PER_MEASURE = 4
NUM_TICKS_PER_BEAT = 6
MEASURE_SEQ_LEN = NUM_BEATS_PER_MEASURE * NUM_TICKS_PER_BEAT  # 24


class MeasureNoise(NamedTuple):
    """The randomness of one forward pass."""

    eps: torch.Tensor  # (B, z_dim) reparametrisation noise
    eps_prior: torch.Tensor  # (B, z_dim) prior sample
    teacher: torch.Tensor  # (1,) int32: 1 = teacher-forced decode (training only)
    seed: torch.Tensor  # (1,) int32: the tick loop's dropout / Gumbel seed
    generator: Optional[torch.Generator] = None  # GRU inter-layer dropout draws


def draw_measure_noise(batch: int, z_dim: int, generator: torch.Generator,
                       device: torch.device,
                       teacher_forcing_prob: float = 0.5) -> MeasureNoise:
    """Every draw on ``device`` from ``generator``: no host sync."""
    eps, eps_prior = draw_noise(batch, z_dim, generator, device)
    teacher = (torch.rand(1, generator=generator, device=device)
               < teacher_forcing_prob).to(torch.int32)
    seed = torch.randint(0, 2**31 - 1, (1,), generator=generator, device=device,
                         dtype=torch.int32)
    return MeasureNoise(eps, eps_prior, teacher, seed, generator)


class MeasureVAEOutput(NamedTuple):
    weights: torch.Tensor  # (B, 24, V) relu logits
    samples: torch.Tensor  # (B, 24) int32 fed tokens
    z_mean: torch.Tensor
    z_log_std: torch.Tensor
    z_tilde: torch.Tensor
    z_prior: torch.Tensor


class Encoder(nn.Module):
    """Bidirectional GRU encoder (reference encoder.py:8-124)."""

    def __init__(self, num_notes: int, note_embedding_dim: int = 10,
                 rnn_hidden_size: int = 512, num_layers: int = 2,
                 dropout: float = 0.5, z_dim: int = 256):
        super().__init__()
        H, L = rnn_hidden_size, num_layers
        self.num_notes = num_notes
        self.note_embedding_layer = nn.Embedding(num_notes, note_embedding_dim)
        self.lstm = GRU(note_embedding_dim, H, L, bidirectional=True, dropout=dropout)
        self.linear_mean = nn.Sequential(nn.Linear(2 * H * L, 2 * H), nn.SELU(),
                                         nn.Linear(2 * H, z_dim))
        self.linear_log_std = nn.Sequential(nn.Linear(2 * H * L, 2 * H), nn.SELU(),
                                            nn.Linear(2 * H, z_dim))

    def forward(self, score: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        batch = score.shape[0]
        # an out-of-range id clamps into the table, as the JAX package's
        # take(mode="clip") reads it
        embedded = self.note_embedding_layer(score.long().clamp(0, self.num_notes - 1))
        h0 = torch.zeros(2 * self.lstm.num_layers, batch, self.lstm.hidden_size,
                         device=score.device)
        _, h_n = self.lstm(embedded, h0, generator)
        # (L*D, B, H) -> (B, L*D*H), as hidden.transpose(0, 1).view(B, -1)
        hidden = h_n.transpose(0, 1).reshape(batch, -1)
        return self.linear_mean(hidden), self.linear_log_std(hidden)


class HierarchicalDecoder(nn.Module):
    """Beat-RNN / tick-RNN hierarchical decoder (reference decoder.py:309-525)."""

    def __init__(self, num_notes: int, note_embedding_dim: int = 10,
                 rnn_hidden_size: int = 512, num_layers: int = 2,
                 dropout: float = 0.5, z_dim: int = 256,
                 sampling: str = "argmax"):
        super().__init__()
        if sampling not in SAMPLING:
            raise NotImplementedError(f"sampling={sampling!r}; use {SAMPLING}")
        if num_layers != 2:
            raise NotImplementedError(
                f"num_layers={num_layers}: the tick-loop kernel runs a 2-layer "
                "tick GRU (the reference default); other depths are not ported")
        H, L, E, V = rnn_hidden_size, num_layers, note_embedding_dim, num_notes
        self.dropout = dropout
        self.sampling = sampling
        self.note_embedding_layer = nn.Embedding(V, E)
        self.z_to_beat_rnn_input = nn.Sequential(nn.Linear(z_dim, H * L), nn.SELU())
        self.b_0 = nn.Parameter(torch.zeros(1))
        self.rnn_beat = GRU(1, H, L, dropout=dropout)
        self.beat_emb_to_tick_rnn_hidden = nn.Sequential(nn.Linear(H, H * L), nn.SELU())
        self.beat_emb_to_tick_rnn_input = nn.Sequential(nn.Linear(H, H), nn.SELU())
        self.x_0 = nn.Parameter(torch.zeros(E))
        self.rnn_tick = GRU(E + H, H, L, dropout=dropout)
        self.tick_emb_to_note_emb = nn.Sequential(nn.Linear(H, V), nn.ReLU())

    def forward(self, z: torch.Tensor, score: torch.Tensor, noise: MeasureNoise
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (weights (B, 24, V) relu logits, samples (B, 24) int32).
        In eval mode: free-running argmax, no dropout."""
        B = z.shape[0]
        H, L = self.rnn_tick.hidden_size, self.rnn_tick.num_layers
        E = self.x_0.shape[0]
        train = self.training
        teacher = noise.teacher if train else torch.zeros_like(noise.teacher)
        sampling = self.sampling if train else "argmax"

        # beat RNN, 4 steps over the learned input b_0
        h0_beat = self.z_to_beat_rnn_input(z).view(B, L, H).transpose(0, 1)
        beat_in = self.b_0.view(1, 1, 1).expand(B, NUM_BEATS_PER_MEASURE, 1)
        beat_out, _ = self.rnn_beat(beat_in, h0_beat, noise.generator)  # (B, 4, H)

        # per-beat tick inits (4, L, B, H) and the beat-conditioning half
        # of the tick GRU's layer-0 input projection (4, B, 3H), hoisted
        # out of the tick loop as one matmul
        tick_h0 = self.beat_emb_to_tick_rnn_hidden(beat_out)
        tick_h0 = tick_h0.view(B, NUM_BEATS_PER_MEASURE, L, H).permute(1, 2, 0, 3)
        beat_emb_in = self.beat_emb_to_tick_rnn_input(beat_out).transpose(0, 1)
        p0, p1 = self.rnn_tick.layer_params(0), self.rnn_tick.layer_params(1)
        w_ih0 = p0["w_ih"]  # (E + H, 3H)
        gi_beat = beat_emb_in @ w_ih0[E:] + p0["b_ih"]
        out = self.tick_emb_to_note_emb[0]

        weights, samples = hier_tick_chain(
            MEASURE_SEQ_LEN, train, self.dropout, NUM_TICKS_PER_BEAT, sampling,
            teacher, noise.seed, score.t(),
            gi_beat, tick_h0, self.x_0[None].expand(B, E),
            self.note_embedding_layer.weight, w_ih0[:E], p0["w_hh"], p0["b_hh"],
            p1["w_ih"], p1["b_ih"], p1["w_hh"], p1["b_hh"], out.weight.t(), out.bias,
        )
        return weights.transpose(0, 1), samples.t()


class MeasureVAE(nn.Module):
    """Encoder + hierarchical decoder VAE (reference measure_vae.py:11-166),
    initialised as the JAX package initialises it (Xavier-normal weights
    and embeddings, zero biases and learned inputs), drawn from ``seed``."""

    def __init__(self, num_notes: int, note_embedding_dim: int = 10,
                 num_encoder_layers: int = 2, encoder_hidden_size: int = 512,
                 encoder_dropout_prob: float = 0.5, latent_space_dim: int = 256,
                 num_decoder_layers: int = 2, decoder_hidden_size: int = 512,
                 decoder_dropout_prob: float = 0.5, decoder_type: str = "hier",
                 sampling: str = "argmax", seed: int = 0):
        super().__init__()
        if decoder_type in ("sr", "sr-no-input"):
            raise NotImplementedError(
                f"decoder_type={decoder_type!r} is not ported yet (ROADMAP Queue "
                "A, the SR decoders); use 'hier'")
        if decoder_type != "hier":
            raise ValueError(f"unknown decoder_type {decoder_type!r}")
        self.num_notes = num_notes
        self.latent_space_dim = latent_space_dim
        self.decoder_type = decoder_type
        self.sampling = sampling
        self.encoder = Encoder(num_notes, note_embedding_dim, encoder_hidden_size,
                               num_encoder_layers, encoder_dropout_prob,
                               latent_space_dim)
        self.decoder = HierarchicalDecoder(num_notes, note_embedding_dim,
                                           decoder_hidden_size, num_decoder_layers,
                                           decoder_dropout_prob, latent_space_dim,
                                           sampling)
        self.init_weights(torch.Generator().manual_seed(seed))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.xavier_normal_(m.weight, generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.Embedding):
                nn.init.xavier_normal_(m.weight, generator=generator)
            elif isinstance(m, GRU):
                m.init_weights(generator)
        nn.init.zeros_(self.decoder.b_0)
        nn.init.zeros_(self.decoder.x_0)

    def forward(self, score: torch.Tensor, noise: MeasureNoise) -> MeasureVAEOutput:
        if score.ndim != 2 or score.shape[1] != MEASURE_SEQ_LEN:
            raise ValueError(f"score must be (B, {MEASURE_SEQ_LEN}), got "
                             f"{tuple(score.shape)}")
        z_mean, z_log_std = self.encoder(score, noise.generator)
        z_tilde, z_prior = reparametrize(z_mean, z_log_std, noise.eps, noise.eps_prior)
        weights, samples = self.decoder(z_tilde, score, noise)
        return MeasureVAEOutput(weights, samples, z_mean, z_log_std, z_tilde, z_prior)
