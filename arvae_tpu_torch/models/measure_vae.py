"""MeasureVAE: seq-to-seq VAE over one music measure (24 tokens).

Counterpart of ``arvae_tpu/models/measure_vae.py``, with its three
decoders:

- ``Encoder``: Embedding(V, E) → 2-layer biGRU(H) → the final hiddens
  of every layer and direction → two (Linear → SELU → Linear) heads →
  (z_mean, z_log_std);
- ``HierarchicalDecoder`` (``hier``, the reference's default): z →
  beat-GRU init; the beat GRU unrolled 4 steps over a learned input
  ``b_0``; per beat, tick-GRU inits and a beat embedding; then the
  24-tick sampled-feedback loop as one call of
  :func:`arvae_tpu_torch.ops.hier_decoder_kernel.tick_chain` (teacher
  forcing is one coin per batch);
- ``SRDecoder`` (``sr``): z → (Linear → SELU → Linear) → an E-wide
  conditioning beside every step's fed-token embedding; the same tick
  loop with one beat of 24 ticks, zero initial hiddens and the
  conditioning's input projection as the beat's;
- ``SRDecoderNoInput`` (``sr-no-input``): the tiled ``z @ W + b`` is
  the whole input of one stacked GRU pass over the 24 steps, then a
  ReLU head and argmax (or multinomial) samples;
- ``MeasureVAE`` composes the encoder and one decoder, picked by
  ``decoder_type`` (:data:`DECODER_CLASSES`).

Parameter names and shapes of the encoder and the hierarchical decoder
are the reference PyTorch module's (``encoder.lstm.weight_ih_l0_reverse``,
``decoder.rnn_tick.*``, ``decoder.tick_emb_to_note_emb.0.*``, ...). The
reference's names for the SR decoders' parameters are not in this repo
(``arvae_tpu/utils/torch_convert.py`` maps the hierarchical decoder
only), so theirs follow the JAX package's parameter tree
(``decoder.embedding``, ``decoder.z2in1``, ``decoder.z2in2``,
``decoder.x_0``, ``decoder.gru``, ``decoder.out``; ``decoder.z2in``).
``utils/convert.py`` maps the JAX package's parameters onto each one to
one. Every random draw of a forward comes in through
:class:`MeasureNoise`, so a test can hand both packages the same draws;
:func:`draw_measure_noise` makes them on the device from a
``torch.Generator``. On a rank of a data-parallel step the noise's
``rows`` is the rank's share of the global batch: the GRUs' dropout is
drawn for the global batch and the rank's rows taken, and the tick loop
hashes global rows, so each rank draws what one card draws for its
rows. Each decoder runs in the mode its ``train``
argument asks for, the module's own mode by default; eval is
free-running argmax without dropout.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from arvae_tpu_torch.models.image_vae import draw_noise, reparametrize
from arvae_tpu_torch.ops.gru import GRU, rand_rows
from arvae_tpu_torch.ops.hier_decoder_kernel import SAMPLING, tick_chain

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
    # a data-parallel rank's share of the global batch (parallel.RowShare):
    # eps and eps_prior are its rows, the in-forward draws are taken for them
    rows: Any = None


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
                generator: Optional[torch.Generator] = None, rows: Any = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        batch = score.shape[0]
        # an out-of-range id clamps into the table, as the JAX package's
        # take(mode="clip") reads it. One-hot rows times the table: the
        # table's gradient is then one fixed-order product, where
        # nn.Embedding's backward adds rows with atomics on the card and
        # does not repeat bitwise.
        ids = score.long().clamp(0, self.num_notes - 1)
        table = self.note_embedding_layer.weight
        embedded = F.one_hot(ids, self.num_notes).to(table.dtype) @ table
        h0 = torch.zeros(2 * self.lstm.num_layers, batch, self.lstm.hidden_size,
                         device=score.device)
        _, h_n = self.lstm(embedded, h0, generator, rows=rows)
        # (L*D, B, H) -> (B, L*D*H), as hidden.transpose(0, 1).view(B, -1)
        hidden = h_n.transpose(0, 1).reshape(batch, -1)
        return self.linear_mean(hidden), self.linear_log_std(hidden)


def _decode_mode(module: nn.Module, train: Optional[bool], noise: MeasureNoise,
                 sampling: str) -> Tuple[bool, torch.Tensor, str]:
    """(train, teacher coin, sampling) of a decode: the coin and the
    sampling mode apply in training only; eval is free-running argmax."""
    train = module.training if train is None else train
    teacher = noise.teacher if train else torch.zeros_like(noise.teacher)
    return train, teacher, sampling if train else "argmax"


def _row_base(noise: MeasureNoise) -> int:
    """The global batch row of the decode's row 0, for the tick loop's bits."""
    return 0 if noise.rows is None else noise.rows.first


def _check_sampling(sampling: str) -> None:
    if sampling not in SAMPLING:
        raise NotImplementedError(f"sampling={sampling!r}; use {SAMPLING}")


class HierarchicalDecoder(nn.Module):
    """Beat-RNN / tick-RNN hierarchical decoder (reference decoder.py:309-525)."""

    def __init__(self, num_notes: int, note_embedding_dim: int = 10,
                 rnn_hidden_size: int = 512, num_layers: int = 2,
                 dropout: float = 0.5, z_dim: int = 256,
                 sampling: str = "argmax"):
        super().__init__()
        _check_sampling(sampling)
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

    def forward(self, z: torch.Tensor, score: torch.Tensor, noise: MeasureNoise,
                train: Optional[bool] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (weights (B, 24, V) relu logits, samples (B, 24) int32)."""
        B = z.shape[0]
        H, L = self.rnn_tick.hidden_size, self.rnn_tick.num_layers
        E = self.x_0.shape[0]
        train, teacher, sampling = _decode_mode(self, train, noise, self.sampling)

        # beat RNN, 4 steps over the learned input b_0
        h0_beat = self.z_to_beat_rnn_input(z).view(B, L, H).transpose(0, 1)
        beat_in = self.b_0.view(1, 1, 1).expand(B, NUM_BEATS_PER_MEASURE, 1)
        beat_out, _ = self.rnn_beat(beat_in, h0_beat, noise.generator, train,
                                    noise.rows)  # (B, 4, H)

        # per-beat tick inits (4, L, B, H) and the beat-conditioning half
        # of the tick GRU's layer-0 input projection (4, B, 3H), hoisted
        # out of the tick loop as one matmul
        tick_h0 = self.beat_emb_to_tick_rnn_hidden(beat_out)
        tick_h0 = tick_h0.view(B, NUM_BEATS_PER_MEASURE, L, H).permute(1, 2, 0, 3)
        beat_emb_in = self.beat_emb_to_tick_rnn_input(beat_out).transpose(0, 1)
        layers = self.rnn_tick.params()
        w_ih0 = layers[0]["w_ih"]  # (E + H, 3H)
        gi_beat = beat_emb_in @ w_ih0[E:] + layers[0]["b_ih"]
        out = self.tick_emb_to_note_emb[0]

        weights, samples = tick_chain(
            MEASURE_SEQ_LEN, train, self.dropout, NUM_TICKS_PER_BEAT, sampling,
            teacher, noise.seed, score.t(), gi_beat, tick_h0, self.x_0[None].expand(B, E),
            self.note_embedding_layer.weight, w_ih0[:E], layers, out.weight.t(), out.bias,
            _row_base(noise))
        return weights.transpose(0, 1), samples.t()


class SRDecoder(nn.Module):
    """Single-RNN autoregressive decoder (reference decoder.py:53-210): the
    tick loop with ``ticks_per_beat == T``, as the JAX package runs it
    (``arvae_tpu/models/measure_vae.py:194-300``)."""

    def __init__(self, num_notes: int, note_embedding_dim: int = 10,
                 rnn_hidden_size: int = 512, num_layers: int = 2,
                 dropout: float = 0.5, z_dim: int = 256,
                 sampling: str = "argmax"):
        super().__init__()
        _check_sampling(sampling)
        H, L, E, V = rnn_hidden_size, num_layers, note_embedding_dim, num_notes
        self.dropout = dropout
        self.sampling = sampling
        self.embedding = nn.Embedding(V, E)
        self.z2in1 = nn.Linear(z_dim, H)
        self.z2in2 = nn.Linear(H, E)
        self.x_0 = nn.Parameter(torch.zeros(E))
        self.gru = GRU(2 * E, H, L, dropout=dropout)
        self.out = nn.Linear(H, V)

    def forward(self, z: torch.Tensor, score: torch.Tensor, noise: MeasureNoise,
                train: Optional[bool] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (weights (B, T, V) relu logits, samples (B, T) int32)."""
        B, T = score.shape
        H, L = self.gru.hidden_size, self.gru.num_layers
        E = self.x_0.shape[0]
        train, teacher, sampling = _decode_mode(self, train, noise, self.sampling)
        z_emb = self.z2in2(F.selu(self.z2in1(z)))  # (B, E), the same every step
        # the z-conditioning half of layer 0's input projection, hoisted
        # out of the loop: the one "beat" of T ticks
        layers = self.gru.params()
        w_ih0 = layers[0]["w_ih"]  # (2E, 3H)
        gi_z = z_emb @ w_ih0[E:] + layers[0]["b_ih"]
        weights, samples = tick_chain(
            T, train, self.dropout, T, sampling, teacher, noise.seed, score.t(),
            gi_z[None], z.new_zeros(1, L, B, H), self.x_0[None].expand(B, E),
            self.embedding.weight, w_ih0[:E], layers, self.out.weight.t(), self.out.bias,
            _row_base(noise))
        return weights.transpose(0, 1), samples.t()


class SRDecoderNoInput(nn.Module):
    """Non-autoregressive single-RNN decoder (reference decoder.py:213-306):
    one stacked GRU pass over the tiled z projection."""

    def __init__(self, num_notes: int, note_embedding_dim: int = 10,
                 rnn_hidden_size: int = 512, num_layers: int = 2,
                 dropout: float = 0.5, z_dim: int = 256,
                 sampling: str = "argmax"):
        super().__init__()
        _check_sampling(sampling)
        H, L, V = rnn_hidden_size, num_layers, num_notes
        self.sampling = sampling
        self.z2in = nn.Linear(z_dim, H)
        self.gru = GRU(H, H, L, dropout=dropout)
        self.out = nn.Linear(H, V)

    def forward(self, z: torch.Tensor, score: torch.Tensor, noise: MeasureNoise,
                train: Optional[bool] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (weights (B, T, V) relu logits, samples (B, T) int32);
        multinomial samples are Gumbel-max draws from the noise's
        generator."""
        B, T = score.shape
        H, L = self.gru.hidden_size, self.gru.num_layers
        train, _, sampling = _decode_mode(self, train, noise, self.sampling)
        rnn_in = self.z2in(z)[:, None].expand(B, T, H)
        out, _ = self.gru(rnn_in, z.new_zeros(L, B, H), noise.generator, train, noise.rows)
        weights = torch.relu(self.out(out))
        scores = weights.detach()
        if sampling == "multinomial":
            u = rand_rows(scores.shape, noise.generator, scores.device, noise.rows)
            scores = scores - torch.log(-torch.log(u))
        return weights, scores.argmax(-1).to(torch.int32)


DECODER_CLASSES = {
    "hier": HierarchicalDecoder,
    "sr": SRDecoder,
    "sr-no-input": SRDecoderNoInput,
}


class MeasureVAE(nn.Module):
    """Encoder + selectable decoder VAE (reference measure_vae.py:11-166),
    initialised as the JAX package initialises it (Xavier-normal weights
    and embeddings, zero biases and learned inputs), drawn from ``seed``."""

    def __init__(self, num_notes: int, note_embedding_dim: int = 10,
                 num_encoder_layers: int = 2, encoder_hidden_size: int = 512,
                 encoder_dropout_prob: float = 0.5, latent_space_dim: int = 256,
                 num_decoder_layers: int = 2, decoder_hidden_size: int = 512,
                 decoder_dropout_prob: float = 0.5, decoder_type: str = "hier",
                 sampling: str = "argmax", seed: int = 0):
        super().__init__()
        if decoder_type not in DECODER_CLASSES:
            raise ValueError(f"unknown decoder_type {decoder_type!r}; choose from "
                             f"{sorted(DECODER_CLASSES)}")
        self.num_notes = num_notes
        self.latent_space_dim = latent_space_dim
        self.decoder_type = decoder_type
        self.sampling = sampling
        self.encoder = Encoder(num_notes, note_embedding_dim, encoder_hidden_size,
                               num_encoder_layers, encoder_dropout_prob,
                               latent_space_dim)
        self.decoder = DECODER_CLASSES[decoder_type](
            num_notes, note_embedding_dim, decoder_hidden_size, num_decoder_layers,
            decoder_dropout_prob, latent_space_dim, sampling)
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
        for name in ("b_0", "x_0"):
            if hasattr(self.decoder, name):
                nn.init.zeros_(getattr(self.decoder, name))

    def decode(self, z: torch.Tensor, score: torch.Tensor, noise: MeasureNoise,
               train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """The decoder alone, in the mode ``train`` asks for whatever the
        module's mode (the JAX package's ``decode``)."""
        return self.decoder(z, score, noise, train)

    def forward(self, score: torch.Tensor, noise: MeasureNoise) -> MeasureVAEOutput:
        if score.ndim != 2 or score.shape[1] != MEASURE_SEQ_LEN:
            raise ValueError(f"score must be (B, {MEASURE_SEQ_LEN}), got "
                             f"{tuple(score.shape)}")
        z_mean, z_log_std = self.encoder(score, noise.generator, noise.rows)
        z_tilde, z_prior = reparametrize(z_mean, z_log_std, noise.eps, noise.eps_prior)
        weights, samples = self.decoder(z_tilde, score, noise)
        return MeasureVAEOutput(weights, samples, z_mean, z_log_std, z_tilde, z_prior)
