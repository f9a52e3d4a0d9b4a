"""Plain PyTorch reference of the MeasureVAE's AR-VAE training step.

The model is the reference implementation's (ashispati/ar-vae,
``measurevae/measure_vae.py``, ``encoder.py``, ``decoder.py``
``HierarchicalDecoder``), written out here as loops over time:

- encoder: token embedding → a bidirectional GRU of ``num_encoder_layers``
  layers (dropout between layers) → the last hidden of every layer and
  direction, concatenated → two (Linear → SELU → Linear) heads;
- ``z̃ = μ + exp(log σ)·ε``;
- decoder: ``Linear → SELU`` of z̃ into the beat GRU's initial hiddens;
  the beat GRU over 4 beats of the learned scalar input ``b_0``; per
  beat, the tick GRU's initial hiddens and a beat embedding; then 24
  ticks (6 a beat, hiddens reset at each beat) of the tick GRU on
  [embedding of the fed token ‖ beat embedding], a ReLU head, and the
  fed token: the score's (teacher forcing, one coin a step) or the
  argmax of the head (lowest index on ties);
- loss: token cross-entropy of the ReLU head over the score, plus
  β·|KLD − c|, plus γ·Σ_r of the AR term of latent dim r against
  attribute r (rhythmic complexity, pitch range, note density,
  contour), computed from the score under the configuration's stated
  vocabulary (ids 0-3 special, id k ≥ 4 the pitch MIDI 32 + k).

The random draws are the port's, replayed from generators seeded as
the trainer seeds its own (the run's seed is the trainer's ``rand``), in
the order the port's step makes them: ε, ε_prior (each B × z standard
normal), the teacher coin (one uniform < 0.5), the tick loop's int32
seed, then the uniforms of the encoder's and the beat GRU's dropout
masks (``u < 1 − p`` keeps, scaled by 1/(1 − p)). The tick GRU's
dropout masks come from the counter hash below, a frozen copy of the
one the port documents for its tick loop (``hier_decoder_kernel``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from port_bench.reference.common import (PERM_SEED_OFFSET, Steps, ar_term, gru_cell, kld,
                                         precision, train)

BEATS, TICKS_PER_BEAT = 4, 6
SEQ_LEN = BEATS * TICKS_PER_BEAT
SPECIAL_IDS = 4  # "__", START, END, rest
MIDI_OF_ID = 32  # id k >= 4 is MIDI k + 32 (MIDI 36 upward)
# Toussaint's metrical weights of the 24 ticks (the reference's
# bar_dataset_helpers.py)
RHY_COEFFS = (0.20, 1, 2, 0.5, 2, 1, 0.67, 1, 2, 0.5, 2, 1,
              0.25, 1, 2, 0.5, 2, 1, 0.67, 1, 2, 0.5, 2, 1)


def _gru_names(prefix: str, layers: int, dirs: int, in0: int, H: int):
    out = []
    for k in range(layers):
        in_k = in0 if k == 0 else H * dirs
        for d in range(dirs):
            sfx = f"_l{k}" + ("_reverse" if d else "")
            out += [(f"{prefix}.weight_ih{sfx}", (3 * H, in_k)),
                    (f"{prefix}.weight_hh{sfx}", (3 * H, H)),
                    (f"{prefix}.bias_ih{sfx}", (3 * H,)),
                    (f"{prefix}.bias_hh{sfx}", (3 * H,))]
    return out


def param_spec(cfg: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every learned leaf, under the reference module's names."""
    m = cfg["model"]
    V, E, Z = m["num_notes"], m["note_embedding_dim"], m["latent_space_dim"]
    He, Le = m["encoder_hidden_size"], m["num_encoder_layers"]
    Hd, Ld = m["decoder_hidden_size"], m["num_decoder_layers"]
    spec = [("encoder.note_embedding_layer.weight", (V, E))]
    spec += _gru_names("encoder.lstm", Le, 2, E, He)
    for head in ("linear_mean", "linear_log_std"):
        spec += [(f"encoder.{head}.0.weight", (2 * He, 2 * He * Le)),
                 (f"encoder.{head}.0.bias", (2 * He,)),
                 (f"encoder.{head}.2.weight", (Z, 2 * He)),
                 (f"encoder.{head}.2.bias", (Z,))]
    spec += [("decoder.note_embedding_layer.weight", (V, E)),
             ("decoder.z_to_beat_rnn_input.0.weight", (Hd * Ld, Z)),
             ("decoder.z_to_beat_rnn_input.0.bias", (Hd * Ld,)),
             ("decoder.b_0", (1,))]
    spec += _gru_names("decoder.rnn_beat", Ld, 1, 1, Hd)
    spec += [("decoder.beat_emb_to_tick_rnn_hidden.0.weight", (Hd * Ld, Hd)),
             ("decoder.beat_emb_to_tick_rnn_hidden.0.bias", (Hd * Ld,)),
             ("decoder.beat_emb_to_tick_rnn_input.0.weight", (Hd, Hd)),
             ("decoder.beat_emb_to_tick_rnn_input.0.bias", (Hd,)),
             ("decoder.x_0", (E,))]
    spec += _gru_names("decoder.rnn_tick", Ld, 1, E + Hd, Hd)
    spec += [("decoder.tick_emb_to_note_emb.0.weight", (V, Hd)),
             ("decoder.tick_emb_to_note_emb.0.bias", (V,))]
    return spec


# -- the tick loop's counter hash (frozen copy) ---------------------------------

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + ((hi * (c & 0xFFFF)) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def hash_uniform(seed: torch.Tensor, t: int, salt: int, rows: int, cols: int) -> torch.Tensor:
    """(rows, cols) uniforms in (0, 1) of tick t: the top 24 bits of the
    hash of (seed, t, salt, row, col)."""
    dev = seed.device
    h = seed.reshape(1).long() & _M32
    h = _mix32(_mix32(_mix32(h) ^ t) ^ salt)
    r = torch.arange(rows, device=dev, dtype=torch.int64)[:, None]
    c = torch.arange(cols, device=dev, dtype=torch.int64)[None, :]
    h = _mix32(_mix32(h[:, None] ^ r) ^ c)
    u = (h >> 8).to(torch.float32) * (1.0 / 16777216.0)
    return u * (1.0 - 2.0 / 16777216.0) + 1.0 / 16777216.0


def keep_mask(u: torch.Tensor, rate: float) -> torch.Tensor:
    keep = 1.0 - rate
    return (u < keep).float() * (1.0 / keep)


# -- the model --------------------------------------------------------------------


def _gru_dir(p, prefix: str, sfx: str, xs: torch.Tensor, h: torch.Tensor,
             reverse: bool = False):
    """One direction of one layer over time: xs (B, T, I) → (outputs (B,
    T, H), last hidden)."""
    gi = xs @ p[f"{prefix}.weight_ih{sfx}"].t() + p[f"{prefix}.bias_ih{sfx}"]
    w_hh, b_hh = p[f"{prefix}.weight_hh{sfx}"], p[f"{prefix}.bias_hh{sfx}"]
    order = range(xs.shape[1] - 1, -1, -1) if reverse else range(xs.shape[1])
    outs = [None] * xs.shape[1]
    for t in order:
        h = gru_cell(gi[:, t], h, w_hh, b_hh)
        outs[t] = h
    return torch.stack(outs, dim=1), h


def _gru_stack(p, prefix: str, layers: int, dirs: int, xs: torch.Tensor,
               h0: List[torch.Tensor], drop: float, gen: torch.Generator):
    """Stacked (bi)GRU with dropout between layers, its uniforms drawn
    from ``gen``; h0 in torch's [l0_fwd, l0_bwd, l1_fwd, ...] order."""
    out, finals = xs, []
    for k in range(layers):
        parts = []
        for d in range(dirs):
            sfx = f"_l{k}" + ("_reverse" if d else "")
            o, h = _gru_dir(p, prefix, sfx, out, h0[k * dirs + d], reverse=bool(d))
            parts.append(o)
            finals.append(h)
        out = torch.cat(parts, dim=-1)
        if drop > 0.0 and k < layers - 1:
            u = torch.rand(tuple(out.shape), generator=gen, device=out.device)
            out = out * keep_mask(u, drop)
    return out, finals


def labels_of(score: torch.Tensor) -> torch.Tensor:
    """(B, 4): rhythmic complexity, pitch range, note density, contour."""
    is_note = score >= SPECIAL_IDS
    midi = (score + MIDI_OF_ID).long()
    onsets = is_note.float()
    coeffs = torch.tensor(RHY_COEFFS, dtype=torch.float32, device=score.device)
    rhy = onsets @ coeffs / coeffs.sum()
    count = is_note.sum(dim=1)
    enough = count >= 2
    hi = torch.where(is_note, midi, -(10 ** 6)).amax(dim=1)
    lo = torch.where(is_note, midi, 10 ** 6).amin(dim=1)
    rng = torch.where(enough, (hi - lo).float(), 0.0) / 26.0
    density = onsets.mean(dim=1)
    n = score.shape[1]
    pos = torch.arange(n, device=score.device)
    first = torch.where(is_note, pos, n).amin(dim=1).clamp(max=n - 1)
    last = torch.where(is_note, pos, -1).amax(dim=1).clamp(min=0)
    diff = (midi.gather(1, last[:, None]) - midi.gather(1, first[:, None]))[:, 0].float()
    contour = torch.where(enough, diff, 0.0) / 26.0
    return torch.stack([rhy, rng, density, contour], dim=1)


def forward_loss(p: Dict[str, torch.Tensor], cfg: dict, score: torch.Tensor,
                 gen: torch.Generator, fed: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, dict]:
    """(the training loss, {"fed": the (B, 24) tokens fed back,
    "token_gap": their gap, "logits": the (B, 24, V) ReLU head}) of one
    batch (B, 24) of token ids, drawing the step's noise from ``gen``.
    Given ``fed``, the tokens a program fed back in this step, the tick
    loop feeds those and judges them: a teacher-forced step must have
    fed the score's tokens (else the gap is infinite), a free-running
    one the argmax of the head, up to the gap by which a fed token's
    logit lies below the row's best (the widest over the step)."""
    m, o = cfg["model"], cfg["objective"]
    V, E, Z = m["num_notes"], m["note_embedding_dim"], m["latent_space_dim"]
    He, Le = m["encoder_hidden_size"], m["num_encoder_layers"]
    Hd, Ld = m["decoder_hidden_size"], m["num_decoder_layers"]
    B, dev = score.shape[0], score.device
    eps = torch.randn(B, Z, generator=gen, device=dev)
    torch.randn(B, Z, generator=gen, device=dev)  # ε_prior: drawn, unused by the loss
    teacher = torch.rand(1, generator=gen, device=dev) < 0.5
    tseed = torch.randint(0, 2 ** 31 - 1, (1,), generator=gen, device=dev, dtype=torch.int32)

    ids = score.long().clamp(0, V - 1)
    x = p["encoder.note_embedding_layer.weight"][ids]
    zeros = [x.new_zeros(B, He)] * (2 * Le)
    _, finals = _gru_stack(p, "encoder.lstm", Le, 2, x, zeros, m["encoder_dropout_prob"], gen)
    hidden = torch.cat(finals, dim=1)

    def head(name):
        h = F.selu(hidden @ p[f"encoder.{name}.0.weight"].t() + p[f"encoder.{name}.0.bias"])
        return h @ p[f"encoder.{name}.2.weight"].t() + p[f"encoder.{name}.2.bias"]

    z_mean, z_log_std = head("linear_mean"), head("linear_log_std")
    z = z_mean + torch.exp(z_log_std) * eps

    h0 = F.selu(z @ p["decoder.z_to_beat_rnn_input.0.weight"].t()
                + p["decoder.z_to_beat_rnn_input.0.bias"]).view(B, Ld, Hd)
    beat_in = p["decoder.b_0"].view(1, 1, 1).expand(B, BEATS, 1)
    beat_out, _ = _gru_stack(p, "decoder.rnn_beat", Ld, 1, beat_in,
                             [h0[:, k] for k in range(Ld)], m["decoder_dropout_prob"], gen)
    tick_h0 = F.selu(beat_out @ p["decoder.beat_emb_to_tick_rnn_hidden.0.weight"].t()
                     + p["decoder.beat_emb_to_tick_rnn_hidden.0.bias"]).view(B, BEATS, Ld, Hd)
    beat_emb = F.selu(beat_out @ p["decoder.beat_emb_to_tick_rnn_input.0.weight"].t()
                      + p["decoder.beat_emb_to_tick_rnn_input.0.bias"])  # (B, 4, H)

    w_ih0 = p["decoder.rnn_tick.weight_ih_l0"]
    gi_beat = beat_emb @ w_ih0[:, E:].t() + p["decoder.rnn_tick.bias_ih_l0"]
    emb = p["decoder.note_embedding_layer.weight"]
    w_out, b_out = (p["decoder.tick_emb_to_note_emb.0.weight"],
                    p["decoder.tick_emb_to_note_emb.0.bias"])
    drop = m["decoder_dropout_prob"]
    iota = torch.arange(V, device=dev)
    prev = p["decoder.x_0"][None].expand(B, E)
    forced = bool(teacher)
    gap = torch.zeros((), device=dev)
    if fed is not None and tuple(fed.shape) != (B, SEQ_LEN):
        fed, gap = None, torch.full((), math.inf, device=dev)  # not this batch's tokens
    logits_all, fed_all, h = [], [], None
    for t in range(SEQ_LEN):
        beat = t // TICKS_PER_BEAT
        if t % TICKS_PER_BEAT == 0:
            h = [tick_h0[:, beat, k] for k in range(Ld)]
        gi = prev @ w_ih0[:, :E].t() + gi_beat[:, beat]
        new_h = []
        for k in range(Ld):
            sfx = f"_l{k}"
            if k > 0:
                gi = inp @ p[f"decoder.rnn_tick.weight_ih{sfx}"].t() \
                    + p[f"decoder.rnn_tick.bias_ih{sfx}"]
            hk = gru_cell(gi, h[k], p[f"decoder.rnn_tick.weight_hh{sfx}"],
                          p[f"decoder.rnn_tick.bias_hh{sfx}"])
            new_h.append(hk)
            inp = hk
            if drop > 0.0 and k < Ld - 1:
                inp = inp * keep_mask(hash_uniform(tseed, t, k, B, Hd), drop)
        h = new_h
        logits = torch.relu(inp @ w_out.t() + b_out)
        scores = logits.detach()
        best = scores.amax(dim=1, keepdim=True)
        sampled = torch.where(scores == best, iota, V).amin(dim=1)
        tok = torch.where(teacher, ids[:, t], sampled).clamp(0, V - 1)
        if fed is not None:
            given = fed[:, t].long()
            if forced:
                gap = torch.where((given != tok).any(), math.inf, gap)
            else:
                below = best[:, 0] - scores.gather(1, given.clamp(0, V - 1)[:, None])[:, 0]
                gap = torch.maximum(gap, torch.where(((given < 0) | (given >= V)).any(),
                                                     math.inf, below.max()))
            tok = given.clamp(0, V - 1)
        logits_all.append(logits)
        fed_all.append(tok)
        prev = emb[tok]
    logits = torch.stack(logits_all, dim=1)  # (B, 24, V)

    recon = F.cross_entropy(logits.reshape(-1, V), ids.reshape(-1))
    loss = recon + kld(z_mean, z_log_std, o["beta"], o["capacity"])
    if o["reg_dim"]:
        loss = loss + ar_term(z, labels_of(score), o["reg_dim"], o["gamma"], o["delta"])
    return loss, {"fed": torch.stack(fed_all, dim=1).to(torch.int32),
                  "token_gap": float(gap), "logits": logits.detach().clone()}


def run_steps(cfg: dict, traffic: dict, seed: int, inputs: Dict[str, torch.Tensor],
              weights: Dict[str, torch.Tensor], steps: int, tf32: bool = False,
              fed: Optional[List[torch.Tensor]] = None) -> Steps:
    """The first ``steps`` training steps from ``weights`` on ``inputs``;
    with ``fed``, feeding back (and judging) the tokens a program fed in
    each step."""
    tokens = inputs["tokens"]
    dev, B = tokens.device, traffic["batch"]
    perm = torch.randperm(tokens.shape[0], device=dev,
                          generator=torch.Generator(dev).manual_seed(seed + PERM_SEED_OFFSET))
    gen = torch.Generator(dev).manual_seed(seed)
    with precision(tf32):
        return train(lambda p, i: forward_loss(p, cfg, tokens[perm[i * B:(i + 1) * B]], gen,
                                               None if fed is None else fed[i]),
                     weights, cfg["objective"]["lr"], steps)
