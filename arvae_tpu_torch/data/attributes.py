"""Tensorized music attribute extractors in PyTorch.

Counterpart of ``arvae_tpu/data/attributes.py``: a vocabulary is
compiled once into lookup tables (token → MIDI pitch, token → is-note),
held on the trainer's device, and every extractor is a masked tensor
reduction over (B, 24) token rows, so the training labels are computed
on the device inside the step.

Semantics as in the JAX package:
- ``contour``: (last note − first note) / 26, the telescoped sum of
  consecutive intervals; the first and last notes are the lowest and
  highest indices of the note mask;
- ``rhythmic_entropy``: ln(#onsets);
- ``interval_entropy``: the softmax entropy of the mod-12 histogram of
  the intervals between consecutive notes; the JAX package scans each
  row, here each note's predecessor is found by a cumulative max over
  note positions;
- range, contour and interval entropy are 0 for measures with fewer than
  2 notes.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from arvae_tpu_torch.data.music_theory import (BEAT_STRENGTH_WEIGHTS,
                                               RHY_COMPLEXITY_COEFFS, SLUR_SYMBOL,
                                               note_name_to_midi)

# Order matches the reference MUSIC_REG_TYPE (measure_vae_trainer.py:15-20)
MUSIC_REG_TYPE = {
    "rhy_complexity": 0,
    "pitch_range": 1,
    "note_density": 2,
    "contour": 3,
}


class MusicAttributes:
    """Vocab lookup tables on ``device`` + attribute extractors."""

    def __init__(self, index2note: Dict[int, str],
                 device: torch.device | str = "cpu"):
        vocab_size = max(index2note.keys()) + 1
        midi = np.full((vocab_size,), -1, dtype=np.int32)
        special = np.zeros((vocab_size,), dtype=bool)
        slur_idx = -1
        for idx, name in index2note.items():
            m = note_name_to_midi(name)
            if m is None:
                special[idx] = True
                if name == SLUR_SYMBOL:
                    slur_idx = idx
            else:
                midi[idx] = m
        self.device = torch.device(device)
        self.vocab_size = vocab_size
        self.midi_table = torch.from_numpy(midi).to(self.device)
        self.is_note_table = torch.from_numpy(~special).to(self.device)
        self.slur_index = slur_idx
        self.rhy_coeffs = torch.from_numpy(RHY_COMPLEXITY_COEFFS).to(self.device)
        self.beat_weights = torch.from_numpy(BEAT_STRENGTH_WEIGHTS).to(self.device)

    def _take(self, table: torch.Tensor, t: torch.Tensor, fill) -> torch.Tensor:
        """``table[t]`` read as ``jnp.take`` reads it: an id in [-V, 0)
        counts from the end, and an id outside [-V, V) reads ``fill``."""
        v = self.vocab_size
        ids = t.long()
        idx = torch.where(ids < 0, ids + v, ids).clamp(0, v - 1)
        inside = (ids >= -v) & (ids < v)
        return torch.where(inside, table[idx], fill)

    # -- masks ---------------------------------------------------------------

    def note_mask(self, t: torch.Tensor) -> torch.Tensor:
        """(B, T) bool: token is an actual pitch (onset); True past the
        table (jnp.take's fill for bool)."""
        return self._take(self.is_note_table, t, True)

    def note_midi(self, t: torch.Tensor) -> torch.Tensor:
        """(B, T) int32 MIDI pitch, -1 on non-notes; the int32 minimum past
        the table (jnp.take's fill for int32)."""
        return self._take(self.midi_table, t, torch.iinfo(torch.int32).min)

    # -- extractors (reference bar_dataset.py:338-542) -----------------------

    def note_density(self, t: torch.Tensor) -> torch.Tensor:
        """#notes / seq_len."""
        return self.note_mask(t).float().mean(dim=1)

    def pitch_range(self, t: torch.Tensor) -> torch.Tensor:
        """(max − min MIDI)/26, 0 if < 2 notes."""
        mask = self.note_mask(t)
        midi = self.note_midi(t)
        big = torch.where(mask, midi, -(10**6)).amax(dim=1)
        small = torch.where(mask, midi, 10**6).amin(dim=1)
        enough = mask.sum(dim=1) >= 2
        return torch.where(enough, (big - small).float(), 0.0) / 26.0

    def contour(self, t: torch.Tensor) -> torch.Tensor:
        """(last − first note MIDI)/26, 0 if < 2 notes."""
        mask = self.note_mask(t)
        midi = self.note_midi(t).float()
        n = t.shape[1]
        pos = torch.arange(n, device=t.device)
        # lowest / highest index of the mask, as argmax reads it (an
        # empty row's picks are arbitrary and masked out below)
        first_idx = torch.where(mask, pos, n).amin(dim=1).clamp(max=n - 1)
        last_idx = torch.where(mask, pos, -1).amax(dim=1).clamp(min=0)
        first = midi.gather(1, first_idx[:, None])[:, 0]
        last = midi.gather(1, last_idx[:, None])[:, 0]
        enough = mask.sum(dim=1) >= 2
        return torch.where(enough, last - first, 0.0) / 26.0

    def rhy_complexity(self, t: torch.Tensor) -> torch.Tensor:
        """Toussaint-weighted onset sum / Σweights."""
        onsets = self.note_mask(t).float()
        return onsets @ self.rhy_coeffs / self.rhy_coeffs.sum()

    def beat_strength(self, t: torch.Tensor) -> torch.Tensor:
        """Beat-position-weighted non-slur mask (the reference masks only
        the slur symbol here)."""
        return (t != self.slur_index).float() @ self.beat_weights

    def rhythmic_entropy(self, t: torch.Tensor) -> torch.Tensor:
        """ln(#onsets): scipy entropy of the normalized 0/1 onset column."""
        count = self.note_mask(t).sum(dim=1).float()
        return torch.where(count > 0, torch.log(count.clamp(min=1.0)), 0.0)

    def interval_entropy(self, t: torch.Tensor) -> torch.Tensor:
        """Softmax entropy of the mod-12 interval histogram, 0 if < 2 notes."""
        mask = self.note_mask(t)
        midi = self.note_midi(t)
        n = t.shape[1]
        pos = torch.arange(n, device=t.device)
        # the position of the last note strictly before each tick (-1: none)
        last = torch.where(mask, pos, -1).cummax(dim=1).values
        prev_pos = torch.cat([torch.full_like(last[:, :1], -1), last[:, :-1]], dim=1)
        prev = torch.where(prev_pos >= 0, midi.gather(1, prev_pos.clamp(min=0)), -1)
        valid = mask & (prev >= 0)
        # int32 as in the JAX scan (a pitch past the table wraps the same way)
        interval = torch.where(valid, (midi - prev).abs() % 12, 0)
        hist = (torch.nn.functional.one_hot(interval.long(), 12)
                * valid[..., None]).sum(dim=1).float()
        ent = -(torch.softmax(hist, dim=1) * torch.log_softmax(hist, dim=1)).sum(dim=1)
        return torch.where(mask.sum(dim=1) >= 2, ent, 0.0)

    # -- batch labels ---------------------------------------------------------

    def compute_labels(self, t: torch.Tensor,
                       attr_list: Optional[Sequence[str]] = None) -> torch.Tensor:
        """(B, A) attribute matrix in MUSIC_REG_TYPE column order."""
        if attr_list is None:
            attr_list = list(MUSIC_REG_TYPE.keys())
        fns = {
            "rhy_complexity": self.rhy_complexity,
            "pitch_range": self.pitch_range,
            "note_density": self.note_density,
            "contour": self.contour,
            "beat_strength": self.beat_strength,
            "rhythmic_entropy": self.rhythmic_entropy,
            "interval_entropy": self.interval_entropy,
        }
        return torch.stack([fns[a](t) for a in attr_list], dim=1)
