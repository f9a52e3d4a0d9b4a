"""Music constants and pitch-name arithmetic (no music21 dependency).

A verbatim copy of ``arvae_tpu/data/music_theory.py`` (that package's
``data`` imports jax), so both packages share one tick grid, vocabulary
symbols and note naming. The JAX original replaces the music21-backed helpers of the reference
(``data/dataloaders/bar_dataset_helpers.py``): the tick grid (6
subdivisions/beat × 4 beats = 24 ticks/measure), the special vocabulary
symbols, the Toussaint metrical-weight vector, and note-name ↔ MIDI
conversion following music21's naming convention (``C4`` = 60, ``#``
sharp, ``-`` flat).
"""

from __future__ import annotations

from fractions import Fraction
from typing import List, Optional

import numpy as np

MAX_NOTES = 1000
SLUR_SYMBOL = "__"
START_SYMBOL = "START"
END_SYMBOL = "END"
REST_SYMBOL = "rest"

TICK_VALUES = [
    Fraction(0),
    Fraction(1, 4),
    Fraction(1, 3),
    Fraction(1, 2),
    Fraction(2, 3),
    Fraction(3, 4),
]

BEAT_SUBDIVISIONS = len(TICK_VALUES)  # 6
TICKS_PER_MEASURE = 24

# Toussaint metrical complexity weights (reference
# bar_dataset_helpers.py:21-30)
RHY_COMPLEXITY_COEFFS = np.array(
    [
        0.20, 1, 2, 0.5, 2, 1,
        0.67, 1, 2, 0.5, 2, 1,
        0.25, 1, 2, 0.5, 2, 1,
        0.67, 1, 2, 0.5, 2, 1,
    ],
    dtype=np.float32,
)

# Beat-strength weights (reference bar_dataset.py:432-433)
BEAT_STRENGTH_WEIGHTS = np.tile(
    np.array([1, 0.008, 0.008, 0.15, 0.008, 0.008]), 4
).astype(np.float32)


def compute_tick_durations() -> List[Fraction]:
    """Duration of each tick slot in quarter-note units
    (reference bar_dataset_helpers.py:41-48)."""
    diff = [n - p for n, p in zip(TICK_VALUES[1:], TICK_VALUES[:-1])]
    return diff + [1 - TICK_VALUES[-1]]


TICK_DURATIONS = compute_tick_durations()

_LETTER_SEMITONES = {"C": 0, "D": 2, "E": 4, "F": 5, "G": 7, "A": 9, "B": 11}
_SHARP_NAMES = ["C", "C#", "D", "E-", "E", "F", "F#", "G", "A-", "A", "B-", "B"]


def note_name_to_midi(name: str) -> Optional[int]:
    """'C4' → 60, 'F#5' → 78, 'B-3' → 58. None for non-pitch symbols
    (rest/slur/start/end/None)."""
    if name is None or name in (SLUR_SYMBOL, START_SYMBOL, END_SYMBOL,
                                REST_SYMBOL):
        return None
    letter = name[0].upper()
    if letter not in _LETTER_SEMITONES:
        return None
    i = 1
    acc = 0
    while i < len(name) and name[i] in "#-":
        acc += 1 if name[i] == "#" else -1
        i += 1
    try:
        octave = int(name[i:])
    except ValueError:
        return None
    return (octave + 1) * 12 + _LETTER_SEMITONES[letter] + acc


def midi_to_note_name(midi: int) -> str:
    """60 → 'C4' (sharp/flat spelling per music21's common defaults)."""
    octave = midi // 12 - 1
    return f"{_SHARP_NAMES[midi % 12]}{octave}"
