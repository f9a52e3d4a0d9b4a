"""Bar datasets: monophonic measures on a 24-tick grid (numpy).

A copy of ``arvae_tpu/data/bar_dataset.py`` so that the two packages
build byte-identical corpora: the same vocab file (the two-line literal
format, at the same ``dict_path``), tune split, transposition shifts,
START/END window padding and cache ``.npz`` names under the shared
datasets root. Whichever package builds a cache first, the other reads
it. The corpus is, as there:

1. the ``.abc`` files of ``folk_raw_data/`` when it holds any (folk
   only), parsed by :mod:`arvae_tpu_torch.data.abc_parser` through the
   validity filter, whose full list is cached as
   ``<ts>valid_filelist.txt``; the list is shuffled by
   ``RandomState(0)`` and capped at 20 files (``--short``) or 25,000;
   tunes that fail to parse are skipped;
2. otherwise the synthetic corpus, from the same generator and seeds
   (folk 1234, chorale 4321) and tune counts.

Scores are :class:`Score` note lists (pitch, start, duration in
quarters; pitch -1 a rest), written as MIDI by
:mod:`arvae_tpu_torch.utils.midi`.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from arvae_tpu_torch.data.attributes import MusicAttributes
from arvae_tpu_torch.data.device_data import DeviceSplit
from arvae_tpu_torch.data.dsprites import datasets_root
from arvae_tpu_torch.data.music_theory import (END_SYMBOL, REST_SYMBOL, SLUR_SYMBOL,
                                               START_SYMBOL, TICK_DURATIONS,
                                               TICKS_PER_MEASURE, midi_to_note_name,
                                               note_name_to_midi)
from arvae_tpu_torch.utils.midi import write_midi


@dataclass
class Score:
    """A monophonic score as (pitch, start_quarters, dur_quarters) events;
    pitch -1 denotes a rest."""

    notes: List[Tuple[int, float, float]] = field(default_factory=list)

    @property
    def highest_time(self) -> float:
        return max((s + d for _, s, d in self.notes), default=0.0)

    def write_midi(self, path: str) -> None:
        write_midi(self.notes, path)

    def write(self, fmt: str, fp: str) -> None:
        """music21's ``score.write("midi", fp=...)``, MIDI only."""
        if fmt != "midi":
            raise ValueError(f"only MIDI is written, not {fmt!r}")
        self.write_midi(fp)

# Onset probability per tick position within a beat (strong beats first)
_FOLK_ONSET_P = np.tile([0.95, 0.08, 0.12, 0.45, 0.12, 0.25], 4)
_CHORALE_ONSET_P = np.tile([0.97, 0.02, 0.03, 0.30, 0.03, 0.08], 4)


def generate_synthetic_tune(rng: np.random.RandomState, num_measures: int,
                            style: str = "folk") -> np.ndarray:
    """One tune as (midi-or-codes,) per tick: >=0 pitch onset, -1 slur
    (continuation), -2 rest onset."""
    onset_p = _FOLK_ONSET_P if style == "folk" else _CHORALE_ONSET_P
    lo, hi = 57, 82  # leave transposition headroom inside [55, 84]
    T = num_measures * TICKS_PER_MEASURE
    out = np.full((T,), -1, dtype=np.int64)
    pitch = rng.randint(lo + 5, hi - 5)
    step_choices = np.array([-5, -4, -3, -2, -1, 1, 2, 3, 4, 5])
    step_p = np.array([2, 3, 6, 12, 20, 20, 12, 6, 3, 2], dtype=np.float64)
    step_p /= step_p.sum()
    for t in range(T):
        if rng.rand() < onset_p[t % TICKS_PER_MEASURE]:
            if rng.rand() < 0.06:
                out[t] = -2  # rest
                continue
            pitch = pitch + rng.choice(step_choices, p=step_p)
            pitch = int(np.clip(pitch, lo, hi))
            out[t] = pitch
    # guarantee the tune opens with a note
    if out[0] < 0:
        out[0] = pitch
    return out


def _tune_token_names(tune: np.ndarray, shift: int = 0) -> List[str]:
    names = []
    for v in tune:
        if v == -1:
            names.append(SLUR_SYMBOL)
        elif v == -2:
            names.append(REST_SYMBOL)
        else:
            names.append(midi_to_note_name(int(v) + shift))
    return names


_TICK_STARTS = np.cumsum([0.0] + [float(d) for d in TICK_DURATIONS])


def onset_tick(start: float, beat_subdivisions: int) -> int:
    """The tick of a note onset (in quarters): the one grid-snapping rule
    of ``score_to_tensor`` and ``score_to_tick_codes``."""
    beat, frac = divmod(start, 1.0)
    tick_in_beat = int(np.argmin(np.abs(_TICK_STARTS[:-1] - frac)))
    return int(beat) * beat_subdivisions + tick_in_beat


def score_to_tick_codes(score: Score, beat_subdivisions: int = 6) -> Optional[np.ndarray]:
    """Score → per-tick codes: ≥0 MIDI onset, -1 slur continuation, -2
    rest onset (the tunes' representation); None for an empty score."""
    length = int(round(score.highest_time * beat_subdivisions))
    if length == 0:
        return None
    codes = np.full((length,), -1, dtype=np.int64)
    for pitch, start, _ in score.notes:
        tick = onset_tick(start, beat_subdivisions)
        if tick >= length:
            continue
        codes[tick] = -2 if pitch < 0 else int(pitch)
    return codes


class FolkBarDataset:
    """Single-measure folk dataset over the synthetic corpus."""

    style = "folk"
    n_tunes_full = 150
    n_tunes_short = 20

    def __init__(self, time_sig_num: int = 4, time_sig_den: int = 4,
                 dataset_type: str = "train", is_short: bool = False,
                 raw_datapath: Optional[str] = None):
        self.pitch_range = [55, 84]
        self.dataset_type = dataset_type
        self.is_short = is_short
        self.time_sig_num = time_sig_num
        self.time_sig_den = time_sig_den
        self.time_sig_str = f"{time_sig_num}by{time_sig_den}"
        self.beat_subdivisions = len(TICK_DURATIONS)
        self.dataset_dir_path = datasets_root()
        self.class_name = f"{self.time_sig_str}_{type(self).__name__}_"
        self.raw_datapath = raw_datapath or os.path.join(os.getcwd(), "folk_raw_data")
        self.max_num_files = 20 if is_short else 25000
        self.note2index_dicts: Dict[str, int] = {}
        self.index2note_dicts: Dict[int, str] = {}
        self._tunes: Optional[List[np.ndarray]] = None
        self._all_tunes: Optional[List[np.ndarray]] = None
        self._dataset_cache: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._init_vocab()

    def __repr__(self):
        return self.class_name

    # -- vocab persistence ----------------------------------------------------

    @property
    def dict_path(self) -> str:
        return os.path.join(self.dataset_dir_path,
                            f"{self.time_sig_str}_{self.style}_index_dicts.txt")

    def update_index_dicts(self) -> None:
        os.makedirs(self.dataset_dir_path, exist_ok=True)
        with open(self.dict_path, "w") as f:
            f.write("%s\n" % self.index2note_dicts)
            f.write("%s\n" % self.note2index_dicts)

    def read_index_dicts(self) -> bool:
        if not os.path.exists(self.dict_path):
            return False
        with open(self.dict_path) as f:
            dicts = [line.rstrip("\n") for line in f]
        if len(dicts) != 2:
            raise ValueError(f"{self.dict_path}: expected 2 lines, got {len(dicts)}")
        self.index2note_dicts = ast.literal_eval(dicts[0])
        self.note2index_dicts = ast.literal_eval(dicts[1])
        return True

    def _token_index(self, name: str) -> int:
        """Token id for a note name, growing the vocabulary on unseen
        names (re-reading the shared dict file first, and persisting
        every growth at once), as the JAX package does."""
        idx = self.note2index_dicts.get(name)
        if idx is not None:
            return idx
        if self.read_index_dicts():
            idx = self.note2index_dicts.get(name)
            if idx is not None:
                return idx
        new_index = len(self.note2index_dicts)
        self.index2note_dicts[new_index] = name
        self.note2index_dicts[name] = new_index
        print(f"Warning: Entry {{{new_index}: {name!r}}} added to dictionaries")
        self.update_index_dicts()
        return new_index

    def build_vocab(self, note_names: Sequence[str]) -> None:
        """Vocabulary from a name set + specials, in insertion order."""
        names = [SLUR_SYMBOL, START_SYMBOL, END_SYMBOL, REST_SYMBOL]
        for n in note_names:
            if n not in names:
                names.append(n)
        self.index2note_dicts = {i: n for i, n in enumerate(names)}
        self.note2index_dicts = {n: i for i, n in enumerate(names)}
        self.update_index_dicts()

    def attrs(self, device: torch.device | str = "cpu") -> MusicAttributes:
        """The attribute tables of the current vocabulary on ``device``."""
        return MusicAttributes(self.index2note_dicts, device)

    # -- corpus ----------------------------------------------------------------

    def _abc_files(self) -> List[str]:
        """The ``.abc`` files of ``raw_datapath``, sorted (folk only)."""
        if self.style != "folk" or not os.path.isdir(self.raw_datapath):
            return []
        return sorted(os.path.join(self.raw_datapath, f)
                      for f in os.listdir(self.raw_datapath) if f.endswith(".abc"))

    def _valid_abc_files(self) -> List[str]:
        """The files that pass the validity filter, cached as
        ``<ts>valid_filelist.txt`` in the datasets root. The cache holds
        the full valid list; the reader applies ``max_num_files``, so a
        ``--short`` run never stands for a full one."""
        from arvae_tpu_torch.data.abc_parser import is_valid_folk_tune

        os.makedirs(self.dataset_dir_path, exist_ok=True)
        cache = os.path.join(self.dataset_dir_path, self.time_sig_str + "valid_filelist.txt")
        if os.path.exists(cache):
            with open(cache) as f:
                return [os.path.join(self.raw_datapath, line.rstrip("\n"))
                        for line in f if line.strip()]
        valid = [path for path in self._abc_files()
                 if is_valid_folk_tune(path, (self.time_sig_num, self.time_sig_den))]
        with open(cache, "w") as f:
            for p in valid:
                f.write(os.path.basename(p) + "\n")
        return valid

    def _corpus_all_tunes(self) -> List[np.ndarray]:
        """Every tune of the corpus (both splits), read once."""
        if self._all_tunes is None:
            if self._abc_files():
                from arvae_tpu_torch.data.abc_parser import parse_abc_file

                files = self._valid_abc_files()
                order = np.random.RandomState(0).permutation(len(files))
                # the cap after the shuffle, whichever run built the cache
                files = [files[i] for i in order][: self.max_num_files]
                tunes = []
                for p in files:
                    try:
                        _, score = parse_abc_file(p)
                    except Exception:  # a tune that fails to parse is skipped
                        continue
                    codes = score_to_tick_codes(score, self.beat_subdivisions)
                    if codes is not None:
                        tunes.append(codes)
            else:
                n = self.n_tunes_short if self.is_short else self.n_tunes_full
                rng = np.random.RandomState(1234 if self.style == "folk" else 4321)
                tunes = [generate_synthetic_tune(rng, num_measures=int(rng.randint(8, 17)),
                                                 style=self.style)
                         for _ in range(n)]
            self._all_tunes = tunes
        return self._all_tunes

    def _corpus_tunes(self) -> List[np.ndarray]:
        """The tunes of this split: the first 90% train, the rest test."""
        if self._tunes is None:
            tunes = self._corpus_all_tunes()
            n_train = int(0.9 * len(tunes))
            self._tunes = tunes[:n_train] if self.dataset_type == "train" else tunes[n_train:]
        return self._tunes

    def _init_vocab(self) -> None:
        if self.read_index_dicts():
            return
        # names over all tunes AND all transpositions, so augmentation
        # never grows the vocabulary
        names: List[str] = []
        for tune in self._corpus_all_tunes():
            for shift in self._transposition_shifts(tune):
                for nm in set(_tune_token_names(tune, shift)):
                    if nm not in names:
                        names.append(nm)
        self.build_vocab(sorted(set(names) - {SLUR_SYMBOL, REST_SYMBOL}))

    def _transposition_shifts(self, tune: np.ndarray) -> List[int]:
        """All semitone shifts keeping the tune inside pitch_range."""
        pitches = tune[tune >= 0]
        if len(pitches) == 0:
            return [0]
        lo, hi = int(pitches.min()), int(pitches.max())
        return list(range(self.pitch_range[0] - lo, self.pitch_range[1] - hi + 1))

    def _tokens(self, tune: np.ndarray, shift: int = 0) -> np.ndarray:
        """Token ids of one tune; a name the vocabulary lacks (a real
        corpus's pitch outside a cached file's span) grows it."""
        return np.array([self._token_index(nm) for nm in _tune_token_names(tune, shift)],
                        dtype=np.int64)

    # -- scores ----------------------------------------------------------------

    def score_to_tensor(self, score: Score) -> Optional[np.ndarray]:
        """Score → (1, L) token row: a token at each onset tick, SLUR on
        continuations; None for an empty score. An unseen note name
        grows the vocabulary."""
        length = int(round(score.highest_time * self.beat_subdivisions))
        if length == 0:
            return None
        tokens = np.full((length,), self.note2index_dicts[SLUR_SYMBOL], dtype=np.int64)
        for pitch, start, _ in score.notes:
            tick = onset_tick(start, self.beat_subdivisions)
            if tick >= length:
                continue
            name = REST_SYMBOL if pitch < 0 else midi_to_note_name(pitch)
            tokens[tick] = self._token_index(name)
        return tokens[None, :]

    def tensor_to_m21score(self, tensor_score) -> Score:
        """Token row(s) → Score: every token but SLUR starts an event,
        which lasts until the next one; a token with no pitch (rest,
        START, END) is a rest."""
        slur_index = self.note2index_dicts[SLUR_SYMBOL]
        flat = np.asarray(tensor_score).reshape(-1)
        notes: List[Tuple[int, float, float]] = []
        cur_pitch = None
        cur_start = 0.0
        t = 0.0
        for tick_index, note_index in enumerate(flat):
            dur = float(TICK_DURATIONS[tick_index % self.beat_subdivisions])
            if note_index != slur_index:
                if cur_pitch is not None:
                    notes.append((cur_pitch, cur_start, t - cur_start))
                midi = note_name_to_midi(self.index2note_dicts[int(note_index)])
                cur_pitch = midi if midi is not None else -1
                cur_start = t
            t += dur
        if cur_pitch is not None:
            notes.append((cur_pitch, cur_start, t - cur_start))
        return Score(notes=notes)

    @staticmethod
    def concatenate_scores(scores_list: Sequence[Score]) -> Score:
        """Back-to-back measures, 4 quarters apart."""
        out = Score()
        offset = 0.0
        for s in scores_list:
            for p, st, d in s.notes:
                out.notes.append((p, offset + st, d))
            offset += 4.0
        return out

    def empty_score_tensor(self, score_length: int) -> np.ndarray:
        """(1, score_length) SLUR tokens."""
        return np.full((1, score_length), self.note2index_dicts[SLUR_SYMBOL], dtype=np.int64)

    # -- tensors ---------------------------------------------------------------

    def split_tensor_to_bars(self, score_tensor: np.ndarray) -> np.ndarray:
        """(1, L) → (num_bars, 24)."""
        if score_tensor.shape[0] != 1:
            raise ValueError(f"expected one row, got {score_tensor.shape}")
        bar_len = self.beat_subdivisions * self.time_sig_num
        num_bars = score_tensor.shape[1] // bar_len
        return score_tensor[0, : num_bars * bar_len].reshape(num_bars, bar_len)

    def get_tensor_with_padding(self, tensor: np.ndarray, start_tick: int,
                                end_tick: int) -> np.ndarray:
        """Ticks [start_tick, end_tick) of (batch, L) rows, START-padded
        before 0 and END-padded past L."""
        if start_tick >= end_tick:
            raise ValueError(f"empty window [{start_tick}, {end_tick})")
        batch, length = tensor.shape
        parts = []
        if start_tick < 0:
            parts.append(np.full((batch, -start_tick),
                                 self.note2index_dicts[START_SYMBOL], dtype=np.int64))
        parts.append(tensor[:, max(start_tick, 0):min(end_tick, length)])
        if end_tick > length:
            parts.append(np.full((batch, end_tick - length),
                                 self.note2index_dicts[END_SYMBOL], dtype=np.int64))
        return np.concatenate(parts, axis=1)

    # -- dataset ---------------------------------------------------------------

    @property
    def dataset_path(self) -> str:
        sfx = "_short" if self.is_short else ""
        return os.path.join(self.dataset_dir_path,
                            self.class_name + self.dataset_type + sfx + ".npz")

    def get_dataset(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._dataset_cache is None:
            if os.path.exists(self.dataset_path):
                data = np.load(self.dataset_path)
                self._dataset_cache = data["score"], data["metadata"]
            else:
                score = self.make_rows()
                os.makedirs(self.dataset_dir_path, exist_ok=True)
                np.savez_compressed(self.dataset_path, score=score, metadata=score)
                print("Dataset Size: ", score.shape)
                self._dataset_cache = score, score
        return self._dataset_cache

    def make_rows(self) -> np.ndarray:
        bars = [self.split_tensor_to_bars(self._tokens(tune)[None, :])
                for tune in self._corpus_tunes()]
        if sum(b.shape[0] for b in bars) == 0:
            raise ValueError(f"corpus produced no {self.dataset_type!r} bars")
        return np.concatenate(bars, 0)

    def device_splits(self, device: torch.device, split=(0.70, 0.20), ctx=None
                      ) -> Tuple[DeviceSplit, DeviceSplit]:
        """Device-resident (train, val) token splits: rows [0, 70%) and
        [70%, 90%) of the corpus, reshaped to 24-tick measures, over the
        data axis ``ctx`` (``DeviceSplit``'s)."""
        score, _ = self.get_dataset()
        n = len(score)
        a, b = split
        i0, i1 = int(a * n), int((a + b) * n)

        def mk(sl):
            rows = np.asarray(score[sl], np.int32).reshape(-1, TICKS_PER_MEASURE)
            return DeviceSplit(rows, None, (TICKS_PER_MEASURE,), "tokens", device, ctx)

        return mk(slice(0, i0)), mk(slice(i0, i1))

    def device_eval_split(self, device: torch.device, split=(0.85, 0.10)) -> DeviceSplit:
        """Device-resident eval split: the rows past ``sum(split)`` of the
        corpus (the host loaders' test split), as 24-tick measures."""
        score, _ = self.get_dataset()
        i1 = int(sum(split) * len(score))
        rows = np.asarray(score[i1:], np.int32).reshape(-1, TICKS_PER_MEASURE)
        return DeviceSplit(rows, None, (TICKS_PER_MEASURE,), "tokens", device)

    # -- attribute getters: (N, 24) measures → (N,) numpy ----------------------

    def _attribute(self, name: str, measure_tensor) -> np.ndarray:
        t = torch.as_tensor(np.asarray(measure_tensor))
        return getattr(self.attrs(), name)(t).numpy()

    def get_note_density_in_measure(self, measure_tensor):
        return self._attribute("note_density", measure_tensor)

    def get_pitch_range_in_measure(self, measure_tensor):
        return self._attribute("pitch_range", measure_tensor)

    def get_rhy_complexity(self, measure_tensor):
        return self._attribute("rhy_complexity", measure_tensor)

    def get_contour(self, measure_tensor):
        return self._attribute("contour", measure_tensor)

    def get_beat_strength(self, measure_tensor):
        return self._attribute("beat_strength", measure_tensor)

    def get_rhythmic_entropy(self, measure_tensor):
        return self._attribute("rhythmic_entropy", measure_tensor)

    def get_interval_entropy(self, measure_tensor):
        return self._attribute("interval_entropy", measure_tensor)


class FolkNBarDataset(FolkBarDataset):
    """n-bar windows with transposition augmentation and START/END padding."""

    def __init__(self, time_sig_num: int = 4, time_sig_den: int = 4,
                 dataset_type: str = "train", is_short: bool = False,
                 num_bars: int = 16, raw_datapath: Optional[str] = None):
        self.n_bars = num_bars
        super().__init__(time_sig_num, time_sig_den, dataset_type, is_short,
                         raw_datapath=raw_datapath)
        self.class_name = f"{self.time_sig_str}_{type(self).__name__}_{self.n_bars}_"
        self.num_beats_per_bar = time_sig_num
        self.seq_size_in_beats = self.num_beats_per_bar * self.n_bars

    def make_rows(self) -> np.ndarray:
        windows = []
        seq_ticks = self.seq_size_in_beats * self.beat_subdivisions
        for tune in self._corpus_tunes():
            for shift in self._transposition_shifts(tune):
                tokens = self._tokens(tune, shift)[None, :]
                total_beats = tokens.shape[1] // self.beat_subdivisions
                for off in range(-self.num_beats_per_bar, total_beats,
                                 self.seq_size_in_beats):
                    start = off * self.beat_subdivisions
                    windows.append(self.get_tensor_with_padding(tokens, start,
                                                                start + seq_ticks))
        if not windows:
            raise ValueError(f"corpus produced no {self.dataset_type!r} windows")
        return np.concatenate(windows, 0)


class ChoraleNBarDataset(FolkNBarDataset):
    """n-bar windows of the synthetic chorale-style corpus."""

    style = "chorale"
    n_tunes_full = 120
    n_tunes_short = 10
