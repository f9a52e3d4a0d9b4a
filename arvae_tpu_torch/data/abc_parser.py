"""Minimal ABC-notation parser for monophonic folk tunes (pure Python).

A copy of ``arvae_tpu/data/abc_parser.py`` on the port's
:class:`~arvae_tpu_torch.data.bar_dataset.Score`, so that both packages
read a ``folk_raw_data/`` corpus into the same notes and the same
validity verdicts. The subset of ABC the folk pipeline needs:

- headers: X (index), T (title), M (meter), L (unit note length),
  K (key: major/minor and the common folk modes);
- body: notes with ABC octave marks (``A`` ``a`` ``A,`` ``a'``),
  accidentals (``^`` ``_`` ``=``, bar-persistent), duration multipliers
  (``A2`` ``A/2`` ``A3/2`` ``A/``), rests (``z`` ``x``), ties (``-``),
  broken rhythms (``>`` ``<``, durations kept), triplets/tuplets
  ``(3``, simple repeats ``|: ... :|`` with first/second endings
  ``|1 ... :|2``;
- skipped: grace notes ``{}``, decorations ``!...!``/``~``, inline
  fields ``[K:..]``, chord symbols in quotes;
- rejected: a mid-tune change of K, L or M.

``is_valid_folk_tune`` is the validity filter: a title, one voice, no
chords, a single 4/4 meter, at least one pitched note, at most
``MAX_NOTES`` events, every onset on the tick grid.
"""

from __future__ import annotations

import re
from fractions import Fraction
from typing import Dict, List, Optional, Tuple

from arvae_tpu_torch.data.bar_dataset import Score
from arvae_tpu_torch.data.music_theory import MAX_NOTES, TICK_VALUES

_LETTER_PC = {"C": 0, "D": 2, "E": 4, "F": 5, "G": 7, "A": 9, "B": 11}
_SHARP_ORDER = "FCGDAEB"
_FLAT_ORDER = "BEADGCF"
# semitone pitch-class of relative major tonic -> number of sharps (+) /
# flats (-)
_MAJOR_SHARPS = {0: 0, 7: 1, 2: 2, 9: 3, 4: 4, 11: 5, 6: 6, 1: 7,
                 5: -1, 10: -2, 3: -3, 8: -4}
_MODE_SHIFT = {  # semitones UP from the tonic to its relative major
    "": 0, "maj": 0, "major": 0, "ion": 0,
    "m": 3, "min": 3, "minor": 3, "aeo": 3, "aeolian": 3,
    "dor": 10, "dorian": 10,
    "mix": 5, "mixolydian": 5,
    "phr": 8, "phrygian": 8,
    "lyd": 7, "lydian": 7,
    "loc": 1, "locrian": 1,
}


class AbcParseError(ValueError):
    pass


def key_accidentals(key_str: str) -> Dict[str, int]:
    """'D' → {'F': 1, 'C': 1}; 'Ador' → {'F':1,'C':1}; 'F' → {'B': -1}."""
    key_str = key_str.strip()
    m = re.match(r"^([A-Ga-g])([#b]?)\s*(\w*)", key_str)
    if not m:
        raise AbcParseError(f"bad key: {key_str!r}")
    letter, acc, mode = m.group(1).upper(), m.group(2), m.group(3).lower()
    mode = re.sub(r"[^a-z]", "", mode)
    for known in ("major", "minor", "mixolydian", "dorian", "phrygian",
                  "lydian", "locrian", "aeolian", "maj", "min", "mix",
                  "dor", "phr", "lyd", "loc", "aeo", "ion", "m"):
        if mode.startswith(known):
            mode = known
            break
    else:
        mode = ""
    pc = _LETTER_PC[letter] + (1 if acc == "#" else -1 if acc == "b" else 0)
    rel_major = (pc + _MODE_SHIFT.get(mode, 0)) % 12
    if rel_major not in _MAJOR_SHARPS:
        raise AbcParseError(f"unsupported key: {key_str!r}")
    n = _MAJOR_SHARPS[rel_major]
    out: Dict[str, int] = {}
    if n > 0:
        for ltr in _SHARP_ORDER[:n]:
            out[ltr] = 1
    elif n < 0:
        for ltr in _FLAT_ORDER[:-n]:
            out[ltr] = -1
    return out


# -- file-level predicates (reference bar_dataset_helpers.py:187-227) -------


def get_title(path: str) -> Optional[str]:
    for line in open(path, errors="ignore"):
        if line[:2] == "T:":
            return line[2:].strip()
    return None


def tune_contains_chords(path: str) -> bool:
    """Quote-style chord symbols anywhere, or bracketed note chords
    like [CEG] on music lines (the lookahead excludes inline fields
    such as [K:G]; field lines are exempt so a title containing '[A..'
    is not mistaken for a chord)."""
    bracket_chord = re.compile(r"\[[A-Ga-g](?!:)")
    for line in open(path, errors="ignore"):
        if '"' in line:
            return True
        if re.match(r"^[A-Za-z]\s*:", line):
            continue
        if bracket_chord.search(line):
            return True
    return False


def tune_is_multivoice(path: str) -> bool:
    for line in open(path, errors="ignore"):
        if re.match(r"^V\s*:\s*2", line):
            return True
    return False


# -- body tokenization --------------------------------------------------------

_NOTE_RE = re.compile(
    r"(?P<acc>[\^_=]*)(?P<letter>[A-Ga-gzx])(?P<oct>[',]*)"
    r"(?P<num>\d*)(?P<slash>/*)(?P<den>\d*)"
)


def _strip_body_noise(line: str) -> str:
    line = re.sub(r'"[^"]*"', "", line)  # chord symbols / annotations
    line = re.sub(r"\{[^}]*\}", "", line)  # grace notes
    line = re.sub(r"![^!]*!", "", line)  # decorations
    line = re.sub(r"\[[A-Za-z]:[^\]]*\]", "", line)  # inline fields
    line = line.split("%")[0]  # comments
    return line


def _expand_repeats(bars: List[str]) -> List[str]:
    """Expands repeat sections with optional |1 / |2 endings.

    ``section`` accumulates bars since the last *boundary* — the tune
    start, an explicit ``|:``, or the flush of a previous repeat — so a
    bare ``:|`` with no opening ``|:`` repeats from the boundary (the
    standard folk-ABC implicit repeat, which music21's Expander also
    honors). The expansion is emitted AT the closing ``:|``; second
    endings then simply play once inline, so no deferred-flush state is
    needed (a deferred flush emitted later bars out of order)."""
    out: List[str] = []
    section: List[str] = []
    ending1: List[str] = []
    in_ending1 = False

    def flush(repeat: bool) -> None:
        nonlocal section, ending1, in_ending1
        out.extend(section)
        out.extend(ending1)
        if repeat:
            out.extend(section)
        section = []
        ending1 = []
        in_ending1 = False

    for bar, marks in bars:
        if "start_repeat" in marks:
            flush(repeat=False)  # bars before an explicit |: play once
        if "ending1" in marks:
            in_ending1 = True
            ending1 = []
        (ending1 if in_ending1 else section).append(bar)
        if "end_repeat" in marks:
            flush(repeat=True)
    flush(repeat=False)  # trailing bars (incl. a dangling first ending)
    return out


def parse_abc(text: str) -> Tuple[Dict[str, str], Score]:
    """Parses one ABC tune body into (headers, Score)."""
    headers: Dict[str, str] = {}
    body_lines: List[str] = []
    in_body = False
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        m = re.match(r"^([A-Za-z])\s*:(.*)$", line)
        if m:
            # information-field line (w: lyrics, P: parts, Q: tempo, …):
            # NEVER tokenized as music — lyric letters would inject
            # spurious notes. Mid-body K/L/M changes to a DIFFERENT
            # value are rejected rather than misparsed with the
            # header's key/unit/meter (the reference's music21 path
            # handles them; its validator also rejects multi-meter
            # tunes, bar_dataset.py:885-887).
            field, value = m.group(1), m.group(2).strip()
            if in_body and field in "KLM" and headers.get(field, value) != value:
                raise AbcParseError(
                    f"mid-tune {field}: change {headers[field]!r} -> "
                    f"{value!r}"
                )
            headers.setdefault(field, value)
            if field == "K":
                in_body = True
            continue
        if in_body:
            body_lines.append(line)

    for ln in body_lines:
        for fm in re.finditer(r"\[([KLM]):([^\]]*)\]", ln):
            f, v = fm.group(1), fm.group(2).strip()
            if headers.get(f, v) != v:
                raise AbcParseError(
                    f"inline {f}: change {headers[f]!r} -> {v!r}"
                )

    if "K" not in headers:
        raise AbcParseError("no key header")
    meter = headers.get("M", "4/4").strip()
    if meter in ("C", "c"):
        meter = "4/4"
    try:
        ts_num, ts_den = (int(v) for v in meter.split("/"))
    except Exception as e:
        raise AbcParseError(f"bad meter {meter!r}") from e
    if "L" in headers:
        ln, ld = (int(v) for v in headers["L"].split("/"))
        unit = Fraction(ln, ld)
    else:
        unit = Fraction(1, 8) if Fraction(ts_num, ts_den) >= Fraction(3, 4) \
            else Fraction(1, 16)
    key_acc = key_accidentals(headers["K"])

    body = " ".join(_strip_body_noise(l) for l in body_lines)

    # split into bars, remembering repeat marks per bar
    bar_tokens: List[Tuple[str, List[str]]] = []
    cur = []
    marks: List[str] = []
    i = 0
    while i < len(body):
        ch = body[i]
        if ch == "|" or ch == ":":
            two = body[i : i + 2]
            if two == "|:":
                bar_tokens.append(("".join(cur), marks))
                cur, marks = [], ["start_repeat"]
                i += 2
                continue
            if two == ":|":
                seg = "".join(cur)
                # look ahead for :|2
                j = i + 2
                while j < len(body) and body[j] in " ]":
                    j += 1
                if j < len(body) and body[j] == "2":
                    bar_tokens.append((seg, marks + ["end_repeat"]))
                    cur, marks = [], ["ending2"]
                    i = j + 1
                    continue
                bar_tokens.append((seg, marks + ["end_repeat"]))
                cur, marks = [], []
                i += 2
                continue
            if ch == "|":
                j = i + 1
                while j < len(body) and body[j] in " ]":
                    j += 1
                if j < len(body) and body[j] in "12":
                    bar_tokens.append(("".join(cur), marks))
                    cur, marks = [], [f"ending{body[j]}"]
                    i = j + 1
                    continue
                bar_tokens.append(("".join(cur), marks))
                cur, marks = [], []
                i += 1
                continue
        if ch == "[" and i + 1 < len(body) and body[i + 1] in "12":
            bar_tokens.append(("".join(cur), marks))
            cur, marks = [], [f"ending{body[i+1]}"]
            i += 2
            continue
        cur.append(ch)
        i += 1
    if "".join(cur).strip():
        bar_tokens.append(("".join(cur), marks))
    bar_tokens = [(b, m) for b, m in bar_tokens if b.strip() or m]

    bar_strs = _expand_repeats(bar_tokens)

    # parse bars to note events
    notes: List[Tuple[int, float, float]] = []
    t = Fraction(0)
    pending_tie = False  # ties cross barlines ('A- | A' is one held note)
    for bar in bar_strs:
        bar_acc: Dict[str, int] = {}  # accidentals persist within a bar
        j = 0
        tuplet_scale = Fraction(1)
        tuplet_left = 0
        while j < len(bar):
            ch = bar[j]
            if ch in " \t)":
                j += 1
                continue
            if ch == "(" and j + 1 < len(bar) and bar[j + 1].isdigit():
                p = int(bar[j + 1])
                tuplet_scale = Fraction({2: 3, 3: 2, 4: 3}.get(p, 2), p)
                tuplet_left = p
                j += 2
                continue
            if ch == "(":
                j += 1  # slur start — ignored
                continue
            if ch == "-":
                pending_tie = True
                j += 1
                continue
            if ch in "<>":
                # broken rhythm applies to previous/next pair; approximate
                # by leaving durations unchanged (keeps grid alignment)
                j += 1
                continue
            m = _NOTE_RE.match(bar, j)
            if not m or m.start() != j or not m.group("letter"):
                j += 1  # unknown symbol — skip
                continue
            j = m.end()
            length = Fraction(int(m.group("num") or 1))
            if m.group("slash"):
                den = int(m.group("den") or (2 ** len(m.group("slash"))))
                length = length / den
            elif m.group("den"):
                length = length / int(m.group("den"))
            dur = length * unit * 4  # quarter-note units
            if tuplet_left > 0:
                dur *= tuplet_scale
                tuplet_left -= 1
                if tuplet_left == 0:
                    tuplet_scale = Fraction(1)
            letter = m.group("letter")
            if letter in "zx":
                notes.append((-1, float(t), float(dur)))
                t += dur
                pending_tie = False
                continue
            octave = 5 if letter.islower() else 4
            octave += m.group("oct").count("'") - m.group("oct").count(",")
            upper = letter.upper()
            acc_str = m.group("acc")
            if acc_str:
                acc = acc_str.count("^") - acc_str.count("_")
                if "=" in acc_str:
                    acc = 0
                bar_acc[upper + str(octave)] = acc
            acc = bar_acc.get(
                upper + str(octave), key_acc.get(upper, 0)
            )
            midi = (octave + 1) * 12 + _LETTER_PC[upper] + acc
            if pending_tie and notes and notes[-1][0] == midi:
                p, s, d = notes[-1]
                notes[-1] = (p, s, d + float(dur))
            else:
                notes.append((midi, float(t), float(dur)))
            t += dur
            pending_tie = False
    return headers, Score(notes=notes)


def parse_abc_file(path: str) -> Tuple[Dict[str, str], Score]:
    with open(path, errors="ignore") as f:
        return parse_abc(f.read())


def is_valid_folk_tune(path: str, time_sig=(4, 4)) -> bool:
    """The reference's validity pipeline (bar_dataset.py:865-930):
    title present, single-voice, chord-free, single 4/4 meter, has
    notes, ≤ MAX_NOTES, notes on the tick grid."""
    try:
        if get_title(path) is None:
            return False
        if tune_is_multivoice(path) or tune_contains_chords(path):
            return False
        headers, score = parse_abc_file(path)
        meter = headers.get("M", "4/4")
        if meter in ("C", "c"):
            meter = "4/4"
        num, den = (int(v) for v in meter.split("/"))
        if (num, den) != time_sig:
            return False
        pitched = [n for n in score.notes if n[0] >= 0]
        if not pitched or len(score.notes) > MAX_NOTES:
            return False
        # tick-grid alignment (reference is_score_on_ticks)
        eps = 1e-5
        ticks = [float(v) for v in TICK_VALUES]
        for _, start, _ in score.notes:
            frac = start % 1.0
            if not any(abs(frac - tv) < eps for tv in ticks):
                return False
        return True
    except Exception:
        return False
