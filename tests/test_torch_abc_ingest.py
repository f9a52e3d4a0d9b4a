"""The port's ``.abc`` ingest against the JAX package's: the ABC parser
(``arvae_tpu_torch/data/abc_parser.py``) on the fixture tunes of
``tests/test_abc_parser.py``, written again here, and the datasets built
from a ``folk_raw_data/`` directory.

Each fixture text gives the port the JAX parser's headers and notes and
its validity verdict. Then the corpus ``chip_smoke.py``'s slice 8 trains
on (``torch_card_cases.write_abc_corpus``), in a temporary ``folk_raw_data/``: 31 valid
tunes (26 generated from a seed with numpy, 4 fixtures and one below the
transposition range, which grows the vocabulary; with repeats, endings,
ties, triplets, accidentals and several keys), 5 invalid ones (chords, a
6/8 meter, no title, a second voice, a mid-tune meter change) and a
README, goes through both packages in the same order, each in a
datasets root of its own: a vocabulary seeded from a narrow-range
subset, the ``--short`` train split (20 files after the seed-0 shuffle,
the valid list cached in full), one valid file then made unparseable
(both skip it), then ``FolkBarDataset`` and ``FolkNBarDataset`` (1 and 2
bars) train and test splits at full size. The ``.npz`` rows, the
vocabulary file after its growth and ``4by4valid_filelist.txt`` must be
byte for byte equal. Everything compares exactly: there is no float
arithmetic past the parser's fractions.
"""

import os
import shutil

import numpy as np
import pytest

import arvae_tpu.data.abc_parser as jabc
from arvae_tpu.data.bar_dataset import FolkBarDataset as JaxFolkBar
from arvae_tpu.data.bar_dataset import FolkNBarDataset as JaxFolkNBar
from arvae_tpu_torch.data import abc_parser as abc
from arvae_tpu_torch.data.bar_dataset import FolkBarDataset, FolkNBarDataset, Score
from torch_card_cases import write_abc_corpus

SIMPLE = """X:1
T:Test Tune
M:4/4
L:1/4
K:C
CDEF|GABc|
"""

DMAJOR = """X:2
T:D Major Scale
M:4/4
L:1/8
K:D
DEFG ABcd|
"""

REPEAT = """X:3
T:Repeated
M:4/4
L:1/4
K:C
|:CDEF:|
"""

ENDINGS = """X:4
T:Endings
M:4/4
L:1/4
K:C
|:CDEF|1GGGG:|2AAAA|
"""

RHYTHM = """X:5
T:Rhythms
M:4/4
L:1/8
K:C
C2D2 E/2F/2E/2F/2 G4|
"""

TRIPLET = """X:6
T:Triplets
M:4/4
L:1/8
K:C
(3CDE (3CDE C2C2 z4|
"""

ACCIDENTALS = """X:7
T:Accidentals
M:4/4
L:1/4
K:C
^CF=FC|FCFC|
"""

# the fixtures of tests/test_abc_parser.py, and the variants its tests write
TEXTS = {
    "simple": SIMPLE, "dmajor": DMAJOR, "repeat": REPEAT, "endings": ENDINGS,
    "rhythm": RHYTHM, "triplet": TRIPLET, "accidentals": ACCIDENTALS,
    "implicit_repeat": SIMPLE.replace("CDEF|GABc|", "CDEF|GABc:|"),
    "first_ending_only": SIMPLE.replace("CDEF|GABc|", "|:CDEF|1GGGG:|AAAA|"),
    "tie_across_bar": SIMPLE.replace("CDEF|GABc|", "CDEE-|EGGc|"),
    "lyrics_and_parts": SIMPLE.replace("CDEF|GABc|", "P:A\nCDEF|GABc|\nw:as I roved out\n"),
    "mid_tune_meter": SIMPLE.replace("CDEF|GABc|", "CDEF|\nM:6/8\nGAB|"),
    "bracket_chord": SIMPLE.replace("CDEF", "[CEG]F"),
    "bracket_in_title": SIMPLE.replace("T:Test Tune", "T:[Air] Test Tune"),
    "quoted_chord": SIMPLE.replace("CDEF", '"C"CDEF'),
    "six_eight": SIMPLE.replace("M:4/4", "M:6/8"),
    "second_voice": SIMPLE + "V:2\nCCCC|\n",
    "no_title": SIMPLE.replace("T:Test Tune\n", ""),
    "inline_key": SIMPLE.replace("CDEF|", "CDEF|[K:C]"),
    "inline_key_change": SIMPLE.replace("CDEF|", "CDEF|[K:G]"),
    "common_time_no_unit": SIMPLE.replace("M:4/4", "M:C").replace("L:1/4\n", ""),
    "no_key": SIMPLE.replace("K:C\n", ""),
}
# the verdicts tests/test_abc_parser.py asserts
VALID = {"simple": True, "mid_tune_meter": False, "bracket_chord": False,
         "bracket_in_title": True, "quoted_chord": False, "six_eight": False,
         "second_voice": False, "no_title": False}


def _parse(module, text):
    """(headers, notes) or the parse error's class name."""
    try:
        headers, score = module.parse_abc(text)
    except module.AbcParseError:
        return "AbcParseError"
    return headers, score.notes


@pytest.mark.parametrize("name", list(TEXTS))
def test_parse_abc_is_jaxs(name):
    got, want = _parse(abc, TEXTS[name]), _parse(jabc, TEXTS[name])
    assert got == want
    if name in ("mid_tune_meter", "inline_key_change", "no_key"):
        assert got == "AbcParseError"
    else:
        assert isinstance(abc.parse_abc(TEXTS[name])[1], Score) and got[1]


@pytest.mark.parametrize("name", list(TEXTS))
def test_validity_verdict_is_jaxs(tmp_path, name):
    path = tmp_path / f"{name}.abc"
    path.write_text(TEXTS[name])
    got = abc.is_valid_folk_tune(str(path))
    assert got == jabc.is_valid_folk_tune(str(path))
    assert got == VALID.get(name, got)
    assert abc.get_title(str(path)) == jabc.get_title(str(path))


@pytest.mark.parametrize("key", ["C", "G", "D", "F", "Eb", "Bb", "Ador", "Em", "Amin", "Dmix",
                                 "Bm", "F#m", "Gdor", "Elyd", "Bloc", "Aphr"])
def test_key_accidentals_are_jaxs(key):
    assert abc.key_accidentals(key) == jabc.key_accidentals(key)


# -- the corpus ------------------------------------------------------------------------


def _write_corpus(raw):
    """The corpus of chip_smoke.py's slice 8 in ``raw``, and a narrow-range
    subset of 3 tunes in ``raw``_narrow for the seed vocabulary."""
    return write_abc_corpus(raw, raw + "_narrow")


def _vocab_text(datasets_root):
    with open(os.path.join(datasets_root, "4by4_folk_index_dicts.txt")) as fh:
        return fh.read()


def _build(datasets_root, raw, monkeypatch, bar_cls, nbar_cls, phase):
    """One package's datasets, in the test's order → {name: rows}; the
    short phase also gives the seeded vocabulary file's text."""
    monkeypatch.setenv("ARVAE_DATASETS_DIR", datasets_root)
    if phase == "short":
        bar_cls(dataset_type="train", is_short=True, raw_datapath=raw + "_narrow")
        os.remove(os.path.join(datasets_root, "4by4valid_filelist.txt"))  # the subset's
        seeded = _vocab_text(datasets_root)
        return {"bar_train_short": bar_cls(dataset_type="train", is_short=True,
                                           raw_datapath=raw).get_dataset()[0]}, seeded
    rows = {}
    for split in ("train", "test"):
        rows[f"bar_{split}"] = bar_cls(dataset_type=split, raw_datapath=raw).get_dataset()[0]
        for n in (1, 2):
            rows[f"nbar{n}_{split}"] = nbar_cls(dataset_type=split, num_bars=n,
                                                raw_datapath=raw).get_dataset()[0]
    return rows


@pytest.fixture
def raw_corpus(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    raw = str(tmp_path / "folk_raw_data")
    return tmp_path, raw, _write_corpus(raw)


def test_folk_datasets_from_abc_files_are_jaxs(raw_corpus, monkeypatch):
    tmp_path, raw, n_valid = raw_corpus
    roots = {"jax": str(tmp_path / "jax_datasets"), "port": str(tmp_path / "port_datasets")}
    classes = {"jax": (JaxFolkBar, JaxFolkNBar), "port": (FolkBarDataset, FolkNBarDataset)}
    valid = [f for f in sorted(os.listdir(raw))
             if f.endswith(".abc") and jabc.is_valid_folk_tune(os.path.join(raw, f))]
    assert len(valid) == n_valid >= 24 and not any(f.startswith("invalid_") for f in valid)
    assert len(os.listdir(raw)) - 1 - len(valid) >= 2  # invalid tunes, and a README
    rows, seeded = {}, {}
    for k in roots:
        rows[k], seeded[k] = _build(roots[k], raw, monkeypatch, *classes[k], "short")
    # one listed file no longer parses: both packages skip it
    bad = os.path.join(raw, valid[5])
    with open(bad) as fh:
        text = fh.read()
    with open(bad, "w") as fh:
        fh.write(text.replace("\nK:", "\nK:H"))
    for k in roots:
        rows[k].update(_build(roots[k], raw, monkeypatch, *classes[k], "full"))

    for name, want in rows["jax"].items():
        got = rows["port"][name]
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert got.tobytes() == want.tobytes(), name
        assert len(got), name
    for f in os.listdir(roots["jax"]):
        with open(os.path.join(roots["jax"], f), "rb") as a, \
                open(os.path.join(roots["port"], f), "rb") as b:
            assert a.read() == b.read(), f
    assert sorted(os.listdir(roots["jax"])) == sorted(os.listdir(roots["port"]))
    # the cache holds the full valid list, whichever run built it
    with open(os.path.join(roots["port"], "4by4valid_filelist.txt")) as fh:
        assert fh.read().split() == valid
    # the vocabulary grew past the narrow subset's, as the JAX one grew
    grown = _vocab_text(roots["port"])
    assert seeded["port"] == seeded["jax"] and len(grown) > len(seeded["port"])
    assert "'C3'" in grown and "'C3'" not in seeded["port"]
    # --short takes 20 files, the full corpus every parseable one
    port = FolkBarDataset(dataset_type="train", raw_datapath=raw)
    assert len(port._corpus_all_tunes()) == len(valid) - 1
    short = FolkBarDataset(dataset_type="train", is_short=True, raw_datapath=raw)
    assert short.max_num_files == 20 and len(short._corpus_all_tunes()) <= 20


def test_a_directory_without_abc_files_keeps_the_synthetic_corpus(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("ARVAE_DATASETS_DIR", str(tmp_path / "datasets"))
    (tmp_path / "folk_raw_data").mkdir()
    (tmp_path / "folk_raw_data" / "notes.txt").write_text("no tunes here\n")
    ds = FolkBarDataset(dataset_type="train", is_short=True)
    assert ds._abc_files() == [] and len(ds._corpus_all_tunes()) == ds.n_tunes_short
    jds = JaxFolkBar(dataset_type="train", is_short=True)
    assert ds.get_dataset()[0].tobytes() == jds.get_dataset()[0].tobytes()
    assert not (tmp_path / "datasets" / "4by4valid_filelist.txt").exists()


def test_parse_failures_and_the_cap_follow_the_shuffle(raw_corpus, monkeypatch):
    """The seed-0 permutation of the cached list, then the cap, then the
    parse: the --short tunes are the JAX package's, in its order."""
    tmp_path, raw, _ = raw_corpus
    monkeypatch.setenv("ARVAE_DATASETS_DIR", str(tmp_path / "datasets"))
    port = FolkBarDataset(dataset_type="train", is_short=True, raw_datapath=raw)
    shutil.rmtree(tmp_path / "datasets")  # the JAX dataset builds its own cache
    jax_ds = JaxFolkBar(dataset_type="train", is_short=True, raw_datapath=raw)
    got, want = port._corpus_all_tunes(), jax_ds._corpus_all_tunes()
    assert len(got) == len(want) == 20
    assert all(a.tobytes() == b.tobytes() for a, b in zip(got, want))
