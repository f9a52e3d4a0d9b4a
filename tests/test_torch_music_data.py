"""The port's music data against the JAX package's: constants and pitch
names, the synthetic corpora byte for byte (vocab file, token rows, the
(0.70, 0.20) device split) and the attribute labels (atol 1e-6: both
sides compute them in float32 from the same integer tables)."""

import numpy as np
import pytest
import torch

from arvae_tpu.data import bar_dataset as jax_bars
from arvae_tpu.data import music_theory as jax_theory
from arvae_tpu.data.attributes import MusicAttributes as JaxAttributes
from arvae_tpu.parallel import create_mesh
from arvae_tpu_torch.data import bar_dataset, music_theory
from arvae_tpu_torch.data.attributes import MUSIC_REG_TYPE, MusicAttributes

ALL_ATTRS = ["rhy_complexity", "pitch_range", "note_density", "contour",
             "beat_strength", "rhythmic_entropy"]


def test_music_theory_constants_and_names_match():
    for name in ("MAX_NOTES", "SLUR_SYMBOL", "START_SYMBOL", "END_SYMBOL",
                 "REST_SYMBOL", "TICK_VALUES", "BEAT_SUBDIVISIONS",
                 "TICKS_PER_MEASURE", "TICK_DURATIONS"):
        assert getattr(music_theory, name) == getattr(jax_theory, name), name
    for name in ("RHY_COMPLEXITY_COEFFS", "BEAT_STRENGTH_WEIGHTS"):
        got, want = getattr(music_theory, name), getattr(jax_theory, name)
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    for m in range(0, 128):
        assert music_theory.midi_to_note_name(m) == jax_theory.midi_to_note_name(m)
    for name in ("C4", "F#5", "B-3", "E--2", "c#4", "rest", "__", "START", "END",
                 "X4", "C", "G#x", None):
        assert music_theory.note_name_to_midi(name) == jax_theory.note_name_to_midi(name)


@pytest.mark.parametrize("kind", ["folk", "bach"])
def test_short_corpus_is_byte_identical(tmp_path, monkeypatch, kind):
    port_cls = {"folk": bar_dataset.FolkNBarDataset,
                "bach": bar_dataset.ChoraleNBarDataset}[kind]
    jax_cls = {"folk": jax_bars.FolkNBarDataset,
               "bach": jax_bars.ChoraleNBarDataset}[kind]
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    monkeypatch.chdir(tmp_path)  # no folk_raw_data/ here
    monkeypatch.setenv("ARVAE_DATASETS_DIR", str(tmp_path / "port"))
    port = port_cls(dataset_type="train", is_short=True, num_bars=1)
    p_score, p_meta = port.get_dataset()
    monkeypatch.setenv("ARVAE_DATASETS_DIR", str(tmp_path / "jax"))
    ref = jax_cls(dataset_type="train", is_short=True, num_bars=1)
    j_score, _ = ref.get_dataset()

    assert (tmp_path / "port" / "4by4_{}_index_dicts.txt".format(port.style)).read_bytes() \
        == (tmp_path / "jax" / "4by4_{}_index_dicts.txt".format(ref.style)).read_bytes()
    assert port.class_name == ref.class_name
    assert port.dataset_path.replace(str(tmp_path / "port"), "") \
        == ref.dataset_path.replace(str(tmp_path / "jax"), "")
    assert p_score.dtype == j_score.dtype and np.array_equal(p_score, j_score)
    assert np.array_equal(p_meta, p_score)

    ctx = create_mesh()
    for p_split, j_split in zip(port.device_splits(torch.device("cpu")),
                                ref.device_splits(ctx, split=(0.70, 0.20))):
        assert p_split.n == j_split.n
        rows = np.asarray(j_split.images)[: j_split.n]
        assert np.array_equal(p_split.images.numpy(), rows)
        score, labels = p_split.gather_batch(torch.arange(4))
        assert score is labels and np.array_equal(score.numpy(), rows[:4])


def test_abc_corpus_is_refused(tmp_path, monkeypatch):
    """A folk_raw_data/ whose .abc files hold no valid tune is ingested
    (not replaced by the synthetic corpus) and refused: no rows."""
    monkeypatch.setenv("ARVAE_DATASETS_DIR", str(tmp_path / "ds"))
    raw = tmp_path / "folk_raw_data"
    raw.mkdir()
    (raw / "tune.abc").write_text("X:1\n")
    ds = bar_dataset.FolkNBarDataset(is_short=True, num_bars=1, raw_datapath=str(raw))
    assert ds._abc_files() == [str(raw / "tune.abc")] and ds._corpus_all_tunes() == []
    with pytest.raises(ValueError, match="corpus produced no 'train' windows"):
        ds.get_dataset()


def _rows():
    vocab = {0: "__", 1: "START", 2: "END", 3: "rest", 4: "C4", 5: "E4",
             6: "G4", 7: "C5", 8: "F#4", 9: "B-3"}
    rng = np.random.RandomState(0)
    rows = [rng.randint(0, 10, (16, 24))]
    edge = np.zeros((6, 24), np.int64)            # all slur
    edge[1, 5] = 4                                # one note
    edge[2, [0, 23]] = [7, 9]                     # two notes, first and last tick
    edge[3] = rng.randint(0, 4, 24)               # specials only
    edge[4, [2, 9]] = [12, -3]                    # out of range ids
    edge[5, [1, 4, 8]] = [-11, 5, 40]             # more out of range ids
    rows.append(edge)
    return vocab, np.concatenate(rows).astype(np.int32)


@pytest.mark.parametrize("attr_list", [None, ALL_ATTRS], ids=["training", "all"])
def test_compute_labels_matches_jax(attr_list):
    vocab, rows = _rows()
    got = MusicAttributes(vocab).compute_labels(torch.from_numpy(rows), attr_list)
    want = np.asarray(JaxAttributes(vocab).compute_labels(rows, attr_list))
    assert got.shape == want.shape == (len(rows), len(attr_list or MUSIC_REG_TYPE))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
