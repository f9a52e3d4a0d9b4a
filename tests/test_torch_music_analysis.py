"""The port's music analysis surface against the JAX package's: the MIDI
writer and reader, ``Score`` and its conversions, decoding from latent
codes, the frozen-decoder tester (``VAETester``, ``VAETesterGLSR``),
``discrete_mutual_info`` against scikit-learn, and the
``run_tester_sweep`` entry point.

The models run from the JAX trainer's own initial weights, converted by
``arvae_tpu_torch/utils/convert.py``, on the ``--short`` synthetic folk
corpus, cut to H=32, z=16 at the default dropout 0.5 (eval mode ignores
it). On the CPU the JAX decoders take their ``lax.scan`` route; one case
forces the hierarchical decoder through the Pallas tick-loop kernel in
interpret mode (``ARVAE_FORCE_GRU_PALLAS``, at H=128, a width the kernel
takes), as the JAX package's own tests run it. The tester's sampled
latents take the JAX tester's draws: the key of 1 (the harvest) or 2
(the test pass) folded with the batch index, split as ``MeasureVAE``
splits it.

Tolerances: MIDI files, token rows, notes and dataset bytes exactly;
the decoded tokens exactly (free-running argmax of logits that agree to
~1e-6, ``tests/test_torch_measure_vae.py``); the harvest's latents rtol /
atol 1e-5 and its attributes 1e-6 (``tests/test_torch_eval_slice.py``);
the interpretability dim exactly and its R² within 1e-6; the test loss
rtol 1e-4 and the accuracy 1e-6, as the eval slice holds the trainer's
test pass; ``discrete_mutual_info`` within 1e-12 of
``mutual_info_score``.
"""

import json
import os
import struct
import warnings

import jax
import numpy as np
import pytest
import torch
from sklearn.metrics import mutual_info_score

import arvae_tpu.utils.midi as jmidi
from arvae_tpu.data.bar_dataset import FolkNBarDataset as JaxFolk
from arvae_tpu.data.bar_dataset import onset_tick as jax_onset_tick
from arvae_tpu.data.bar_dataset import score_to_tick_codes as jax_tick_codes
from arvae_tpu.eval.tester import VAETester as JaxTester
from arvae_tpu.eval.tester import VAETesterGLSR as JaxTesterGLSR
from arvae_tpu.models.measure_vae import MeasureVAE as FlaxMeasureVAE
from arvae_tpu.ops.hier_decoder_pallas import enabled as jax_pallas_enabled
from arvae_tpu.parallel import create_mesh
from arvae_tpu.training.measure_trainer import MeasureVAETrainer as JaxMeasureTrainer
from arvae_tpu_torch import run_tester_sweep, train_measure_vae
from arvae_tpu_torch.data.bar_dataset import FolkNBarDataset, Score, onset_tick, \
    score_to_tick_codes
from arvae_tpu_torch.eval.metrics import discrete_mutual_info
from arvae_tpu_torch.eval.tester import TESTER_ATTRIBUTES, VAETester, VAETesterGLSR
from arvae_tpu_torch.models.measure_vae import MeasureNoise, MeasureVAE
from arvae_tpu_torch.training.glsr_trainer import MeasureVAETrainerGLSR
from arvae_tpu_torch.training.measure_trainer import MeasureVAETrainer
from arvae_tpu_torch.utils import midi
from arvae_tpu_torch.utils.convert import measure_vae_from_flax

H, Z = 32, 16
CPU = torch.device("cpu")


@pytest.fixture
def dirs(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # no folk_raw_data/ here
    monkeypatch.setenv("ARVAE_DATASETS_DIR", str(tmp_path / "datasets"))
    monkeypatch.setenv("ARVAE_MODELS_DIR", str(tmp_path / "models"))
    return tmp_path


@pytest.fixture
def corpus(dirs):
    ds = FolkNBarDataset(dataset_type="train", is_short=True, num_bars=1)
    ds.get_dataset()
    return ds


def _jax_corpus():
    return JaxFolk(dataset_type="train", is_short=True, num_bars=1)


def _trainers(corpus, h=H, **model_kw):
    """The JAX trainer and the port's, on the same initial weights."""
    widths = dict(num_notes=len(corpus.note2index_dicts), encoder_hidden_size=h,
                  decoder_hidden_size=h, latent_space_dim=Z, **model_kw)
    jtr = JaxMeasureTrainer(_jax_corpus(), FlaxMeasureVAE(**widths), reg_type=("all",),
                            reg_dim=(0, 1, 2, 3), rand=0,
                            mesh=create_mesh(jax.devices()[:1]))
    model = MeasureVAE(**widths)
    model.load_state_dict(measure_vae_from_flax(jtr.ensure_state().params))
    return jtr, MeasureVAETrainer(corpus, model, CPU, reg_type=("all",),
                                  reg_dim=(0, 1, 2, 3), rand=0)


# -- MIDI ---------------------------------------------------------------------------

NOTE_LISTS = {
    "scale": [(60, 0.0, 1.0), (62, 1.0, 0.5), (64, 1.5, 0.25), (65, 1.75, 2.25)],
    # a release and an onset at one tick, the same pitch and another
    "tie_at_one_tick": [(60, 0.0, 1.0), (60, 1.0, 1.0), (62, 2.0, 0.5), (60, 2.0, 0.5)],
    # rests and a zero duration write no event
    "rests_and_zero": [(-1, 0.0, 1.0), (67, 1.0, 0.0), (67, 1.0, 1.0 / 3), (-1, 4 / 3, 2 / 3)],
    # the tick grid's thirds and twelfths, rounded to 480 a quarter
    "grid": [(70, k / 12, 1 / 12) for k in range(30)] + [(72, 2.5 + 1 / 3, 1 / 6)],
    "random": [(int(p), float(s), float(d)) for p, s, d in zip(
        np.random.RandomState(0).randint(-1, 128, 40),
        np.random.RandomState(1).randint(0, 96, 40) / 12,
        np.random.RandomState(2).randint(0, 24, 40) / 12)],
}


@pytest.mark.parametrize("case", list(NOTE_LISTS))
def test_write_midi_bytes_are_jaxs(tmp_path, case):
    notes = NOTE_LISTS[case]
    jmidi.write_midi(notes, str(tmp_path / "jax.mid"))
    midi.write_midi(notes, str(tmp_path / "port" / "port.mid"))  # makes its directory
    got = (tmp_path / "port" / "port.mid").read_bytes()
    assert got == (tmp_path / "jax.mid").read_bytes()
    back = midi.read_midi(str(tmp_path / "port" / "port.mid"))
    assert back == jmidi.read_midi(str(tmp_path / "jax.mid"))
    if case != "random":  # no two notes of one pitch overlap: each reads back
        assert len(back) == sum(p >= 0 and d > 0 for p, _, d in notes)


def _smf(track: bytes) -> bytes:
    return (b"MThd" + struct.pack(">IHHH", 6, 0, 1, 480)
            + b"MTrk" + struct.pack(">I", len(track)) + track)


# the tracks of tests/test_midi.py: one-byte channel messages, and SysEx
TRACKS = {
    "one_byte_channel_messages": bytes(
        [0x00, 0xC0, 0x05] + [0x00, 0x90, 60, 90] + [0x00, 0xD0, 0x40]
        + [0x83, 0x60, 0x80, 60, 0] + [0x00, 0xFF, 0x2F, 0x00]),
    "sysex": bytes(
        [0x00, 0xF0, 0x03, 0x7E, 0x7F, 0xF7] + [0x00, 0x90, 60, 90]
        + [0x83, 0x60, 0xF7, 0x01, 0x00] + [0x00, 0x80, 60, 0] + [0x00, 0xFF, 0x2F, 0x00]),
}


@pytest.mark.parametrize("case", list(TRACKS))
def test_read_midi_skips_what_jax_skips(tmp_path, case):
    path = tmp_path / "t.mid"
    path.write_bytes(_smf(TRACKS[case]))
    assert midi.read_midi(str(path)) == jmidi.read_midi(str(path)) == [(60, 0.0, 1.0)]


@pytest.mark.parametrize("case", list(NOTE_LISTS) + ["empty"])
def test_pianoroll_is_jaxs(case):
    notes = NOTE_LISTS.get(case, [])
    got, want = midi.notes_to_pianoroll(notes), jmidi.notes_to_pianoroll(notes)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert got.shape == want.shape


# -- Score ----------------------------------------------------------------------------


def _token_rows(corpus, n=8):
    """Random token rows over the whole vocabulary and rows of the corpus."""
    v = len(corpus.note2index_dicts)
    rows = np.random.RandomState(3).randint(0, v, (n, 24))
    return np.concatenate([rows, corpus.get_dataset()[0][:n]]).astype(np.int64)


def test_score_conversions_match_jax(corpus, tmp_path):
    jds = _jax_corpus()
    rows = _token_rows(corpus)
    scores, jscores = [], []
    for row in rows:
        score, jscore = corpus.tensor_to_m21score(row), jds.tensor_to_m21score(row)
        assert isinstance(score, Score) and score.notes == jscore.notes
        assert score.highest_time == jscore.highest_time
        np.testing.assert_array_equal(corpus.score_to_tensor(score), jds.score_to_tensor(jscore))
        np.testing.assert_array_equal(score_to_tick_codes(score), jax_tick_codes(jscore))
        scores.append(score)
        jscores.append(jscore)
    # the rows as one tick stream, and the measures back to back
    assert corpus.tensor_to_m21score(rows).notes == jds.tensor_to_m21score(rows).notes
    assert (corpus.concatenate_scores(scores).notes
            == jds.concatenate_scores(jscores).notes)
    assert corpus.concatenate_scores([]).notes == []
    assert score_to_tick_codes(Score()) is None and corpus.score_to_tensor(Score()) is None
    np.testing.assert_array_equal(corpus.empty_score_tensor(24), jds.empty_score_tensor(24))
    for start in np.arange(0, 8, 1 / 24):
        assert onset_tick(start, 6) == jax_onset_tick(start, 6)
    # Score.write as music21 writes it: the JAX Score's bytes
    scores[1].write("midi", str(tmp_path / "port.mid"))
    jscores[1].write("midi", str(tmp_path / "jax.mid"))
    assert (tmp_path / "port.mid").read_bytes() == (tmp_path / "jax.mid").read_bytes()
    with pytest.raises(ValueError):
        scores[1].write("musicxml", str(tmp_path / "x.xml"))


# -- decoding latent codes ------------------------------------------------------------

DECODERS = {"hier": {}, "sr": {"decoder_type": "sr"},
            "sr-no-input": {"decoder_type": "sr-no-input"},
            "3-layer": {"num_decoder_layers": 3}}


@pytest.mark.parametrize("kind", list(DECODERS))
def test_decode_latent_codes_match_jax(corpus, kind):
    jtr, tr = _trainers(corpus, **DECODERS[kind])
    rng = np.random.RandomState(5)
    for b in (1, 6, 22):
        z = 2 * rng.randn(b, Z).astype(np.float32)
        jscore, jsamples = jtr.decode_latent_codes(z)
        score, samples = tr.decode_latent_codes(z)
        assert samples.dtype == np.int32 and samples.shape == (b, 24)
        np.testing.assert_array_equal(samples, np.asarray(jsamples))
        assert score.notes == jscore.notes
        assert len({tuple(r) for r in samples}) > (b > 1)  # the codes decode apart
    # the draws change no eval decode
    noise = tr.draw_eval_noise(22, torch.Generator().manual_seed(9))
    np.testing.assert_array_equal(tr.decode_latent_codes(z, noise)[1], samples)


def test_decode_matches_jax_pallas_interpret(corpus, monkeypatch):
    """The JAX decoder forced through its Pallas tick-loop kernel (interpret
    mode), at H=128 and the batches it takes (multiples of 8)."""
    monkeypatch.delenv("ARVAE_NO_GRU_PALLAS", raising=False)
    monkeypatch.setenv("ARVAE_FORCE_GRU_PALLAS", "1")
    jtr, tr = _trainers(corpus, h=128)
    v = len(corpus.note2index_dicts)
    rng = np.random.RandomState(6)
    for b in (8, 16):
        assert jax_pallas_enabled(b, 128, 2, v, 6, "argmax")
        z = 2 * rng.randn(b, Z).astype(np.float32)
        np.testing.assert_array_equal(tr.decode_latent_codes(z)[1],
                                      np.asarray(jtr.decode_latent_codes(z)[1]))


def test_latent_interpolations_match_jax(corpus):
    jtr, tr = _trainers(corpus)
    code = np.random.RandomState(7).randn(1, Z).astype(np.float32)
    original, _ = tr.decode_latent_codes(code)
    joriginal, _ = jtr.decode_latent_codes(code)
    score, tensors = tr.compute_latent_interpolations(code, original, dim1=3, num_points=5)
    jscore, jtensors = jtr.compute_latent_interpolations(code, joriginal, dim1=3,
                                                         num_points=5)
    assert tensors.shape == (5, 24)
    np.testing.assert_array_equal(tensors, np.asarray(jtensors))
    assert score.notes == jscore.notes and score.highest_time <= 20.0
    with pytest.raises(ValueError):
        tr.compute_latent_interpolations(code, original, num_points=4)


# -- the tester ---------------------------------------------------------------------


def _check_read_back(path, score):
    """read_midi gives back the score's notes: the pitches, and the times
    on the 480-a-quarter grid (within 1e-9 of the score's floats)."""
    want = [n for n in sorted(score.notes, key=lambda n: n[1]) if n[0] >= 0 and n[2] > 0]
    got = midi.read_midi(path)
    assert [n[0] for n in got] == [n[0] for n in want]
    np.testing.assert_allclose(np.array([n[1:] for n in got]).reshape(-1, 2),
                               np.array([n[1:] for n in want]).reshape(-1, 2),
                               rtol=0, atol=1e-9)


def _jax_tester_draws(key_seed, rows, count):
    """ε and ε_prior of each batch as the JAX tester draws them: the key of
    ``key_seed`` folded with the batch index, split as MeasureVAE splits it."""
    zero = torch.zeros(1, dtype=torch.int32)
    out = []
    for i in range(count):
        _, k_rep, k_prior, _ = jax.random.split(
            jax.random.fold_in(jax.random.key(key_seed), i), 4)
        eps, eps_prior = (torch.from_numpy(np.array(jax.random.normal(k, (rows, Z))))
                          for k in (k_rep, k_prior))
        out.append(MeasureNoise(eps, eps_prior, zero, zero))
    return out


def _testers(corpus, tmp_path):
    jtr, tr = _trainers(corpus)
    return (JaxTester(jtr, plots_dir=str(tmp_path / "jax")),
            VAETester(tr, plots_dir=str(tmp_path / "port")))


def test_the_test_split_is_jaxs(corpus, tmp_path):
    jt, t = _testers(corpus, tmp_path)
    _, _, gen = jt.dataset.data_loaders(batch_size=256, split=(0.01, 0.01))
    rows, steps = t.whole_batches(256)
    assert (rows, steps) == (256, len(gen))
    want = np.concatenate([jt.trainer.process_batch(b)[0] for b in gen])
    got = t.test_split().images[:steps * rows].numpy()
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert t.test_split().n > steps * rows  # the partial tail the tester leaves out
    assert t.whole_batches(8, 201) == (8, 201) and t.whole_batches(8)[1] > 201


@pytest.mark.parametrize("attr,batch_size", [(a, 256) for a in TESTER_ATTRIBUTES]
                         + [("rhy_complexity", 8)])
def test_interpretability_matches_jax(corpus, tmp_path, attr, batch_size):
    jt, t = _testers(corpus, tmp_path)
    rows, steps = t.whole_batches(batch_size, 201)
    noise = _jax_tester_draws(1, rows, steps)
    if batch_size == 8:  # the harvest itself, at the cap of 201 batches
        assert steps == 201
        _, _, gen = jt.dataset.data_loaders(batch_size=8, split=(0.01, 0.01))
        jz, jattr = jt._encode_batches(gen, attr, sample=True)
        z, attrs = t._encode_batches(8, attr, sample=True, noise=noise)
        assert z.shape == jz.shape == (201 * 8, Z)
        np.testing.assert_allclose(z, jz, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(attrs, jattr, rtol=1e-6, atol=1e-6)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # sklearn on float labels
        want = jt.test_interpretability(batch_size, attr)
    got = t.test_interpretability(batch_size, attr, noise=noise)
    assert got[0] == want[0] and 0 <= got[0] < Z
    assert got[1] == pytest.approx(want[1], abs=1e-6)


@pytest.mark.parametrize("batch_size", [256, 8])
def test_test_model_matches_jax(corpus, tmp_path, batch_size):
    jt, t = _testers(corpus, tmp_path)
    rows, steps = t.whole_batches(batch_size)
    want = jt.test_model(batch_size)
    got = t.test_model(batch_size, noise=_jax_tester_draws(2, rows, steps))
    assert got[0] == pytest.approx(want[0], rel=1e-4)
    assert got[1] == pytest.approx(want[1], abs=1e-6)


def test_midi_files_are_the_jax_bytes(corpus, tmp_path):
    jt, t = _testers(corpus, tmp_path)
    rng = np.random.RandomState(8)
    z1, z2 = rng.randn(1, Z).astype(np.float32), rng.randn(1, Z).astype(np.float32)
    tokens = t.decode_mid_point(z1, z2, 8)
    assert tokens.shape == (1, 10 * 24)
    np.testing.assert_array_equal(tokens, jt.decode_mid_point(z1, z2, 8))
    jt.test_attr_reg_interpolations(num_points=3, dim=1, num_interps=4)
    written = t.test_attr_reg_interpolations(num_points=3, dim=1, num_interps=4)
    assert [os.path.basename(p) for p in written] == [f"attr_interp_d1_{i}.mid"
                                                      for i in range(3)]
    for path, score in written.items():
        with open(path, "rb") as fh:
            assert fh.read() == (tmp_path / "jax" / os.path.basename(path)).read_bytes()
        _check_read_back(path, score)
    for _ in range(2):  # the picks' Random(0) moves on between calls
        score, jscore = t.test_interp(n=4), jt.test_interp(n=4)
        assert score.notes == jscore.notes
        assert ((tmp_path / "port" / "interp_two_point.mid").read_bytes()
                == (tmp_path / "jax" / "interp_two_point.mid").read_bytes())


LABELS = {
    "integer": (np.random.RandomState(0).randint(0, 7, 500),
                np.random.RandomState(1).randint(0, 20, 500)),
    # float32 attribute values with ties, as the tester's labels
    "float_tied": (np.random.RandomState(2).randint(0, 20, 500),
                   (np.random.RandomState(3).randint(0, 9, 500) / 7).astype(np.float32)),
    "float_distinct": (np.random.RandomState(4).randint(0, 5, 300),
                       np.random.RandomState(5).randn(300)),
    "one_category": (np.zeros(50, np.int64), np.random.RandomState(6).randint(0, 3, 50)),
}


@pytest.mark.parametrize("case", list(LABELS))
def test_discrete_mutual_info_is_sklearns(case):
    a, b = LABELS[case]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = mutual_info_score(a, b)
    assert discrete_mutual_info(a, b) == pytest.approx(want, abs=1e-12)
    assert discrete_mutual_info(b, a) == pytest.approx(want, abs=1e-12)


# -- VAETesterGLSR ----------------------------------------------------------------------


def _glsr_model(corpus, seed=0):
    return MeasureVAE(num_notes=len(corpus.note2index_dicts), encoder_hidden_size=H,
                      decoder_hidden_size=H, latent_space_dim=Z, seed=seed)


def test_glsr_tester_restores_the_trained_checkpoint(corpus, tmp_path):
    tr = MeasureVAETrainerGLSR(corpus, _glsr_model(corpus), CPU, reg_type="rhy_complexity",
                               reg_dim=0, rand=0)
    tr.train_model(batch_size=256, num_epochs=1)
    trained = {k: v.clone() for k, v in tr.model.state_dict().items()}
    tester = VAETesterGLSR(corpus, _glsr_model(corpus, seed=5), CPU,
                           reg_type="rhy_complexity", reg_dim=0, rand=0,
                           plots_dir=str(tmp_path / "plots"))
    assert tester.trainer.model_repr().endswith("GLSR")
    assert tester.trainer.run_dir == tr.run_dir and tester.trainer.step == tr.step > 0
    restored = tester.trainer.model.state_dict()
    assert all(torch.equal(restored[k], v) for k, v in trained.items())
    dim, score = tester.test_interpretability(32, "rhy_complexity")
    assert 0 <= dim < Z and np.isfinite(score)


def test_glsr_tester_gamma_selects_the_run_dir(corpus, tmp_path):
    tester = VAETesterGLSR(corpus, _glsr_model(corpus), CPU, reg_type="rhy_complexity",
                           reg_dim=0, gamma=1e-3, rand=0, plots_dir=str(tmp_path / "plots"),
                           load=False)
    name = tester.trainer.model_repr()
    assert "_g_0.001_" in name and name.endswith("GLSR")
    assert tester.trainer.run_dir == str(tmp_path / "models" / "torch" / name)
    jax_model = FlaxMeasureVAE(num_notes=len(corpus.note2index_dicts),
                               encoder_hidden_size=H, decoder_hidden_size=H,
                               latent_space_dim=Z)
    jtester = JaxTesterGLSR(_jax_corpus(), jax_model, reg_type="rhy_complexity", reg_dim=0,
                            gamma=1e-3, rand=0, plots_dir=str(tmp_path / "jplots"),
                            load=False)
    assert jtester.trainer.model_repr() == name
    assert jtester.trainer.run_dir != tester.trainer.run_dir


# -- the entry point --------------------------------------------------------------------

FLAGS = ["--device", "cpu", "--short", "--rand", "0", "--encoder_hidden_size", str(H),
         "--decoder_hidden_size", str(H), "--latent_space_dim", str(Z)]


@pytest.mark.parametrize("reg", [["-r", "all"], ["--glsr", "-r", "rhy_complexity"]],
                         ids=["ar", "glsr"])
def test_run_tester_sweep_on_a_trained_run(corpus, dirs, capsys, reg):
    (trainer,) = train_measure_vae.main(FLAGS + reg + ["--num_epochs", "1",
                                                       "--batch_size", "256"])
    capsys.readouterr()
    out = str(dirs / "out")
    tester, result, written = run_tester_sweep.main(FLAGS + reg + ["--out", out])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(result))
    assert result["run_dir"] == trainer.run_dir and result["device"] == "cpu"
    assert tester.trainer.step == trainer.step  # the run's checkpoint
    dims = (0, 1, 2, 3) if reg[0] == "-r" else (0,)
    assert list(result["interpretability"]) == list(TESTER_ATTRIBUTES)
    assert all(0 <= d < Z and np.isfinite(r2) for d, r2 in result["interpretability"].values())
    assert np.isfinite(result["test_loss"]) and 0 <= result["test_acc"] <= 1
    assert result["files"] == list(written) and len(written) == 1 + 8 * len(dims)
    assert os.path.basename(result["files"][0]) == "interp_two_point.mid"
    for path, score in written.items():
        assert os.path.dirname(path) == out
        _check_read_back(path, score)


def test_run_tester_sweep_asks_for_the_card(corpus):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="--device cpu"):
        run_tester_sweep.main(["--short"])
