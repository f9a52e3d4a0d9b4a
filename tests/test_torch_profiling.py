"""The port's ``utils/profiling.py`` against the JAX package's:
``StepTimer`` reads the same clock the same way (``time.perf_counter``
patched to a clock the test sets, so both meters see the same times;
the rates must be equal, NaN where JAX's is NaN), and ``trace`` writes a
Chrome trace of the enclosed work on the CPU. Then the port's own spans,
which the JAX package has not: off they record nothing; on they keep
names, nesting, steps, threads and failures; and a training step through
the epoch runner opens the documented tree. (Reading a profiler trace
against the spans is the benchmark's: ``port_bench/tests/test_spans.py``.)"""

import glob
import json
import math
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from arvae_tpu.utils.profiling import StepTimer as JaxStepTimer
from arvae_tpu_torch.data.attributes import MusicAttributes
from arvae_tpu_torch.data.device_data import DeviceEpochRunner, DeviceSplit
from arvae_tpu_torch.models.image_vae import DspritesVAE
from arvae_tpu_torch.models.measure_vae import MeasureVAE
from arvae_tpu_torch.training.glsr_trainer import MeasureVAETrainerGLSR
from arvae_tpu_torch.training.image_trainer import ImageVAETrainer
from arvae_tpu_torch.training.measure_trainer import MeasureVAETrainer
from arvae_tpu_torch.utils import profiling
from arvae_tpu_torch.utils.profiling import StepTimer, assert_tensors_finite, trace


class _Clock:
    def __init__(self, t):
        self.t = t

    def __call__(self):
        return self.t


@pytest.mark.parametrize("warmup", [0, 2])
def test_step_timer_matches_jax(monkeypatch, warmup):
    clock = _Clock(100.0)
    monkeypatch.setattr(time, "perf_counter", clock)
    port, jax_timer = StepTimer(warmup=warmup), JaxStepTimer(warmup=warmup)
    gaps = np.random.RandomState(warmup).uniform(0.01, 0.5, 7)
    start = clock.t  # when the warmup ends: construction for 0
    for n, gap in enumerate(gaps, start=1):
        clock.t += gap
        port.tick()
        jax_timer.tick()
        if n == warmup:
            start = clock.t
        clock.t += 0.125  # the meter is read a while after the tick
        got, want = port.steps_per_sec, jax_timer.steps_per_sec
        if n <= warmup:
            assert math.isnan(got) and math.isnan(want)
            continue
        assert got == want
        # the steps after the warmup over the time since it ended
        assert got == pytest.approx((n - warmup) / (clock.t - start), rel=1e-12)


def test_step_timer_is_nan_before_any_tick():
    assert math.isnan(StepTimer(warmup=0).steps_per_sec)
    assert math.isnan(StepTimer(warmup=2).steps_per_sec)


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    log_dir = str(tmp_path / "trace")
    a, b = torch.randn(32, 48), torch.randn(48, 16)
    with trace(log_dir) as prof:
        c = a @ b
    np.testing.assert_allclose(c.numpy(), a.numpy() @ b.numpy(), rtol=1e-5, atol=1e-5)
    (path,) = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::mm" in names or "aten::matmul" in names
    assert any(e.key in ("aten::mm", "aten::matmul") for e in prof.key_averages())


def test_assert_tensors_finite_names_the_bad_tensor():
    assert_tensors_finite({"w": torch.ones(3), "steps": torch.tensor([1, 2])})
    with pytest.raises(ValueError, match=r"\['b'\]"):
        assert_tensors_finite({"a": torch.ones(2), "b": torch.tensor([1.0, float("nan")])})


# -- spans -------------------------------------------------------------------


def _tree(records, parent=None):
    """The records as nested (name, children) tuples under ``parent``."""
    return tuple((r.name, _tree(records, i)) for i, r in enumerate(records)
                 if r.parent == parent)


def test_spans_off_record_nothing_and_share_one_no_op():
    assert profiling.active() is None
    off = profiling.span("step")
    assert off is profiling.span("gather")
    with off as entered:
        assert entered is None

    @profiling.spanned("op:x")
    def double(v):
        return 2 * v

    assert double(4) == 8 and double.__name__ == "double"
    with profiling.recording() as rec:
        pass
    assert rec.records() == []


def test_spans_keep_names_nesting_steps_and_failures():
    @profiling.spanned("op:k.fwd")
    def op():
        return 1

    with profiling.recording() as rec:
        with profiling.span("shuffle"):
            pass
        for i in range(2):
            with pytest.raises(KeyError) if i else _nothing():
                with profiling.span("step"):
                    with profiling.span("train_step"):
                        op()
                        if i:
                            raise KeyError("stop")
    assert profiling.active() is None
    recs = rec.records()
    assert _tree(recs) == (("shuffle", ()),
                           ("step", (("train_step", (("op:k.fwd", ()),)),)),
                           ("step", (("train_step", (("op:k.fwd", ()),)),)))
    assert [r.step for r in recs] == [-1, 0, 0, 0, 1, 1, 1]
    assert [r.failed for r in recs] == [False] * 4 + [True, True, False]
    assert all(r.start <= r.end for r in recs)
    assert all(r.tid == threading.get_native_id() == rec.main_tid for r in recs)
    step, inner = recs[1], recs[3]
    assert step.start <= inner.start <= inner.end <= step.end


class _nothing:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


def test_a_span_on_another_thread_nests_under_the_main_threads_open_span():
    """As autograd's device thread runs a CUDA backward: its spans nest
    under the main thread's ``backward``, in the main thread's step."""
    seen = {}

    def worker():
        with profiling.span("op:k.bwd"):
            seen["tid"] = threading.get_native_id()
        with profiling.span("op:k.bwd"):
            pass

    with profiling.recording() as rec:
        with profiling.span("step"), profiling.span("backward"):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
        assert not t.is_alive()
        with profiling.span("accumulate"):
            pass
    recs = rec.records()
    assert [(r.name, r.parent, r.step) for r in recs] == [
        ("step", None, 0), ("backward", 0, 0), ("op:k.bwd", 1, 0), ("op:k.bwd", 1, 0),
        ("accumulate", None, -1)]
    assert recs[2].tid == seen["tid"] != rec.main_tid
    assert rec.threads[seen["tid"]] != rec.threads[rec.main_tid]


def test_recording_does_not_nest_and_ends_on_an_exception():
    with pytest.raises(ValueError):
        with profiling.recording():
            with pytest.raises(RuntimeError, match="already"):
                with profiling.recording():
                    pass
            raise ValueError
    assert profiling.active() is None
    assert profiling.span("x") is profiling.span("y")


def test_spans_from_many_threads_are_all_kept():
    """More threads than cores opening spans under the main thread's
    open span, with a short switch interval: no span is lost and each
    names the right parent."""
    threads, per = 4 * (os.cpu_count() or 1) + 2, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording() as rec:
            with profiling.span("step"), profiling.span("backward"):
                def worker():
                    for _ in range(per):
                        with profiling.span("op:a"):
                            with profiling.span("op:b"):
                                pass
                pool = [threading.Thread(target=worker) for _ in range(threads)]
                for t in pool:
                    t.start()
                for t in pool:
                    t.join(timeout=120)
                assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)
    recs = rec.records()
    assert len(recs) == 2 + 2 * threads * per
    for r in recs[2:]:
        want = ("backward", rec.main_tid) if r.name == "op:a" else ("op:a", r.tid)
        assert (recs[r.parent].name, recs[r.parent].tid) == want
        assert r.step == 0 and r.end is not None


class _Corpus:
    """What the music trainer reads of a dataset: measures of tokens."""

    class_name = "4by4_FolkNBarDataset_1_"
    beat_subdivisions, time_sig_num, time_sig_den = 6, 4, 4

    def __init__(self, rows):
        names = ["__", "START", "END", "rest"] + [f"{p}4" for p in "CDEFGAB"]
        self.rows = rows
        self.index2note_dicts = dict(enumerate(names))
        self.note2index_dicts = {v: k for k, v in self.index2note_dicts.items()}

    def get_dataset(self):
        return self.rows, self.rows

    def attrs(self, device):
        return MusicAttributes(self.index2note_dicts, device)


def _runner(family):
    """A tiny trainer of ``family`` and an epoch runner of two steps of 4 rows."""
    torch.manual_seed(0)
    rng = np.random.RandomState(0)
    cpu = torch.device("cpu")
    if family == "dsprites":
        trainer = ImageVAETrainer(None, DspritesVAE(), cpu, reg_type=("all",),
                                  reg_dim=(0, 1, 2, 3, 4), rand=0)
        rows = rng.randint(0, 256, (8, 512)).astype(np.uint8)
        labels = rng.uniform(0, 1, (8, 6)).astype(np.float32)
        split = DeviceSplit(rows, labels, (1, 64, 64), "packed", cpu)
    else:
        rows = rng.randint(3, 11, (8, 24)).astype(np.int64)
        corpus = _Corpus(rows)
        model = MeasureVAE(11, note_embedding_dim=4, encoder_hidden_size=8,
                           latent_space_dim=4, decoder_hidden_size=8)
        if family == "glsr":
            trainer = MeasureVAETrainerGLSR(corpus, model, cpu, reg_type="rhy_complexity",
                                            rand=0)
        else:
            trainer = MeasureVAETrainer(corpus, model, cpu, reg_type=("all",),
                                        reg_dim=(0, 1, 2, 3), rand=0)
        split = DeviceSplit(rows, None, (24,), "tokens", cpu)
    return DeviceEpochRunner(split, split, 4, trainer.train_step, trainer.eval_step,
                             trainer.perm_generator)


@pytest.mark.parametrize("family", ["dsprites", "music", "glsr"])
def test_a_training_step_opens_the_documented_span_tree(family):
    """The epoch's shuffle, then each step: gather, the train step
    (forward, loss, zero_grad, backward, Adam), accumulate; the music
    loss computes the labels (GLSR's has none to compute). No ``op:``
    span on the CPU path."""
    runner = _runner(family)
    with profiling.recording() as rec:
        totals, steps = runner.train_epoch()
    assert steps == 2 and bool(torch.isfinite(totals["loss"]))
    loss = ("loss", (("labels", ()),) if family == "music" else ())
    step = ("step", (("gather", ()),
                     ("train_step", (("forward", ()), loss, ("optimizer", ()),
                                     ("backward", ()), ("optimizer", ()))),
                     ("accumulate", ())))
    recs = rec.records()
    assert _tree(recs) == (("shuffle", ()), step, step)
    assert sorted({r.step for r in recs}) == [-1, 0, 1]
    assert not any(r.failed for r in recs)
