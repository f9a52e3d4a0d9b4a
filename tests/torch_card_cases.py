"""What the card tests, the CPU tests and ``chip_smoke.py`` share, so that
each exists once. It imports no ``jax`` and nothing of the JAX package
(the card's machine has neither), and it times nothing:

- the music and dSprites steps' trainers on random rows
  (``music_trainer``, ``dsprites_trainer``, with ``TokenCorpus`` and
  ``bench_vocab``), and one train step run twice from the same state,
  which must repeat bitwise (``step_repeats``);
- the shapes the card runs the kernels at: the GRU chain's wide layout
  (``WIDE_GRU_CASES``), the tick loop's widths and depths
  (``WIDE_DEEP_HIER``), and the backwards' tensor-core engine at every
  shape a train step gives it (``atb_step_shapes``, ``row_step_shapes``)
  with inputs from a seed;
- the device kernels a call launches, by name, from a profiled window
  whose records of the port's kernels the wrappers' launch counters
  confirm (``call_events``, ``kernels_a_call``), and the AR term's
  (``ar_term_kernels``);
- the ``.abc`` corpus that ``chip_smoke.py``'s slice 8 trains on and
  ``tests/test_torch_abc_ingest.py`` ingests (``write_abc_corpus``).
"""

from __future__ import annotations

import copy
import json
import os
import tempfile

import numpy as np
import torch

# ---------------------------------------------------------------------------
# The steps' trainers on random rows
# ---------------------------------------------------------------------------

DSPRITES_B, MUSIC_B, MUSIC_V = 128, 256, 130


def bench_vocab(n):
    """Specials and chromatic pitch names from MIDI 36 up: the vocabulary
    of ``scripts/bench_measure_vae.py``."""
    names = ["__", "START", "END", "rest"]
    spell = ["C", "C#", "D", "E-", "E", "F", "F#", "G", "A-", "A", "B-", "B"]
    midi = 36
    while len(names) < n:
        names.append(f"{spell[midi % 12]}{midi // 12 - 1}")
        midi += 1
    return {i: s for i, s in enumerate(names)}


class TokenCorpus:
    """Random measures over a V-token vocabulary, with what the music
    trainer reads of a dataset."""

    class_name = "4by4_FolkNBarDataset_1_"
    beat_subdivisions, time_sig_num, time_sig_den = 6, 4, 4

    def __init__(self, rows, index2note):
        self.rows = rows
        self.index2note_dicts = index2note
        self.note2index_dicts = {v: k for k, v in index2note.items()}

    def get_dataset(self):
        return self.rows, self.rows

    def attrs(self, device):
        from arvae_tpu_torch.data.attributes import MusicAttributes

        return MusicAttributes(self.index2note_dicts, device)


def music_trainer(dev, rows, ctx=None, hidden=128):
    """The music step's trainer (H=128, or ``hidden`` for the encoder and
    the decoder, z=32, V=130, ``-r all``) and its split, on ``rows`` (N,
    24) random tokens, over the data axis ``ctx`` (the trainer's default:
    ``init_data_parallel``'s)."""
    from arvae_tpu_torch.data.device_data import DeviceSplit
    from arvae_tpu_torch.models.measure_vae import MeasureVAE
    from arvae_tpu_torch.training.measure_trainer import MeasureVAETrainer

    corpus = TokenCorpus(rows, bench_vocab(MUSIC_V))
    trainer = MeasureVAETrainer(
        corpus, MeasureVAE(MUSIC_V, encoder_hidden_size=hidden, latent_space_dim=32,
                           decoder_hidden_size=hidden, seed=0),
        dev, reg_type=("all",), reg_dim=(0, 1, 2, 3), rand=0, ctx=ctx)
    return trainer, DeviceSplit(rows, None, (24,), "tokens", dev, trainer.ctx)


def dsprites_trainer(dev, packed, labels, ctx=None):
    """The dSprites step's trainer (``-r all``, β 1, γ 10, δ 1) and its
    packed split, over the data axis ``ctx`` (as :func:`music_trainer`)."""
    from arvae_tpu_torch.data.device_data import DeviceSplit
    from arvae_tpu_torch.models.image_vae import DspritesVAE
    from arvae_tpu_torch.training.image_trainer import ImageVAETrainer

    trainer = ImageVAETrainer(None, DspritesVAE(seed=0), dev, reg_type=("all",),
                              reg_dim=(1, 2, 3, 4, 5), beta=1.0, gamma=10.0, delta=1.0,
                              rand=0, ctx=ctx)
    return trainer, DeviceSplit(packed, labels, (1, 64, 64), "packed", dev, trainer.ctx)


def trainer_state(trainer):
    """A copy of the trainer's checkpoint state: parameters, Adam states
    and step count (the fader's discriminator and its Adam too)."""
    return copy.deepcopy(trainer.checkpoint_state())


def load_trainer_state(trainer, state):
    # a copy: Adam then updates its moments in place, and would update
    # the ones in ``state``
    trainer.restore_state(copy.deepcopy(state))


def step_repeats(tag, trainer, batch, must=True):
    """One train step twice from the same parameters, Adam state and
    draws (the fader's: both networks' and both Adam states): the loss,
    every gradient and every updated parameter must be
    bitwise equal (with ``must``; else the names that differ are
    returned). Leaves the trainer as it found it."""
    from arvae_tpu_torch.models.measure_vae import draw_measure_noise
    from arvae_tpu_torch.training.glsr_trainer import GLSRNoise, MeasureVAETrainerGLSR
    from arvae_tpu_torch.training.image_trainer import ImageVAETrainer

    dev, b = trainer.device, batch[0].shape[0]
    state = trainer_state(trainer)
    runs = []
    for _ in range(2):
        load_trainer_state(trainer, state)
        gen = torch.Generator(dev).manual_seed(11)
        if isinstance(trainer, ImageVAETrainer):  # MnistVAE's dropout masks too
            noise = trainer.draw_train_noise(b, gen)
        else:
            noise = draw_measure_noise(b, trainer.model.latent_space_dim, gen, dev)
        if isinstance(trainer, MeasureVAETrainerGLSR):
            noise = GLSRNoise(noise, torch.rand(b, generator=gen, device=dev))
        out = {"loss": trainer.train_step(batch, noise)["loss"]}
        nets = {"": trainer.model, **({"disc.": trainer.disc} if hasattr(trainer, "disc")
                                      else {})}
        for prefix, net in nets.items():
            for n, p in net.named_parameters():
                out[f"d{prefix}{n}"] = p.grad.clone()
                out[prefix + n] = p.detach().clone()
        runs.append(out)
    load_trainer_state(trainer, state)
    differ = [k for k in runs[0] if not torch.equal(runs[0][k], runs[1][k])]
    if not must:
        return differ
    if differ:
        raise AssertionError(f"{tag}: one train step from the same state gave other bits "
                             f"in a second run: {differ}")
    print(f"[repeat] {tag}: one train step from the same parameters, Adam state and draws, "
          f"twice: the loss, all {(len(runs[0]) - 1) // 2} gradients and updated parameters "
          f"bitwise equal")


# ---------------------------------------------------------------------------
# The shapes the card runs the kernels at
# ---------------------------------------------------------------------------

# the reference's own widths, whose w_hh slices no cluster holds (the
# wide layout): the 512-wide encoder layer and beat GRU layer,
# SRDecoderNoInput's layer at H=384, a ragged batch, and the tick loop's
# backward chains at H=512 (6 ticks on 4 beats x 256 rows)
WIDE_GRU_CASES = [(24, 2, 256, 512), (4, 1, 256, 512), (24, 1, 256, 384), (24, 2, 100, 512),
                  (6, 1, 1024, 512)]
# The tick loop at the music step: B rows, H hidden units, E-wide fed
# embedding, T ticks, TPB ticks a beat
HIER_B, HIER_H, HIER_E, HIER_T, HIER_TPB = 256, 128, 10, 24, 6
# (H, tick-GRU layers) beyond the music step's (128, 2): the widths the
# JAX package runs (256 fused on the TPU, 512 the reference's, 384
# SRDecoderNoInput's) and the depths its lax.scan runs
WIDE_DEEP_HIER = ((256, 2), (512, 2), (384, 2), (128, 1), (128, 3), (128, 4))


# The tensor-core engine's two forms alone (csrc/tc_gemm.cuh) at every
# shape a train step gives them, at H=512 and H=128.
# The weight-gradient GEMM (name, T, D, B, M, N, A's form, bias): the
# encoder's dW_hh (24 steps, both directions, h_{t-1} with h0), the beat
# GRU's (4 steps), the tick loop's dW_hh (6 ticks on 4 beats x 256 rows,
# the chains' initial hiddens) and dW_ih (the layer's input), dW_ih0e (E
# rows), the embedding's (the one-hot fed tokens, -1 for none) and out_w's
# (dlog's V columns: rows not 16-byte aligned).
def atb_step_shapes(h):
    return (("encoder dW_hh", 24, 2, 256, h, 3 * h, "prev", True),
            ("beat dW_hh", 4, 1, 256, h, 3 * h, "prev", True),
            ("tick dW_hh", HIER_TPB, 1, 4 * 256, h, 3 * h, "prev", True),
            ("tick dW_ih", HIER_TPB, 1, 4 * 256, h, 3 * h, "dense", True),
            ("tick dW_ih0e", HIER_TPB, 1, 4 * 256, HIER_E, 3 * h, "dense", False),
            ("tick demb", HIER_TPB, 1, 4 * 256, MUSIC_V, HIER_E, "tokens", False),
            ("tick dout_w", HIER_TPB, 1, 4 * 256, h, MUSIC_V, "dense", True))


# The tick loop's row products (name, M rows, K, N, W transposed) on its
# 6 x 4 x 256 chain rows: dlog out_w^T (K = V: rows not 16-byte aligned),
# the recomputed gates of layer 1 and of layer 0 (K = E), and the input
# gradients of layer 1 and of the fed embedding (N = E).
def row_step_shapes(h):
    rows = HIER_TPB * 4 * 256
    return (("dlog out_w^T", rows, MUSIC_V, h, True),
            ("inter w_ih", rows, h, 3 * h, False),
            ("pe w_ih0e", rows, HIER_E, 3 * h, False),
            ("dgi w_ih^T", rows, 3 * h, h, True),
            ("dgi w_ih0e^T", rows, 3 * h, HIER_E, True))


ENGINE_WIDTHS = (512, 128)


def atb_inputs(shape, dev, seed):
    """x and the A operand's keywords of ``gru_kernel.atb_cuda`` at an
    ``atb_step_shapes`` shape, from a seed (tokens: -1 in about one in
    ten, as at the beats' first ticks)."""
    _, t, d, b, m, n, form, _ = shape
    rng = np.random.RandomState(seed)

    def f(*dims):
        return torch.tensor(rng.randn(*dims) * 0.5, dtype=torch.float32, device=dev)

    x = f(t, d, b, n)
    if form == "tokens":
        tok = rng.randint(0, m, t * b)
        tok[rng.rand(t * b) < 0.1] = -1
        return x, {"tokens": torch.tensor(tok, dtype=torch.int32, device=dev), "M": m}
    return x, {"a": f(t, d, b, m), **({"a0": f(d, b, m)} if form == "prev" else {})}


def row_inputs(shape, dev, seed):
    """(a, w) of ``gru_kernel.rows_cuda`` at a ``row_step_shapes`` shape."""
    _, m, k, n, trans = shape
    rng = np.random.RandomState(seed)
    a = torch.tensor(rng.randn(m, k) * 0.5, dtype=torch.float32, device=dev)
    w = torch.tensor(rng.randn(*((n, k) if trans else (k, n))) / np.sqrt(k), dtype=torch.float32,
                     device=dev)
    return a, w


# ---------------------------------------------------------------------------
# The device kernels a call launches, from the profiler's records
# ---------------------------------------------------------------------------

# (z_tilde shape, label columns, dims) of the AR term on each slice
AR_SHAPES = {"dSprites": ((128, 10), 6, tuple((c, c) for c in range(1, 6))),
             "music": ((256, 32), 4, tuple((c, c) for c in range(4))),
             "MNIST": ((128, 16), 7, tuple((c, c) for c in range(1, 7)))}


def device_events(prof):
    """The kernel, memcpy and memset intervals of a ``torch.profiler``
    run, from its exported trace (empty when CUPTI delivered none)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def short_name(name):
    """'hier_bwd<8>' from a demangled kernel name, cut to 60 characters."""
    name = name.replace("(anonymous namespace)::", "").replace("arvae::", "")
    name = name.removeprefix("void ")
    return name.split("(")[0][:60]


# The port's kernels by short name, each launched a fixed number of
# times by one call of a wrapper: (ops module, its launch counter's key,
# kernels a count), summed. The tick loop's backward runs each of its
# layers through the GRU chain's backward (its ``CHAIN_LAUNCHES``); the
# wide layout's calls (``WIDE_LAUNCHES``, ``CHAIN_LAUNCHES["wide"]``)
# launch its kernels instead of the cluster kernels, and the tick loop's
# wave layout's (``WAVE_LAUNCHES``) its forward instead of ``hier_fwd``.
# The backwards' tensor-core engine counts its GEMMs and row products
# (``GEMM_LAUNCHES``), launched within or without a backward. The
# convolutions' weight gradient counts its first pass (its second runs
# only where the plan splits the sum).
ENTRY_KERNELS = {
    "reg_fwd": (("reg_kernel", "fwd", 1),),
    "reg_bwd": (("reg_kernel", "bwd", 1),),
    "gru_fwd": (("gru_kernel", "fwd", 1), ("gru_kernel", "wide_fwd", -1)),
    "gru_bwd": (("gru_kernel", "bwd", 1), ("gru_kernel", "wide_bwd", -1),
                ("hier_decoder_kernel", "chains", 1), ("hier_decoder_kernel", "chains_wide", -1)),
    "gru_wide_fwd": (("gru_kernel", "wide_fwd", 1),),
    "gru_wide_bwd": (("gru_kernel", "wide_bwd", 1), ("hier_decoder_kernel", "chains_wide", 1)),
    "hier_fwd": (("hier_decoder_kernel", "fwd", 1), ("hier_decoder_kernel", "wave_fwd", -1)),
    "hier_wave_fwd": (("hier_decoder_kernel", "wave_fwd", 1),),
    "hier_bwd_prep": (("hier_decoder_kernel", "bwd", 1),),
    "atb_tc": (("gru_kernel", "gemm_atb", 1), ("gru_kernel", "gemm_atb_alone", 1)),
    "rows_tc": (("gru_kernel", "gemm_rows", 1), ("gru_kernel", "gemm_rows_alone", 1)),
    "conv_wgrad_partial": (("conv_wgrad_kernel", "wgrad", 1),),
}


def _launch_counts():
    """{(module, key): count} of the port's wrapper launch counters."""
    from arvae_tpu_torch.ops import conv_wgrad_kernel as cw
    from arvae_tpu_torch.ops import gru_kernel as gk
    from arvae_tpu_torch.ops import hier_decoder_kernel as hk
    from arvae_tpu_torch.ops import reg_kernel as rk

    counts = {(name, k): v
              for name, m in (("reg_kernel", rk), ("gru_kernel", gk), ("hier_decoder_kernel", hk))
              for k, v in m.LAUNCHES.items()}
    for k in ("fwd", "bwd"):
        counts[("gru_kernel", f"wide_{k}")] = gk.WIDE_LAUNCHES[k]
    for k in ("atb", "rows", "atb_alone", "rows_alone"):
        counts[("gru_kernel", f"gemm_{k}")] = gk.GEMM_LAUNCHES[k]
    counts[("hier_decoder_kernel", "chains")] = hk.CHAIN_LAUNCHES["bwd"]
    counts[("hier_decoder_kernel", "chains_wide")] = hk.CHAIN_LAUNCHES["wide"]
    counts[("hier_decoder_kernel", "wave_fwd")] = hk.WAVE_LAUNCHES["fwd"]
    counts[("conv_wgrad_kernel", "wgrad")] = cw.LAUNCHES["wgrad"]
    return counts


# Device cycles of the spin kernel that opens and closes each profiled
# window (about 25 ms on an H100): the profiler keeps a device record
# only if it falls inside the host clock's window once converted, and a
# kernel that ends just before the closing sync can land past it.
PAD_CYCLES = 50_000_000
# Short spin kernels (about 11 µs each) queued behind the opening one:
# after a process has profiled for a while, CUPTI drops the records of
# the first few kernels launched in each window (none in a fresh
# process, several late in ``chip_smoke.py``); these take the loss in
# place of the calls'.
OPENING_KERNELS, OPENING_CYCLES = 64, 20_000


def open_window(kernels=OPENING_KERNELS):
    """Opens a profiled window: the spin kernel and ``kernels`` short
    ones, waited for. Their records are named ``spin_kernel``."""
    torch.cuda._sleep(PAD_CYCLES)
    for _ in range(kernels):
        torch.cuda._sleep(OPENING_CYCLES)
    torch.cuda.synchronize()


def call_events(fn, calls, attempts=5):
    """The device events of ``calls`` calls of ``fn`` after two warm ones
    and a traced warm-up step, from a profiled run whose records of the
    port's kernels (``ENTRY_KERNELS``) equal, kernel by kernel, what the
    wrappers' ``LAUNCHES`` counters say they launched in the same window,
    plus, where training steps were replayed from a CUDA graph (whose
    kernels no wrapper launches), the same count of each kernel in every
    replay: a whole multiple of the replays.
    The calls run between two spin kernels (``PAD_CYCLES``), left out of
    the events, so that none of theirs sits at an edge of the window; the
    opening one is followed by short ones and waited for
    (``open_window``). CUPTI loses records but never adds one, so a run
    that disagrees is profiled again with four times as many short
    kernels, up to ``attempts`` runs; raises if none agrees."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from arvae_tpu_torch.training import base

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    seen, opening = [], OPENING_KERNELS
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            before, replays = _launch_counts(), base.GRAPH_STEPS["replayed"]
            open_window(opening)
            for _ in range(calls):
                fn()
            torch.cuda._sleep(PAD_CYCLES)
            torch.cuda.synchronize()
            after, replays = _launch_counts(), base.GRAPH_STEPS["replayed"] - replays
            prof.step()
        events = [e for e in device_events(prof) if "spin_kernel" not in e["name"]]
        recorded = {}
        for e in events:
            name = short_name(e["name"]).split("<")[0]
            if name in ENTRY_KERNELS:
                recorded[name] = recorded.get(name, 0) + 1
        expected = {n: sum(c * (after[(m, k)] - before[(m, k)]) for m, k, c in parts)
                    for n, parts in ENTRY_KERNELS.items()}
        expected = {n: c for n, c in expected.items() if c}
        rest = {n: recorded.get(n, 0) - expected.get(n, 0) for n in ENTRY_KERNELS}
        if events and all(v == 0 if not replays else v >= 0 and v % replays == 0
                          for v in rest.values()):
            return events
        seen.append((recorded, expected, replays))
        opening *= 4
    raise AssertionError(f"no profiled run of {calls} calls recorded the port's kernels the "
                         f"launch counters count (recorded, counted, replays): {seen}")


def kernels_a_call(fn, calls=20):
    """{device kernel's short name: launches a call} over ``calls`` calls
    of ``fn`` (``call_events``)."""
    names = {}
    for e in call_events(fn, calls):
        names[short_name(e["name"])] = names.get(short_name(e["name"]), 0) + 1
    return {n: k / calls for n, k in names.items()}


def ar_term_kernels(dev, shape, n_labels, dims):
    """{"train": ..., "eval": ...}: the device kernels a call of the AR
    term (``total_reg_loss``) launches, {short name: launches a call} over
    50 calls, as a train step runs it (forward, and backward from
    ``z_tilde`` with a given seed gradient) and as an eval step runs it
    (forward under ``torch.no_grad()``)."""
    from arvae_tpu_torch.ops.losses import total_reg_loss

    rng = np.random.RandomState(shape[0] + shape[1])
    z = torch.tensor(rng.randn(*shape), dtype=torch.float32, device=dev)
    labels = torch.tensor(rng.randint(0, 4, (shape[0], n_labels)), dtype=torch.float32,
                          device=dev)
    gamma, delta = (torch.tensor(v, device=dev) for v in (10.0, 1.0))
    seed = torch.ones((), device=dev)  # the step's loss seeds the AR term's backward
    zg = z.clone().requires_grad_(True)

    def train():
        zg.grad = None
        torch.autograd.backward(total_reg_loss(zg, labels, dims, gamma, delta), seed)

    def evaluate():
        with torch.no_grad():
            total_reg_loss(z, labels, dims, gamma, delta)

    return {k: kernels_a_call(fn, 50) for k, fn in (("train", train), ("eval", evaluate))}


# ---------------------------------------------------------------------------
# The .abc corpus
# ---------------------------------------------------------------------------

# The fixture tunes of tests/test_abc_parser.py, one below the
# transposition range, tunes generated from a seed, and invalid ones the
# filter drops.
_ABC_SIMPLE = "X:1\nT:Test Tune\nM:4/4\nL:1/4\nK:C\nCDEF|GABc|\n"
ABC_VALID = {
    "simple": _ABC_SIMPLE,
    "endings": "X:4\nT:Endings\nM:4/4\nL:1/4\nK:C\n|:CDEF|1GGGG:|2AAAA|\n",
    "triplet": "X:6\nT:Triplets\nM:4/4\nL:1/8\nK:C\n(3CDE (3CDE C2C2 z4|\n",
    "tie_across_bar": _ABC_SIMPLE.replace("CDEF|GABc|", "CDEE-|EGGc|"),
    # below the transposition range: its untransposed bars grow the vocabulary
    "low": _ABC_SIMPLE.replace("CDEF|GABc|", "C,D,E,F,|G,A,B,C|"),
}
ABC_INVALID = {
    "chords": _ABC_SIMPLE.replace("CDEF", '"C"CDEF'),
    "six_eight": _ABC_SIMPLE.replace("M:4/4", "M:6/8"),
    "no_title": _ABC_SIMPLE.replace("T:Test Tune\n", ""),
    "second_voice": _ABC_SIMPLE + "V:2\nCCCC|\n",
    "meter_change": _ABC_SIMPLE.replace("CDEF|GABc|", "CDEF|\nM:6/8\nGAB|"),
}
ABC_GENERATED = 26
_ABC_KEYS = ["C", "G", "D", "A", "F", "Bb", "Ador", "Em", "Dmix", "Bm", "Gm", "Edor"]


def _abc_bar(rng, letters):
    """One 4/4 bar at L:1/8: eight eighths' worth, every onset on the tick grid."""
    def pick():
        return letters[rng.randint(len(letters))]

    kind = rng.randint(6)
    if kind == 0:
        return "".join(pick() for _ in range(8))
    if kind == 1:
        return "".join(pick() + "2" for _ in range(4))
    if kind == 2:  # a triplet of eighths in a quarter's time, then six eighths
        return "(3" + "".join(pick() for _ in range(9))
    if kind == 3:  # sixteenths, a dotted quarter, a rest
        return pick() + "/" + pick() + "/" + pick() + "3" + "z2" + pick() + pick()
    if kind == 4:  # accidentals, and a tie into the next bar
        return ("^" + pick() + pick() + "_" + pick() + pick() + "=" + pick()
                + "".join(pick() for _ in range(3)) + "-")
    return pick() + "4" + pick() + "2" + pick() + pick()


def abc_tune(i, rng, letters="DEFGABcdefg"):
    """Tune ``i``: 4-8 bars, some under a repeat or first and second
    endings, some in common time (``M:C``), the keys in turn."""
    bars = [_abc_bar(rng, letters) for _ in range(rng.randint(4, 9))]
    body = "|".join(bars) + "|"
    if i % 3 == 0:
        body = "|:" + body + ":|"
    if i % 4 == 1:
        body = "|:" + "|".join(bars[:2]) + "|1" + bars[2] + ":|2" + bars[3] + "|"
    meter = "C" if i % 5 == 2 else "4/4"
    return f"X:{i}\nT:Tune {i}\nM:{meter}\nL:1/8\nK:{_ABC_KEYS[i % len(_ABC_KEYS)]}\n{body}\n"


def write_abc_corpus(raw, narrow=None):
    """``ABC_GENERATED`` tunes from ``RandomState(0)``, ``ABC_VALID`` and
    ``ABC_INVALID`` as ``.abc`` files and a README in ``raw``; with
    ``narrow``, 3 tunes of four pitches there. → the valid tunes."""
    rng = np.random.RandomState(0)
    files = {f"gen_{i:02d}.abc": abc_tune(i, rng) for i in range(ABC_GENERATED)}
    files.update({f"fixture_{k}.abc": v for k, v in ABC_VALID.items()})
    files.update({f"invalid_{k}.abc": v for k, v in ABC_INVALID.items()})
    files["README.txt"] = "not a tune\n"
    os.makedirs(raw)
    for name, text in files.items():
        with open(os.path.join(raw, name), "w") as fh:
            fh.write(text)
    if narrow is not None:
        os.makedirs(narrow)
        for i in range(3):
            with open(os.path.join(narrow, f"narrow_{i}.abc"), "w") as fh:
                fh.write(abc_tune(100 + i, rng, letters="FGAB"))
    return ABC_GENERATED + len(ABC_VALID)
