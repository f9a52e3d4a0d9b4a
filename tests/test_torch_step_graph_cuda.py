"""The training step replayed as one CUDA graph against the same step run
eagerly, on the card. Marked ``gpu``: without a CUDA card every case
skips.

Run on the card with
``python -m pytest --noconftest tests/test_torch_step_graph_cuda.py``.

Two trainers are built alike from one seed: one takes the graph path
(``WARMUP_STEPS`` eager steps, then a capture replayed on every later
step), the other is kept eager by a forward hook that does nothing. The
same 8 batches go to both. Every step's metrics and decoder outputs
(``step_outputs``) and every parameter after the last step must be
bitwise equal: a replay runs the eager step's kernels in its order on
the same draws, so no tolerance applies. The step counters must read one
capture, the replays, and the warm-up (the hooked trainer: only hooked
eager steps). The kernels' launch counters count what the wrappers
launch: on the graph path the warm-up's and the capture's steps, none a
replay, each step's counts those of an eager step; the profiler's kernel
records show what a replay runs. The cases: the three trainers of
the benchmark's cells (the music model at H=128, z=32 and at H=512,
z=256, B=256, V=130; dSprites at B=128), and at small batches trainers in
no cell (GLSR, the SR decoder, Morpho-MNIST's model in bfloat16) and the
fader with its two optimisers. A state restored after a capture drops
the graph and gives the eager run's next steps; in each cell's trainer a
replay is one ``graph_replay`` span, launches no kernel from its
wrapper, and its kernels are the eager step's, in order, after the fills
that set the registered generators' state.
"""

import copy
import json

import pytest
import torch

from arvae_tpu_torch.data.device_data import DeviceSplit
from arvae_tpu_torch.models.image_fader import DspritesFaderNetwork
from arvae_tpu_torch.models.image_vae import DspritesVAE, MnistVAE
from arvae_tpu_torch.models.measure_vae import MeasureVAE
from arvae_tpu_torch.ops import conv_wgrad_kernel, gru_kernel, hier_decoder_kernel, reg_kernel
from arvae_tpu_torch.training import base
from arvae_tpu_torch.training.fader_trainer import ImageFaderTrainer
from arvae_tpu_torch.training.glsr_trainer import MeasureVAETrainerGLSR
from arvae_tpu_torch.training.image_trainer import ImageVAETrainer
from arvae_tpu_torch.training.measure_trainer import MeasureVAETrainer
from arvae_tpu_torch.utils import profiling
from torch_card_cases import TokenCorpus, bench_vocab

pytestmark = pytest.mark.gpu

STEPS, V = 8, 130
# a grid of each dSprites factor (start, stop, count), as the benchmark draws them
DSPRITES_GRIDS = ((1.0, 1.0, 1), (1.0, 3.0, 3), (0.5, 1.0, 6), (0.0, 6.283185307179586, 40),
                  (0.0, 1.0, 32), (0.0, 1.0, 32))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _music(dev, hidden, z, batch=256, decoder="hier", glsr=False):
    rows = torch.randint(0, V, (STEPS * batch, 24), generator=_gen(1), dtype=torch.int32).numpy()
    corpus = TokenCorpus(rows, bench_vocab(V))
    model = MeasureVAE(V, encoder_hidden_size=hidden, latent_space_dim=z,
                       decoder_hidden_size=hidden, decoder_type=decoder, seed=0)
    if glsr:
        tr = MeasureVAETrainerGLSR(corpus, model, dev, rand=7)
    else:
        tr = MeasureVAETrainer(corpus, model, dev, reg_type=("all",), reg_dim=(0, 1, 2, 3),
                               rand=7)
    split = DeviceSplit(rows, None, (24,), "tokens", dev, tr.ctx)
    perm = torch.randperm(len(rows), generator=_gen(2))
    return tr, [split.gather_batch(perm[i * batch:(i + 1) * batch].to(dev))
                for i in range(STEPS)]


def _images(dev, model, batch, size, labels, **kw):
    g = _gen(3)
    imgs = [(torch.rand((batch, 1, size, size), generator=g) < 0.5).float().to(dev)
            for _ in range(STEPS)]
    labs = [labels(g, batch).to(dev) for _ in range(STEPS)]
    cls = ImageFaderTrainer if isinstance(model, DspritesFaderNetwork) else ImageVAETrainer
    return cls(None, model, dev, rand=7, **kw), list(zip(imgs, labs))


def _dsprites_labels(g, batch):
    cols = [start + torch.randint(0, n, (batch,), generator=g).double()
            * ((stop - start) / (n - 1) if n > 1 else 0.0) for start, stop, n in DSPRITES_GRIDS]
    return torch.stack(cols, 1).float()


def _mnist_labels(g, batch):
    return torch.cat([torch.randint(0, 10, (batch, 1), generator=g).float(),
                      10.0 * torch.rand((batch, 6), generator=g)], 1)


CASES = {
    "music_h128": lambda dev: _music(dev, 128, 32),
    "music_h512": lambda dev: _music(dev, 512, 256),
    "dsprites": lambda dev: _images(dev, DspritesVAE(seed=0), 128, 64, _dsprites_labels,
                                    reg_type=("all",), reg_dim=(1, 2, 3, 4, 5), beta=4.0,
                                    gamma=10.0, delta=1.0),
    "glsr": lambda dev: _music(dev, 128, 32, batch=64, glsr=True),
    "sr_decoder": lambda dev: _music(dev, 128, 32, batch=64, decoder="sr"),
    "mnist_bf16": lambda dev: _images(dev, MnistVAE(seed=0, compute_dtype=torch.bfloat16), 64,
                                      28, _mnist_labels, reg_type=("area", "slant"),
                                      reg_dim=(1, 4)),
    "fader": lambda dev: _images(dev, DspritesFaderNetwork(seed=0), 64, 64, _dsprites_labels),
}


def _launches():
    return [dict(c) for c in (gru_kernel.LAUNCHES, gru_kernel.WIDE_LAUNCHES,
                              gru_kernel.GEMM_LAUNCHES, hier_decoder_kernel.LAUNCHES,
                              hier_decoder_kernel.WAVE_LAUNCHES,
                              hier_decoder_kernel.CHAIN_LAUNCHES, reg_kernel.LAUNCHES,
                              conv_wgrad_kernel.LAUNCHES)]


def _reset():
    base.reset_step_counts()
    gru_kernel.reset_launches()
    hier_decoder_kernel.reset_launches()
    reg_kernel.reset_launches()
    conv_wgrad_kernel.reset_launches()


def _params(tr):
    return {f"{i}.{k}": v.detach().clone() for i, m in enumerate(tr.step_modules())
            for k, v in m.state_dict().items()}


def _run(tr, batches):
    """Each step's metrics and step outputs (cloned), the parameters
    after, the counters."""
    _reset()
    metrics = []
    for b in batches:
        metrics.append({k: v.clone() for k, v in tr.train_step(b).items()})
        metrics[-1].update({f"out.{k}": v.clone() for k, v in tr.step_outputs.items()})
    torch.cuda.synchronize()
    return (metrics, _params(tr), dict(base.GRAPH_STEPS), dict(base.EAGER_STEPS),
            _launches())


def _assert_bitwise(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _only(reason, n):
    return {k: n if k == reason else 0 for k in base.EAGER_STEPS}


def _hooked(tr):
    tr.model.register_forward_hook(lambda *args: None)
    return tr


@pytest.mark.parametrize("name", list(CASES))
def test_replayed_steps_are_the_eager_steps_bitwise(dev, name):
    graphed, batches = CASES[name](dev)
    eager = _hooked(CASES[name](dev)[0])
    g_metrics, g_params, g_graph, g_eager, g_launches = _run(graphed, batches)
    e_metrics, e_params, e_graph, e_eager, e_launches = _run(eager, batches)
    for got, want in zip(g_metrics, e_metrics):
        _assert_bitwise(got, want)
    _assert_bitwise(g_params, e_params)
    assert g_graph == {"captured": 1, "replayed": STEPS - base.WARMUP_STEPS}
    assert g_eager == _only("warmup", base.WARMUP_STEPS)
    assert e_graph == {"captured": 0, "replayed": 0}
    assert e_eager == _only("hook", STEPS)
    # the wrappers launch on the graph path in the warm-up and the capture
    # alone, as many a step as an eager step
    launched = base.WARMUP_STEPS + 1
    assert [{k: n * STEPS for k, n in c.items()} for c in g_launches] == \
        [{k: n * launched for k, n in c.items()} for c in e_launches]
    music = name not in ("dsprites", "mnist_bf16", "fader")
    assert all("out.samples" in m for m in g_metrics) == music


def test_a_restored_state_drops_the_graph_and_steps_as_eager(dev):
    graphed, batches = CASES["music_h128"](dev)
    eager = _hooked(CASES["music_h128"](dev)[0])
    for b in batches[:4]:
        eager.train_step(b)
    state = copy.deepcopy(eager.checkpoint_state())
    gens = (eager.noise_generator.get_state(), eager.perm_generator.get_state())
    for b in batches[:6]:
        graphed.train_step(b)
    assert graphed._graph is not None
    graphed.restore_state(state)
    assert graphed._graph is None and graphed.step == 4
    graphed.noise_generator.set_state(gens[0])
    graphed.perm_generator.set_state(gens[1])
    g_metrics, g_params, g_graph, _, _ = _run(graphed, batches[4:])
    e_metrics, e_params, _, _, _ = _run(eager, batches[4:])
    for got, want in zip(g_metrics, e_metrics):
        _assert_bitwise(got, want)
    _assert_bitwise(g_params, e_params)
    assert g_graph == {"captured": 1, "replayed": STEPS - 4 - base.WARMUP_STEPS}


def _kernels(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [e["name"] for e in sorted((e for e in events if e.get("cat") == "kernel"),
                                      key=lambda e: e["ts"])]


# kernels each cell's step must run (a name's substring)
CELL_KERNELS = {"music_h128": ("gru_fwd", "gru_bwd", "hier_fwd", "hier_bwd_prep", "atb_tc",
                               "rows_tc", "reg_fwd", "reg_bwd"),
                "music_h512": ("gru_wide", "hier_wave_fwd", "hier_bwd_prep", "atb_tc",
                               "rows_tc", "reg_fwd", "reg_bwd"),
                "dsprites": ("reg_fwd", "reg_bwd", "conv_wgrad_partial", "conv_wgrad_sum")}


@pytest.mark.parametrize("name", list(CELL_KERNELS))
def test_a_replay_is_one_span_and_runs_the_eager_kernels_in_order(dev, tmp_path, name):
    tr, batches = CASES[name](dev)
    activities = [torch.profiler.ProfilerActivity.CUDA]
    tr.train_step(batches[0])  # Adam makes its state in its first step
    with torch.profiler.profile(activities=activities) as prof:
        tr.train_step(batches[1])
        torch.cuda.synchronize()
    eager = _kernels(prof, tmp_path)
    for b in batches[2:base.WARMUP_STEPS + 1]:  # the rest of the warm-up, the capture
        tr.train_step(b)
    assert tr._graph is not None
    _reset()
    with profiling.recording() as rec, torch.profiler.profile(activities=activities) as prof:
        tr.train_step(batches[-1])
        torch.cuda.synchronize()
    names = [r.name for r in rec.records()]
    assert names == ["graph_replay"]
    assert all(n == 0 for c in _launches() for n in c.values())
    assert base.GRAPH_STEPS == {"captured": 0, "replayed": 1}
    replayed = _kernels(prof, tmp_path)
    # a replay first fills in the registered generators' seed and offset
    # (the noise generator's and the default one's)
    prologue = 0
    while prologue < len(replayed) and "FillFunctor<long>" in replayed[prologue]:
        prologue += 1
    assert prologue <= 4 and replayed[prologue:] == eager
    for kernel in CELL_KERNELS[name]:
        assert any(kernel in n for n in replayed), kernel
