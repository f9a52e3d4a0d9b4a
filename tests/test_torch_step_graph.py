"""How the trainers choose between replaying a CUDA graph of the training
step and running it eagerly, on the CPU (the replay itself runs only on a
card: ``tests/test_torch_step_graph_cuda.py``).

Off a card every step runs eagerly and is counted under ``cpu``;
injected draws or a share, a module hook (forward or backward, on the
model, a submodule or global) and a process group each keep a step eager
under their own reason, whatever the device. ``restore_state`` drops a
held graph after a synchronise. Adam is ``fused`` and ``capturable``
exactly on a CUDA device, and a state saved with other settings loads
into a trainer with its own. A graph's batch signature tells shapes,
dtypes and aliased entries apart. The music trainers keep a training
step's decoder outputs (``step_outputs``), which a check reads without
a hook: what a forward hook sees of the same step.
"""

import copy
import types

import pytest
import torch

from arvae_tpu_torch.models.image_fader import DspritesFaderNetwork
from arvae_tpu_torch.models.image_vae import DspritesVAE
from arvae_tpu_torch.models.measure_vae import MeasureVAE
from arvae_tpu_torch.training import base
from arvae_tpu_torch.training.fader_trainer import ImageFaderTrainer
from arvae_tpu_torch.training.glsr_trainer import MeasureVAETrainerGLSR
from arvae_tpu_torch.training.image_trainer import ImageVAETrainer
from arvae_tpu_torch.training.measure_trainer import MeasureVAETrainer
from torch_card_cases import TokenCorpus, bench_vocab

CPU, B = torch.device("cpu"), 4


@pytest.fixture(autouse=True)
def counts():
    base.reset_step_counts()
    yield
    base.reset_step_counts()


def _trainer():
    return ImageVAETrainer(None, DspritesVAE(seed=0), CPU, reg_type=("all",),
                           reg_dim=(1, 2, 3, 4, 5), rand=3)


def _batch(seed=0):
    g = torch.Generator().manual_seed(seed)
    return ((torch.rand((B, 1, 64, 64), generator=g) < 0.5).float(),
            torch.rand((B, 6), generator=g))


def _only(reason, n):
    return {k: n if k == reason else 0 for k in base.EAGER_STEPS}


def test_cpu_steps_run_eagerly_and_are_counted():
    tr = _trainer()
    for i in range(3):
        metrics = tr.train_step(_batch(i))
        assert all(not v.requires_grad for v in metrics.values())
    assert base.EAGER_STEPS == _only("cpu", 3)
    assert base.GRAPH_STEPS == {"captured": 0, "replayed": 0}
    assert tr._graph is None and tr.step == 3


def _forward_hook(tr):
    return tr.model.register_forward_hook(lambda *args: None)


def _submodule_pre_hook(tr):
    return next(iter(tr.model.children())).register_forward_pre_hook(lambda *args: None)


def _backward_hook(tr):
    return tr.model.register_full_backward_hook(lambda *args: None)


def _global_hook(tr):
    return torch.nn.modules.module.register_module_forward_hook(lambda *args: None)


@pytest.mark.parametrize("hook", [_forward_hook, _submodule_pre_hook, _backward_hook,
                                  _global_hook])
def test_a_module_hook_keeps_a_step_eager(hook):
    tr = _trainer()
    handle = hook(tr)
    try:
        tr.train_step(_batch())
    finally:
        handle.remove()
    tr.train_step(_batch(1))
    assert base.EAGER_STEPS == dict(_only("hook", 1), cpu=1)


def test_injected_draws_keep_a_step_eager():
    tr = _trainer()
    tr.train_step(_batch(), noise=tr.draw_train_noise(B))
    assert base.EAGER_STEPS == _only("injected", 1)


def test_a_share_or_a_process_group_keeps_a_step_eager():
    tr = _trainer()
    batch = _batch()
    share = types.SimpleNamespace(total=B)
    assert tr.eager_reason(batch, None, share) == "injected"
    tr.ctx = types.SimpleNamespace(distributed=True)
    assert tr.eager_reason(batch, None, None) == "distributed"


def test_the_fader_discriminator_hook_keeps_its_step_eager():
    tr = ImageFaderTrainer(None, DspritesFaderNetwork(seed=0), CPU, rand=3)
    assert tr.step_modules() == (tr.model, tr.disc)
    handle = tr.disc.register_forward_hook(lambda *args: None)
    try:
        tr.train_step(_batch())
    finally:
        handle.remove()
    assert base.EAGER_STEPS == _only("hook", 1)


def test_restore_state_drops_a_held_graph(monkeypatch):
    tr = _trainer()
    tr.train_step(_batch())
    state = tr.checkpoint_state()
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *args: synced.append(args))
    tr._graph, tr._warm = object(), ("a batch's signature", 1)
    tr.restore_state(state)
    assert tr._graph is None and tr._warm == (None, 0) and len(synced) == 1
    tr.restore_state(state)  # nothing held: no synchronise
    assert len(synced) == 1 and tr.step == 1


def _adam_flags(opt):
    return [(g["fused"], g["capturable"]) for g in opt.param_groups]


def test_adam_is_fused_and_capturable_exactly_on_cuda():
    params = [torch.nn.Parameter(torch.zeros(3))]
    assert _adam_flags(base.make_adam(params, 1e-4, torch.device("cuda"))) == [(True, True)]
    assert _adam_flags(base.make_adam(params, 1e-4, CPU)) == [(None, False)]
    tr = ImageFaderTrainer(None, DspritesFaderNetwork(seed=0), CPU, rand=3)
    for opt in (tr.optimizer, tr.disc_optimizer):
        assert _adam_flags(opt) == [(None, False)]
        assert opt.param_groups[0]["lr"] == 1e-4


ADAM_SETTINGS = {"plain": {}, "capturable": {"capturable": True},
                 "fused": {"fused": True, "capturable": True}}


def _saved_adam(setting):
    """An Adam state after one step, saved with ``setting`` (one of
    ADAM_SETTINGS; set on the saved state, as a card would save it)."""
    p = torch.nn.Parameter(torch.ones(3))
    opt = torch.optim.Adam([p], lr=1e-4)
    p.grad = torch.ones(3)
    opt.step()
    state = opt.state_dict()
    state["param_groups"][0].update(ADAM_SETTINGS[setting])
    return state


@pytest.mark.parametrize("saved", list(ADAM_SETTINGS))
def test_an_adam_state_saved_either_way_loads_with_the_optimizers_setting(saved):
    state = _saved_adam(saved)
    for own in ADAM_SETTINGS.values():
        p = torch.nn.Parameter(torch.ones(3))
        opt = torch.optim.Adam([p], lr=1e-4, **own)
        flags = _adam_flags(opt)
        base.load_adam_state(opt, copy.deepcopy(state))  # a step would step the saved count
        assert _adam_flags(opt) == flags
        step = opt.state[p]["step"]
        assert float(step) == 1.0 and step.dtype == torch.float32
        assert step.device == p.device
        if not own:  # a capturable Adam steps only on a card
            p.grad = torch.ones(3)
            opt.step()
            assert float(opt.state[p]["step"]) == 2.0


def test_a_trainer_restores_a_capturable_checkpoint_on_the_cpu():
    tr = _trainer()
    tr.train_step(_batch())
    state = tr.checkpoint_state()
    # as saved on a card
    state["optimizer"]["param_groups"][0].update(ADAM_SETTINGS["fused"])
    tr.restore_state(state)
    assert _adam_flags(tr.optimizer) == [(None, False)]
    tr.train_step(_batch(1))
    assert tr.step == 2


def _music_trainer(cls):
    v = 24
    rows = torch.randint(0, v, (2 * B, 24), generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32).numpy()
    model = MeasureVAE(v, encoder_hidden_size=16, latent_space_dim=4, decoder_hidden_size=16,
                       seed=0)
    tr = cls(TokenCorpus(rows, bench_vocab(v)), model, CPU, rand=3)
    score = torch.from_numpy(rows[:B]).long()
    return tr, (score, score)


@pytest.mark.parametrize("cls", [MeasureVAETrainer, MeasureVAETrainerGLSR])
def test_the_music_step_keeps_its_decoder_outputs(cls):
    tr, batch = _music_trainer(cls)
    assert tr.step_outputs == {}
    seen = []
    handle = tr.model.register_forward_hook(
        lambda module, args, out: seen.append((out.samples.clone(), out.weights.clone())))
    try:
        tr.train_step(batch)
    finally:
        handle.remove()
    kept = tr.step_outputs
    assert list(kept) == ["samples", "weights"] and len(seen) == 1
    assert torch.equal(kept["samples"], seen[0][0]) and torch.equal(kept["weights"], seen[0][1])
    assert not kept["weights"].requires_grad
    tr.eval_step(batch)  # an evaluation's forward leaves them
    assert tr.step_outputs is kept


def test_the_signature_tells_shapes_dtypes_and_aliases_apart():
    x, y = torch.zeros(4, 24, dtype=torch.int32), torch.zeros(4, 24, dtype=torch.int32)
    sig = base._signature((x, x))
    assert sig == base._signature((y, y))
    assert sig != base._signature((x, y))  # a graph copies an aliased batch once
    assert sig != base._signature((x[:2], x[:2]))
    assert sig != base._signature((x.long(), x.long()))
