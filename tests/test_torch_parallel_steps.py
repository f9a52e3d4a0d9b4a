"""The port's data-parallel train steps, on the CPU over gloo, against its
one-card step and the JAX package's sharded step.

From the same weights (the JAX package's init, converted), the same
three global batches and the same global draws, three Adam(1e-4) steps
run on W ∈ {2, 4} spawned ranks (``tests/torch_parallel_ranks.py``),
each rank gathering its rows of every batch from a row-sharded split,
and once on one rank with no process group. The cases:

- ``dsprites``: the dSprites AR-VAE at B=16, ``capacity`` 0.5 (> 0);
- ``dsprites_b18``: B=18, which does not divide 4 (5, 5, 5, 3 rows);
- ``dsprites_b5``: B=5 at W=4, whose last rank holds no row;
- ``measure``: a MeasureVAE cut to H=32, z=8, ``-r all``, B=8, both
  dropout rates 0 (the packages draw dropout bits differently);
- ``measure_dropout``: the same at dropout 0.5 with the trainer's own
  draws, against the port's one-card step only: the GRUs' masks drawn
  for the global batch and the tick loop's hashed by global row;
- ``glsr``: ``MeasureVAETrainerGLSR`` at the same widths, B=8;
- ``fader``: the dSprites fader and its discriminator, B=16.

Against the one-card step: each step's losses within rtol 1e-5 (float32
sums in another order: per-rank means weighted and summed), the summed
gradients of the first step within rtol 1e-4 / atol 1e-6, the
parameters after three steps within atol 5·lr (Adam moves an element by
up to lr a step whatever its gradient's size, so the last bits of a
near-zero gradient may move it either way), and bitwise equal on every
rank. Against JAX's step with the batch sharded over a W-device mesh
(one device where B does not divide W), composed from its public pieces
as ``tests/test_parallel_training.py`` composes it: the same rtol 1e-5
for the losses, with an absolute 1e-6 for the KLD (a cancellation near
the prior, ``tests/test_torch_train_step.py``), and the same gradient
and parameter tolerances; GLSR's gradients, a finite difference, within
2e-3 of each leaf's largest magnitude (``tests/test_torch_glsr.py``). ``test_loss_terms_*`` hold the two terms a
data-parallel step could get wrong without changing a one-card run: the
AR term's gradient through the gather (an all-gather that sums in its
backward gives W times it) and the capacity KLD, whose ``|·−c|`` is of
the global mean.
"""


import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parallel_ranks as ranks
from arvae_tpu.data.attributes import MusicAttributes as JaxAttributes
from arvae_tpu.data.bar_dataset import FolkNBarDataset as JaxFolk
from arvae_tpu.data.dsprites import generate_dsprites
from arvae_tpu.models import DspritesFaderNetwork as FlaxDspritesFader
from arvae_tpu.models import DspritesVAE as FlaxDspritesVAE
from arvae_tpu.models import ImageFaderDiscriminator as FlaxDisc
from arvae_tpu.models.measure_vae import MeasureVAE as FlaxMeasureVAE
from arvae_tpu.ops.losses import (kld_loss, pixel_accuracy, reconstruction_loss,
                                  token_accuracy, token_cross_entropy_loss, total_reg_loss)
from arvae_tpu.parallel import create_mesh, shard_batch
from arvae_tpu.training.fader_trainer import ImageFaderTrainer as JaxFaderTrainer
from arvae_tpu.training.glsr_trainer import MeasureVAETrainerGLSR as JaxGLSR
from arvae_tpu_torch.data.bar_dataset import FolkNBarDataset
from arvae_tpu_torch.utils.convert import (dsprites_vae_from_flax,
                                           fader_discriminator_from_flax, fader_from_flax,
                                           measure_vae_from_flax)

LR, STEPS = 1e-4, 3
TINY = (1, 3, 2, 2, 4, 4)
H, Z, T = 32, 8, 24
IMAGE_HYPER = {"beta": 1.0, "capacity": 0.5, "gamma": 10.0, "delta": 1.0}
MUSIC_HYPER = {"beta": 0.001, "capacity": 0.0, "gamma": 1.0, "delta": 10.0}
MUSIC_KEYS = (2, 0, 3)  # teacher coin: forced, free-running, forced
GLSR_KEYS = (0, 1, 3)
# case → (global batch, worlds it runs at, held to JAX)
CASES = {
    "dsprites": (16, (2, 4), True),
    "dsprites_b18": (18, (2, 4), True),
    "dsprites_b5": (5, (4,), True),
    "measure": (8, (2, 4), True),
    "measure_dropout": (8, (2, 4), False),
    "glsr": (8, (2, 4), True),
    "fader": (16, (2, 4), True),
}
RUNS = [(w, name) for name, (_, worlds, _) in CASES.items() for w in worlds]
JAX_RUNS = [(w, name) for w, name in RUNS if CASES[name][2]]
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
# GLSR's gradient is a finite difference of two decodes divided by 2δ
# (δ ≈ 1e-3), so the rounding of rows summed in another order reaches it
# ×250-500: each leaf within 2e-3 of its largest magnitude, the rule and
# reason of tests/test_torch_glsr.py
GLSR_GRAD_ATOL_FRAC = 2e-3
PARAM_ATOL = 5 * LR
# against JAX: near the prior the KLD is a cancellation of O(1) terms, so
# its float32 rounding is absolute (tests/test_torch_train_step.py)
KLD_ATOL = 1e-6


class _DspritesName:
    """Only its class name: how the trainers tell dSprites apart."""


_DspritesName.__name__ = "DspritesDataset"


def _widths(v, dropout=0.0):
    return dict(num_notes=v, note_embedding_dim=10, num_encoder_layers=2,
                encoder_hidden_size=H, encoder_dropout_prob=dropout, latent_space_dim=Z,
                num_decoder_layers=2, decoder_hidden_size=H, decoder_dropout_prob=dropout)


def _music_draws(key, b, glsr=False):
    """ε, ε_prior and the teacher coin as the JAX model splits ``key``
    (and for GLSR the perturbations' U(0, 1)), as numpy."""
    k_fwd, k_glsr = jax.random.split(key) if glsr else (key, None)
    _, k_rep, k_prior, k_dec = jax.random.split(k_fwd, 4)
    teacher = bool(jax.random.uniform(jax.random.split(k_dec, 3)[0], ()) < 0.5)
    draws = [np.asarray(jax.random.normal(k_rep, (b, Z))),
             np.asarray(jax.random.normal(k_prior, (b, Z))),
             np.array([int(teacher)], np.int32), np.array([0], np.int32)]
    if glsr:
        draws.append(np.asarray(jax.random.uniform(jax.random.split(k_glsr, 3)[0], (b,))))
    return draws


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """The corpus's directory and the ranks' working directory."""
    root = tmp_path_factory.mktemp("parallel_steps")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)  # no folk_raw_data/ here
        mp.setenv("ARVAE_DATASETS_DIR", str(root / "datasets"))
        FolkNBarDataset(dataset_type="train", is_short=True, num_bars=1).get_dataset()
        yield root


def _env(root):
    return {"ARVAE_DATASETS_DIR": str(root / "datasets")}


def _image_case(b, flax):
    packed, latents = generate_dsprites(TINY)
    order = np.random.RandomState(0).permutation(len(packed))[:b * STEPS]
    rng = np.random.RandomState(1)
    noise = [(rng.randn(b, 10).astype(np.float32), rng.randn(b, 10).astype(np.float32))
             for _ in range(STEPS)]
    return {"rows": packed[order], "labels": latents[order].astype(np.float32),
            "idx": [np.arange(i * b, (i + 1) * b) for i in range(STEPS)], "noise": noise,
            "flax": flax, "lr": LR}


@pytest.fixture(scope="module")
def cases(workdir):
    """Every case's data, weights and draws (``ranks.run_case``'s input)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(workdir)
        mp.setenv("ARVAE_DATASETS_DIR", str(workdir / "datasets"))
        corpus = FolkNBarDataset(dataset_type="train", is_short=True, num_bars=1)
        tokens = np.asarray(corpus.get_dataset()[0], np.int32)
    v = len(corpus.note2index_dicts)
    image = FlaxDspritesVAE().init({"params": jax.random.key(0), "sample": jax.random.key(1)},
                                   jnp.zeros((1, 1, 64, 64), jnp.float32), train=True)["params"]
    k = jax.random.split(jax.random.key(0), 3)
    music = FlaxMeasureVAE(**_widths(v)).init(
        {"params": k[0], "sample": k[1], "dropout": k[2]}, jnp.zeros((1, T), jnp.int32),
        train=True)["params"]
    out = {}
    for name, (b, worlds, _) in CASES.items():
        if name.startswith("dsprites"):
            case = dict(_image_case(b, image), kind="dsprites", hyper=IMAGE_HYPER,
                        reg_dim=(1, 2, 3, 4, 5), weights=dsprites_vae_from_flax(image))
        elif name == "fader":
            jt = _jax_fader(1)
            state = jt.ensure_state()
            case = dict(_image_case(b, (state.params, state.disc_params)), kind="fader",
                        weights=fader_from_flax(state.params),
                        disc_weights=fader_discriminator_from_flax(state.disc_params))
        else:
            order = np.random.RandomState(0).permutation(len(tokens))[:b * STEPS]
            glsr = name == "glsr"
            keys = GLSR_KEYS if glsr else MUSIC_KEYS
            dropout = 0.5 if name == "measure_dropout" else 0.0
            noise = ([None] * STEPS if dropout else
                     [_music_draws(jax.random.key(s), b, glsr) for s in keys])
            case = {"kind": "glsr" if glsr else "measure", "rows": tokens[order],
                    "idx": [np.arange(i * b, (i + 1) * b) for i in range(STEPS)],
                    "noise": noise, "keys": keys, "flax": music, "lr": LR,
                    "hyper": MUSIC_HYPER, "reg_dim": (0, 1, 2, 3),
                    "widths": _widths(v, dropout), "weights": measure_vae_from_flax(music)}
        case["worlds"] = worlds
        out[name] = case
    torch.save({n: {k: x for k, x in c.items() if k not in ("flax", "keys")}
                for n, c in out.items()}, workdir / "cases.pt")
    return out


@pytest.fixture(scope="module")
def one_card(cases, workdir):
    """Each case on one rank, no process group."""
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(workdir)
        mp.setenv("ARVAE_DATASETS_DIR", str(workdir / "datasets"))
        return {name: ranks.run_case({k: x for k, x in case.items() if k != "flax"})
                for name, case in cases.items()}


@pytest.fixture(scope="module")
def spawned(cases, workdir):
    """W → every rank's results of every case that runs at W (one spawn
    of W ranks each)."""
    memo = {}

    def get(world):
        if world not in memo:
            memo[world] = ranks.run_ranks(world, "steps_body", str(workdir),
                                          env=_env(workdir))
        return memo[world]

    return get


# ---------------------------------------------------------------------------
# Against the port's one-card step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world,name", RUNS)
def test_losses_match_the_one_card_step(spawned, one_card, world, name):
    want = one_card[name]["metrics"]
    for rank, res in enumerate(spawned(world)):
        got = res[name]["metrics"]
        assert res[name]["step"] == STEPS
        for i in range(STEPS):
            assert sorted(got[i]) == sorted(want[i])
            for k in want[i]:
                np.testing.assert_allclose(got[i][k], want[i][k], rtol=LOSS_RTOL,
                                           err_msg=f"rank {rank} step {i} {k}")


@pytest.mark.parametrize("world,name", RUNS)
def test_gradients_match_the_one_card_step(spawned, one_card, world, name):
    want = one_card[name]["grads"]
    for rank, res in enumerate(spawned(world)):
        got = res[name]["grads"]
        assert sorted(got) == sorted(want)
        for k in want:
            _check_grads(name, got[k], want[k], f"rank {rank} {k}")


@pytest.mark.parametrize("world,name", RUNS)
def test_parameters_match_the_one_card_step(spawned, one_card, world, name):
    want = one_card[name]["params"]
    got = spawned(world)[0][name]["params"]
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)


@pytest.mark.parametrize("world,name", RUNS)
def test_parameters_are_bitwise_equal_across_ranks(spawned, world, name):
    first, *rest = (res[name]["params"] for res in spawned(world))
    for rank, params in enumerate(rest, 1):
        for k in first:
            assert torch.equal(params[k], first[k]), f"rank {rank} {k}"


# ---------------------------------------------------------------------------
# Against the JAX package's sharded step
# ---------------------------------------------------------------------------


def _mesh(world, b):
    """A W-device data mesh; one device where the batch does not divide W."""
    n = world if b % world == 0 else 1
    return create_mesh(devices=jax.devices()[:n])


def _unpacked(rows):
    return np.unpackbits(rows, axis=1).reshape(-1, 1, 64, 64).astype(np.float32)


def _jax_image_run(case, world):
    model, optimizer = FlaxDspritesVAE(), optax.adam(LR)
    pairs = tuple((d, d) for d in case["reg_dim"])
    hy = IMAGE_HYPER

    def loss_fn(params, inputs, labels, eps):
        z_mean, z_log_std = model.apply({"params": params}, inputs, train=True,
                                        method="encode")
        z_tilde = z_mean + jnp.exp(z_log_std) * eps
        logits = model.apply({"params": params}, z_tilde, train=True, method="decode")
        recons = reconstruction_loss(logits, inputs, "bernoulli")
        dist = kld_loss(z_mean, z_log_std, hy["beta"], hy["capacity"])
        reg = total_reg_loss(z_tilde, labels, pairs, hy["gamma"], hy["delta"])
        loss = recons + dist + reg
        return loss, {"recons_loss": recons, "dist_loss": dist, "reg_loss": reg,
                      "loss": loss, "accuracy": pixel_accuracy(jax.nn.sigmoid(logits), inputs)}

    @jax.jit
    def step(params, opt_state, inputs, labels, eps):
        (_, m), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, inputs, labels, eps)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, m, grads

    mesh = _mesh(world, len(case["idx"][0]))
    params = jax.device_put(case["flax"], mesh.replicated)
    opt_state = jax.device_put(optimizer.init(case["flax"]), mesh.replicated)
    metrics, first = [], None
    for i, idx in enumerate(case["idx"]):
        batch = shard_batch(mesh, (_unpacked(case["rows"][idx]), case["labels"][idx],
                                   case["noise"][i][0]))
        params, opt_state, m, grads = step(params, opt_state, *batch)
        metrics.append(m)
        first = grads if first is None else first
    return metrics, dsprites_vae_from_flax(first), dsprites_vae_from_flax(params)


def _jax_music_run(case, world, corpus_dir):
    v = case["widths"]["num_notes"]
    model, optimizer = FlaxMeasureVAE(**_widths(v)), optax.adam(LR)
    hy, pairs = MUSIC_HYPER, tuple((d, d) for d in case["reg_dim"])
    mesh = _mesh(world, len(case["idx"][0]))
    if case["kind"] == "glsr":
        with pytest.MonkeyPatch.context() as mp:
            mp.chdir(corpus_dir)
            mp.setenv("ARVAE_DATASETS_DIR", str(corpus_dir / "datasets"))
            jtr = JaxGLSR(JaxFolk(dataset_type="train", is_short=True, num_bars=1), model,
                          lr=LR, reg_type="rhy_complexity", reg_dim=0, rand=0, mesh=mesh)

        def loss_fn(p, score, key):
            return jtr._loss_fn(p, (score, None), key, True)
    else:
        with pytest.MonkeyPatch.context() as mp:
            mp.chdir(corpus_dir)
            mp.setenv("ARVAE_DATASETS_DIR", str(corpus_dir / "datasets"))
            corpus = FolkNBarDataset(dataset_type="train", is_short=True, num_bars=1)
            corpus.get_dataset()
        attrs = JaxAttributes(corpus.index2note_dicts)

        def loss_fn(p, score, key):
            out = model.apply({"params": p}, score, train=True, rng_key=key)
            recons = token_cross_entropy_loss(out.weights, score)
            dist = kld_loss(out.z_mean, out.z_log_std, hy["beta"], hy["capacity"])
            reg = total_reg_loss(out.z_tilde, attrs.compute_labels(score), pairs,
                                 hy["gamma"], hy["delta"])
            loss = recons + dist + reg
            return loss, {"recons_loss": recons, "dist_loss": dist, "reg_loss": reg,
                          "loss": loss, "accuracy": token_accuracy(out.weights, score)}

    @jax.jit
    def step(p, opt_state, score, key):
        (_, m), grads = jax.value_and_grad(loss_fn, has_aux=True)(p, score, key)
        updates, opt_state = optimizer.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state, m, grads

    params = jax.device_put(case["flax"], mesh.replicated)
    opt_state = jax.device_put(optimizer.init(case["flax"]), mesh.replicated)
    metrics, first = [], None
    for idx, key in zip(case["idx"], case["keys"]):
        (score,) = shard_batch(mesh, (case["rows"][idx],))
        params, opt_state, m, grads = step(params, opt_state, score, jax.random.key(key))
        metrics.append(m)
        first = grads if first is None else first
    return metrics, measure_vae_from_flax(first), measure_vae_from_flax(params)


def _jax_fader(world, b=1):
    return JaxFaderTrainer(_DspritesName(), FlaxDspritesFader(),
                           disc_model=FlaxDisc(5, dropout_rate=0.0), lr=LR, beta=1.0, rand=0,
                           mesh=_mesh(world, b))


def _jax_fader_run(case, world):
    jt = _jax_fader(world, len(case["idx"][0]))
    state = jt.ensure_state()

    @jax.jit
    def step(state, inputs, labels):
        key = jax.random.key(0)
        new, m = jt._train_step_core(state, (inputs, labels), key)
        norm = jt.normalize_labels(labels)
        z = jt.model.apply({"params": state.params}, inputs, train=True,
                           rngs={"dropout": key}, method="encode_deterministic")
        disc_grads = jax.grad(lambda dp: jt.compute_disc_loss(
            jt.disc_model.apply({"params": dp}, z, train=True), norm))(state.disc_params)
        grads = jax.grad(lambda p: jt._fader_losses(p, new.disc_params, (inputs, labels),
                                                    key, True)[0])(state.params)
        return new, m, grads, disc_grads

    metrics, first = [], None
    for idx in case["idx"]:
        inputs, labels = shard_batch(jt.mesh, (_unpacked(case["rows"][idx]),
                                               case["labels"][idx]))
        state, m, grads, disc_grads = step(state, inputs, labels)
        metrics.append(m)
        first = (grads, disc_grads) if first is None else first

    def named(fader, disc):
        return {**{f"model.{k}": v for k, v in fader_from_flax(fader).items()},
                **{f"disc.{k}": v for k, v in fader_discriminator_from_flax(disc).items()}}

    return metrics, named(*first), named(state.params, state.disc_params)


@pytest.fixture(scope="module")
def jax_runs(cases, workdir):
    memo = {}

    def get(world, name):
        if (world, name) not in memo:
            case = cases[name]
            if case["kind"] == "dsprites":
                memo[world, name] = _jax_image_run(case, world)
            elif case["kind"] == "fader":
                memo[world, name] = _jax_fader_run(case, world)
            else:
                memo[world, name] = _jax_music_run(case, world, workdir)
        return memo[world, name]

    return get


def _check_grads(name, got, want, err_msg):
    atol = (GLSR_GRAD_ATOL_FRAC * float(want.abs().max()) if name == "glsr" else GRAD_ATOL)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0 if name == "glsr" else
                               GRAD_RTOL, atol=atol, err_msg=err_msg)


def _prefixed(name, d):
    return d if name == "fader" else {f"model.{k}": v for k, v in d.items()}


@pytest.mark.parametrize("world,name", JAX_RUNS)
def test_matches_the_jax_sharded_step(spawned, jax_runs, world, name):
    metrics, grads, params = jax_runs(world, name)
    grads, params = _prefixed(name, grads), _prefixed(name, params)
    res = spawned(world)[0][name]
    for i in range(STEPS):
        for k, want in metrics[i].items():
            if k in res["metrics"][i]:
                np.testing.assert_allclose(res["metrics"][i][k], float(want), rtol=LOSS_RTOL,
                                           atol=KLD_ATOL, err_msg=f"step {i} {k}")
    for k, want in grads.items():
        _check_grads(name, res["grads"][k], want, f"grad {k}")
    for k, want in params.items():
        np.testing.assert_allclose(res["params"][k].numpy(), want.numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)


# ---------------------------------------------------------------------------
# The two terms a data-parallel step could get wrong
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def loss_terms(tmp_path_factory):
    root = tmp_path_factory.mktemp("loss_terms")
    rng = np.random.RandomState(3)
    b = 12
    data = {"z": torch.from_numpy(rng.randn(b, 6).astype(np.float32)),
            "labels": torch.from_numpy(rng.rand(b, 4).astype(np.float32)),
            "dims": ((1, 0), (2, 1), (4, 3)),
            # rank 0's rows far from the prior, rank 1's near it: their own
            # KLDs straddle c, so |·−c| of each rank's mean is not of the whole's
            "mu": torch.from_numpy(np.concatenate([rng.randn(b // 2, 6) * 2.0,
                                                   rng.randn(b // 2, 6) * 0.1]
                                                  ).astype(np.float32)),
            "log_s": torch.from_numpy((rng.randn(b, 6) * 0.1).astype(np.float32))}
    from arvae_tpu_torch.ops.losses import kld_loss as port_kld

    whole = float(port_kld(data["mu"], data["log_s"], 1.0))
    data["capacity"] = whole * 0.5
    torch.save(data, root / "terms.pt")
    return data, ranks.run_ranks(2, "loss_terms_body", str(root))


def test_loss_terms_reg_gradient_at_two_ranks_is_one_ranks(loss_terms):
    from arvae_tpu_torch.ops.losses import total_reg_loss as port_reg

    data, res = loss_terms
    z = data["z"].clone().requires_grad_(True)
    reg = port_reg(z, data["labels"], data["dims"], 10.0, 1.0)
    reg.backward()
    for r in res:
        np.testing.assert_allclose(r["reg"], float(reg.detach()), rtol=LOSS_RTOL)
        want = z.grad[r["start"]:r["stop"]]
        np.testing.assert_allclose(r["reg_grad"].numpy(), want.numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
        # a gather whose backward sums over the ranks doubles it
        np.testing.assert_allclose(r["reg_grad_summed_gather"].numpy(), 2 * want.numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_loss_terms_capacity_kld_is_of_the_global_mean(loss_terms):
    from arvae_tpu_torch.ops.losses import kld_loss as port_kld

    data, res = loss_terms
    mu = data["mu"].clone().requires_grad_(True)
    kld = port_kld(mu, data["log_s"], 1.0, data["capacity"])
    kld.backward()
    whole = float(kld.detach())
    own = [r["kld_own"] for r in res]
    # the ranks' own terms straddle c: their mean is not the global term
    assert abs(np.mean(own) - whole) > 0.1 * whole
    for r in res:
        np.testing.assert_allclose(r["kld"], whole, rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["kld_grad"].numpy(), mu.grad[r["start"]:r["stop"]].numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)
