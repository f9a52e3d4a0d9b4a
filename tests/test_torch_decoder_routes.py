"""What the port's recurrence ops run at each decoder width and depth,
against the JAX package.

On a CUDA tensor ``gru_chain`` and ``tick_chain`` launch their kernels,
whose launch plans are pure functions of the shapes: the kernels plan
every width up to the reference's H=512 (the weight slices resident in
shared memory where they fit, streamed from L2 where they do not) and
tick GRUs of 1 to 4 layers, at V=130 or 34, E=10. A depth outside that
range raises ValueError naming H and L before any launch; these checks
need no card. On a CPU tensor both ops run their plain loops at any
width and depth.

A ``HierarchicalDecoder`` at H=256 or with 3 tick-GRU layers (the plain
loop, on the CPU; the card's kernels plan both) is held to the JAX
package's decoder (``lax.scan`` on the CPU) from the same weights at
B=8, z=8, V=20, teacher-forced in training and free-running in eval,
with dropout 0 (the packages draw dropout bits differently): weights
rtol 1e-5 / atol 1e-5, samples
exactly, the gradients of the decoder's parameters and of z under a
random cotangent rtol 1e-4 / atol 1e-5, as
``tests/test_torch_hier_decoder.py`` holds the 2-layer loop. At dropout
0.5 only the L-layer loop's masks are checked: the keep rate of each
gap's mask, and that the gaps draw different masks.

The op on a CPU tensor must be the plain loop, bitwise, dropout
included, with the 2 layers given in the kernel's operand order
(``chain_operands``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arvae_tpu.models.measure_vae import MeasureVAE as FlaxMeasureVAE
from arvae_tpu_torch.models.measure_vae import MeasureNoise, MeasureVAE
from arvae_tpu_torch.ops import gru_kernel as gk
from arvae_tpu_torch.ops import hier_decoder_kernel as hk
from arvae_tpu_torch.utils.convert import measure_vae_from_flax

V, E, Z, B, T = 20, 10, 8, 8, 24


@pytest.mark.parametrize("layers", [2, 3])
@pytest.mark.parametrize("h", [128, 192, 256, 512])
def test_kernels_plan_or_refuse_naming_the_width(h, layers):
    for v in (34, 130):
        for tpb in (6, 24):  # the SR decoder's one beat of 24 ticks plans alike
            fwd, bwd = hk.hier_plans(24, 256, h, 10, v, layers, tpb)
            assert fwd == hk.hier_plan(256, h, 10, v, layers)
            assert bwd == hk.chain_plan(24, 256, h, tpb)
            assert max(fwd.smem_bytes, bwd.smem_bytes) <= gk.MAX_SMEM
            # the resident layouts wherever they fit
            assert fwd.streamed == ((h, layers) not in ((128, 2), (128, 3), (192, 2)))
            assert bwd.streamed == (h >= 384)
        # a depth outside the kernels' range is refused, naming H and L
        with pytest.raises(ValueError, match=f"H={h}, L={layers + 3}"):
            hk.hier_plans(24, 256, h, 10, v, layers + 3, 6)
    for d in (1, 2):
        for backward in (False, True):
            plan = gk.gru_plan(d, 256, h, backward)
            assert plan.smem_bytes <= gk.MAX_SMEM
            assert plan.streamed == (h > 320)


@pytest.mark.parametrize("layers", [2, 3])
def test_cpu_tensors_run_the_plain_loop_at_any_depth(layers):
    score, floats = _chain_operands(0, layers=layers)
    gk.reset_launches()
    hk.reset_launches()
    weights, samples = hk.tick_chain(T, True, 0.0, 6, "argmax", torch.ones(1, dtype=torch.int32),
                                     torch.zeros(1, dtype=torch.int32), score, *floats)
    assert weights.shape == (T, B, V) and samples.shape == (T, B)
    assert hk.LAUNCHES == {"fwd": 0, "bwd": 0} == gk.LAUNCHES


def _chain_operands(seed, layers=2, h=16, b=B, v=V, tpb=6):
    """(score (T, B), tick_chain's float operands with ``layers``)."""
    rng = np.random.RandomState(seed)
    nb = -(-T // tpb)

    def w(*shape, s=None):
        x = rng.randn(*shape) * (s if s is not None else 1 / np.sqrt(shape[0]))
        return torch.tensor(x, dtype=torch.float32)

    stack = [{"w_hh": w(h, 3 * h), "b_hh": w(3 * h, s=0.1)}]
    stack += [{"w_ih": w(h, 3 * h), "b_ih": w(3 * h, s=0.1), "w_hh": w(h, 3 * h),
               "b_hh": w(3 * h, s=0.1)} for _ in range(layers - 1)]
    floats = (w(nb, b, 3 * h, s=0.5), w(nb, layers, b, h, s=0.5), w(b, E, s=0.5),
              w(v, E, s=1.0), w(E, 3 * h), stack, w(h, v), w(v, s=0.1))
    score = torch.tensor(rng.randint(0, v, (T, b)), dtype=torch.int32)
    return score, floats


@pytest.mark.parametrize("train,rate,teacher,sampling",
                         [(True, 0.5, 1, "argmax"), (True, 0.0, 0, "argmax"),
                          (False, 0.5, 0, "argmax"), (True, 0.5, 0, "multinomial")])
def test_two_layer_loop_is_the_op_on_cpu_bitwise(train, rate, teacher, sampling):
    score, (gi_beat, tick_h0, x0, emb, w_ih0e, stack, out_w, out_b) = _chain_operands(1)
    ints = (torch.tensor([teacher], dtype=torch.int32), torch.tensor([9], dtype=torch.int32))
    got = hk.tick_chain_reference(train, rate, 6, sampling, *ints, score, gi_beat, tick_h0, x0,
                                  emb, w_ih0e, stack, out_w, out_b, hiddens=True)
    assert len(got) == 4
    # the kernel's operand order names the same two layers
    l0, l1 = stack
    flat = (gi_beat, tick_h0, x0, emb, w_ih0e, l0["w_hh"], l0["b_hh"], l1["w_ih"], l1["b_ih"],
            l1["w_hh"], l1["b_hh"], out_w, out_b)
    want = hk.tick_chain_reference(train, rate, 6, sampling, *ints, score,
                                   *hk.chain_operands(flat), hiddens=True)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    # the op on a CPU tensor is the same loop
    op = hk.tick_chain(T, train, rate, 6, sampling, *ints, score, gi_beat, tick_h0, x0, emb,
                       w_ih0e, stack, out_w, out_b)
    assert torch.equal(op[0], got[0]) and torch.equal(op[1], got[1])


def test_deep_loop_draws_a_mask_a_gap():
    seed = torch.tensor([11], dtype=torch.int32)
    masks = [hk.dropout_mask(seed, 3, 256, 128, 0.5, hk.SALT_DROPOUT + gap) for gap in range(2)]
    for m in masks:  # 32,768 Bernoulli(0.5) draws each: sd 0.0028
        assert set(m.unique().tolist()) == {0.0, 2.0}
        assert abs(float((m > 0).float().mean()) - 0.5) < 0.02
    assert torch.equal(masks[0], hk.dropout_mask(seed, 3, 256, 128, 0.5))  # gap 0: the kernel's
    assert not torch.equal(masks[0], masks[1])
    # a 3-layer loop: dropout moves the logits in training, not in eval
    score, floats = _chain_operands(2, layers=3)
    ints = (torch.ones(1, dtype=torch.int32), seed)

    def run(train, rate):
        return hk.tick_chain_reference(train, rate, 6, "argmax", *ints, score, *floats)[0]

    assert not torch.equal(run(True, 0.5), run(True, 0.0))
    assert torch.equal(run(False, 0.5), run(True, 0.0))


def _models(h, layers):
    widths = dict(num_notes=V, note_embedding_dim=E, num_encoder_layers=2,
                  encoder_hidden_size=16, encoder_dropout_prob=0.0, latent_space_dim=Z,
                  num_decoder_layers=layers, decoder_hidden_size=h,
                  decoder_dropout_prob=0.0)
    model = FlaxMeasureVAE(**widths)
    k = jax.random.split(jax.random.key(0), 3)
    params = model.init({"params": k[0], "sample": k[1], "dropout": k[2]},
                        jnp.zeros((1, T), jnp.int32), train=True)["params"]
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.RandomState(1)
    leaves = [x if np.ndim(x) > 1 else
              jnp.asarray(0.1 * rng.randn(*np.shape(x)).astype(np.float32))
              for x in leaves]
    params = jax.tree_util.tree_unflatten(tree, leaves)
    port = MeasureVAE(**widths)
    port.load_state_dict(measure_vae_from_flax(params))
    return model, params, port


@pytest.mark.parametrize("train", [True, False], ids=["train_teacher", "eval"])
@pytest.mark.parametrize("h,layers", [(256, 2), (32, 3)], ids=["wide", "deep"])
def test_wide_and_deep_decoders_match_jax(h, layers, train):
    fwd, bwd = hk.hier_plans(T, 256, h, E, V, layers, 6)  # the card plans this decoder
    assert max(fwd.smem_bytes, bwd.smem_bytes) <= gk.MAX_SMEM
    model, params, port = _models(h, layers)
    rng = np.random.RandomState(h + layers)
    z = rng.randn(B, Z).astype(np.float32)
    score = rng.randint(0, V, (B, T)).astype(np.int32)
    ct = rng.randn(B, T, V).astype(np.float32)
    key = jax.random.key(3)  # the hierarchical decoder's coin: teacher-forced
    teacher = bool(jax.random.uniform(jax.random.split(key, 3)[0], ()) < 0.5) and train
    assert teacher == train

    def jax_decode(p, zz):
        return model.apply({"params": p}, zz, jnp.asarray(score), train=train, key=key,
                           method="decode")

    (w_jax, s_jax), vjp = jax.vjp(jax_decode, params, jnp.asarray(z))
    g_params, g_z = vjp((jnp.asarray(ct), np.zeros((B, T), jax.dtypes.float0)))

    zt = torch.from_numpy(z).requires_grad_(True)
    noise = MeasureNoise(torch.zeros(B, Z), torch.zeros(B, Z),
                         torch.tensor([int(teacher)], dtype=torch.int32),
                         torch.tensor([7], dtype=torch.int32))
    w, s = port.decode(zt, torch.from_numpy(score), noise, train=train)
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_jax))
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(w_jax), rtol=1e-5, atol=1e-5)
    (w * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(g_z), rtol=1e-4, atol=1e-5)
    want = measure_vae_from_flax(g_params)
    for name, p in port.named_parameters():
        if name.startswith("decoder."):
            np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=name)


@pytest.mark.parametrize("flags,tag", [
    (["--decoder_type", "sr"], "_SRDecoder"),
    (["--decoder_type", "sr-no-input"], "_SRDecoderNoInput"),
    (["--decoder_hidden_size", "256"], ""),
    (["--num_decoder_layers", "3"], ""),
], ids=["sr", "sr-no-input", "wide", "deep"])
def test_cli_trains_every_decoder_one_epoch(flags, tag, tmp_path, monkeypatch):
    from arvae_tpu_torch import train_measure_vae

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("ARVAE_DATASETS_DIR", str(tmp_path / "datasets"))
    monkeypatch.setenv("ARVAE_MODELS_DIR", str(tmp_path / "models"))
    argv = ["--device", "cpu", "--short", "--num_epochs", "1", "--batch_size", "256",
            "--rand", "0", "-r", "all", "--encoder_hidden_size", "16",
            "--decoder_hidden_size", "16"] + flags
    (trainer,) = train_measure_vae.main(argv)
    assert np.isfinite(trainer.history[0]["train_loss"])
    assert trainer.model_repr() == f"folk_MeasureVAE{tag}_r_0_b_0.001_g_1.0_d_10.0_all_"
