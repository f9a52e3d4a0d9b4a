"""The hand-written CUDA kernels of the music slice (``gru_chain`` and
``hier_tick_chain``, forward and backward) against their plain PyTorch
versions on the card, at the shapes ``chip_smoke.py`` uses. Marked
``gpu``: without a CUDA card every case skips.

Run on the card with
``python -m pytest --noconftest tests/test_torch_music_kernels_cuda.py``.

Tolerances, as ``chip_smoke.py`` states them: forward rtol 1e-4 with an
absolute floor of 1e-5 (a chain of 24 dependent steps whose products
sum in another order than cuBLAS's); gradients rtol 1e-4 with an
absolute floor of 1e-5 times the largest magnitude of the plain
gradient (weight gradients sum T·B terms with cancellation). Repeats
of a kernel must be bitwise equal. The dropout masks of the kernel and
of the plain version are bitwise equal if the dropout-0.5 case matches:
a keep bit that differs moves a layer-1 input by 2·h0, far outside the
tolerance. The tick-loop cases run at V=34 (the music CLI's corpus) and
V=130 (the step-rate cell), and at a ragged B=100, and in eval mode
(``train=False``, as GLSR's decodes run it) at 6 and 24 ticks a beat.
The reference's own widths and the tick GRU's other depths run on the
kernels too: ``gru_chain`` at H=384 and 512 (the streamed layout), the
tick loop at H=256 and 512 with 2 layers and at H=128 with 1, 3 and 4
(teacher-forced, free-running with dropout 0.5, eval, and the SR
decoder's one beat of 24 ticks), and decoders at those shapes launch
their kernels; a depth outside 1 to 4 raises ValueError, naming H and
L, before any launch. A free-running decode is compared by
the teacher trick: the plain version runs teacher-forced on the
kernel's samples, and each kernel sample must be the lowest-index
argmax of the kernel's own logits."""

import numpy as np
import pytest
import torch

from arvae_tpu_torch.models.measure_vae import MeasureNoise
from arvae_tpu_torch.ops import gru_kernel as gk
from arvae_tpu_torch.ops import hier_decoder_kernel as hk

pytestmark = pytest.mark.gpu

FWD_RTOL, FWD_ATOL = 1e-4, 1e-5
GRAD_RTOL, GRAD_ATOL_FRAC = 1e-4, 1e-5
# the music step's two layer shapes, SRDecoderNoInput's layer, a ragged
# batch, a second width, and an odd width (no cluster divides H = 21: one
# CTA a cluster, rows that are not 16-byte aligned)
GRU_CASES = [(24, 2, 256, 128), (4, 1, 256, 128), (24, 1, 256, 128), (24, 2, 100, 128),
             (24, 2, 256, 64), (4, 1, 256, 64), (6, 2, 20, 21),
             # the reference's widths, streamed: the 512-wide encoder and beat
             # layers, SRDecoderNoInput's at 384, a ragged batch
             (24, 2, 256, 512), (4, 1, 256, 512), (24, 1, 256, 384), (24, 2, 100, 512)]
# (H, tick-GRU layers) beyond the music step's
WIDE_DEEP = [(256, 2), (512, 2), (128, 1), (128, 3), (128, 4)]
HB, HH, HE, HT, HTPB = 256, 128, 10, 24, 6
HVS = (34, 130)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, rtol, atol, name=""):
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol, msg=lambda m: f"{name}: {m}")


def _close_grad(got, want, name=""):
    _close(got, want, GRAD_RTOL, GRAD_ATOL_FRAC * float(want.abs().max()) + 1e-12, name)


# ---------------------------------------------------------------------------
# gru_chain
# ---------------------------------------------------------------------------


def _gru_inputs(t, d, b, h, dev, seed=0):
    rng = np.random.RandomState(seed)

    def f(*shape, s):
        return torch.tensor(rng.randn(*shape) * s, dtype=torch.float32, device=dev)

    return (f(t, d, b, 3 * h, s=0.5), f(d, h, 3 * h, s=1 / np.sqrt(h)),
            f(d, 3 * h, s=0.1), f(d, b, h, s=0.3)), f(t, d, b, h, s=1.0)


@pytest.mark.parametrize("t,d,b,h", GRU_CASES)
def test_gru_chain_matches_plain_and_repeats_bitwise(dev, t, d, b, h):
    args, ct = _gru_inputs(t, d, b, h, dev, seed=t * 1000 + b)
    runs = [(gk.gru_chain_fwd_cuda(*args),) for _ in range(2)]
    runs = [r + gk.gru_chain_bwd_cuda(*args, r[0], ct) for r in runs]
    torch.cuda.synchronize()
    for x, y in zip(*runs):
        assert torch.equal(x, y)
    outs, dgi, dw, db, dh0 = runs[0]
    leaves = [a.clone().requires_grad_(True) for a in args]
    want = gk.gru_chain_reference(*leaves)
    (want * ct).sum().backward()
    _close(outs, want.detach(), FWD_RTOL, FWD_ATOL, "outs")
    for g, leaf, name in zip((dgi, dw, db, dh0), leaves, ("dgi", "dw_hh", "db_hh", "dh0")):
        _close_grad(g, leaf.grad, name)


def test_gru_chain_autograd_launches_kernels(dev):
    args, ct = _gru_inputs(24, 2, 64, 128, dev, seed=5)
    leaves = [a.clone().requires_grad_(True) for a in args]
    gk.reset_launches()
    (gk.gru_chain(*leaves) * ct).sum().backward()
    assert gk.LAUNCHES == {"fwd": 1, "bwd": 1}
    ref = [a.clone().requires_grad_(True) for a in args]
    (gk.gru_chain_reference(*ref) * ct).sum().backward()
    for a, b in zip(leaves, ref):
        _close_grad(a.grad, b.grad)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("h", [64, 128, 256, 384, 512])
def test_gru_plan_mirrors_the_kernel_layout(dev, h, backward):
    plan = gk.gru_plan(2, 256, h, backward)
    lib = gk._library()
    assert 4 * lib.gru_chain_smem_floats(int(backward), h, plan.clusters, plan.rows,
                                         int(plan.streamed)) == plan.smem_bytes
    held = lib.gru_chain_resident_clusters(int(backward), int(plan.streamed), plan.clusters,
                                           plan.smem_bytes)
    if plan.streamed:  # the plan's count of the clusters the card holds at once
        assert held == gk.held_clusters(plan, "gru_bwd" if backward else "gru_fwd")


def test_gru_chain_rejects_bad_inputs(dev):
    args, _ = _gru_inputs(4, 1, 8, 16, dev)
    with pytest.raises(ValueError, match="contiguous float32"):
        gk.gru_chain_fwd_cuda(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="h0 must be"):
        gk.gru_chain_fwd_cuda(*args[:3], args[3][:, :4])


# ---------------------------------------------------------------------------
# hier_tick_chain
# ---------------------------------------------------------------------------


def _hier_inputs(dev, seed, v, tpb=HTPB, zero=False, b=HB, h=HH, layers=2):
    rng = np.random.RandomState(seed)
    nb = -(-HT // tpb)

    def w(*shape, s=None):
        x = rng.randn(*shape) * (s if s is not None else 1 / np.sqrt(shape[0]))
        return torch.tensor(0 * x if zero else x, dtype=torch.float32, device=dev)

    floats = [w(nb, b, 3 * h, s=0.5), w(nb, layers, b, h, s=0.5), w(b, HE, s=0.5),
              w(v, HE, s=1.0), w(HE, 3 * h), w(h, 3 * h), w(3 * h, s=0.1)]
    for _ in range(layers - 1):
        floats += [w(h, 3 * h), w(3 * h, s=0.1), w(h, 3 * h), w(3 * h, s=0.1)]
    floats += [w(h, v), w(v, s=0.1)]
    score = torch.tensor(rng.randint(0, v, (HT, b)), dtype=torch.int32, device=dev)
    ct = torch.tensor(rng.randn(HT, b, v), dtype=torch.float32, device=dev)
    return score, floats, ct


def _ints(teacher, seed, dev):
    return (torch.tensor([teacher], dtype=torch.int32, device=dev),
            torch.tensor([seed], dtype=torch.int32, device=dev))


def _kernel_run(cfg, teacher, seed, score, floats, ct=None):
    """The forward kernel, and the backward under ``ct`` when given,
    twice; asserts bitwise repeats."""
    train, rate, tpb, sampling = cfg
    runs = []
    for _ in range(2):
        weights, samples, *hiddens = hk.hier_tick_chain_fwd_cuda(
            train, rate, tpb, sampling, teacher, seed, score, *floats)
        grads = () if ct is None else hk.hier_tick_chain_bwd_cuda(
            train, rate, tpb, seed, samples, hiddens, weights, ct, *floats)
        runs.append((weights, samples) + tuple(grads))
    torch.cuda.synchronize()
    for x, y in zip(*runs):  # bitwise, so that a NaN repeats equal to itself
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    return runs[0][0], runs[0][1], runs[0][2:]


def _plain_run(cfg, teacher, seed, score, floats, ct=None):
    train, rate, tpb, sampling = cfg
    leaves = [f.clone().requires_grad_(ct is not None) for f in floats]
    weights, samples = hk.tick_chain_reference(train, rate, tpb, sampling, teacher, seed,
                                               score, *hk.chain_operands(leaves))
    if ct is None:
        return weights, samples, []
    (weights * ct).sum().backward()
    return weights.detach(), samples, [x.grad for x in leaves]


def _compare(cfg, kernel_in, plain_in, floats, ct):
    """Kernel (teacher, seed, score) against plain (teacher, seed, score):
    samples equal, weights and every float operand's gradient within
    tolerance.

    A pre-activation within rounding of the ReLU kink can land on either
    side in the two versions (sums in another order), and its mask then
    routes a whole row's gradient differently. So the cotangent is
    zeroed where the two forwards disagree on the sign of a logit, which
    must be rare: at most 1e-4 of the entries."""
    w_k = _kernel_run(cfg, *kernel_in, floats)[0]
    w_p = _plain_run(cfg, *plain_in, floats)[0]
    agree = (w_k > 0) == (w_p > 0)
    assert int((~agree).sum()) <= 1e-4 * agree.numel()
    ct = ct * agree
    w_k, s_k, g_k = _kernel_run(cfg, *kernel_in, floats, ct)
    w_p, s_p, g_p = _plain_run(cfg, *plain_in, floats, ct)
    assert torch.equal(s_k, s_p)
    _close(w_k, w_p, FWD_RTOL, FWD_ATOL, "weights")
    for g, want, name in zip(g_k, g_p, hk.float_operands(hk.layers_of(floats))):
        _close_grad(g, want, name)
    return w_k, s_k


@pytest.mark.parametrize("v", HVS)
@pytest.mark.parametrize("tpb", [HTPB, HT, 5], ids=["hier", "one_beat", "padded_beat"])
def test_hier_teacher_forced_matches_plain(dev, tpb, v):
    score, floats, ct = _hier_inputs(dev, 1, v, tpb)
    cfg = (True, 0.0, tpb, "argmax")
    inputs = _ints(1, 3, dev) + (score,)
    _, samples = _compare(cfg, inputs, inputs, floats, ct)
    assert torch.equal(samples, score)


@pytest.mark.parametrize("tpb", [HTPB, HT], ids=["hier", "one_beat"])
def test_hier_ragged_batch_matches_plain(dev, tpb):
    """B=100 is a multiple of no row tile: the tiles' masks and the
    weight-gradient GEMM's (t, b) indexing at a ragged edge."""
    score, floats, ct = _hier_inputs(dev, 9, HVS[-1], tpb, b=100)
    inputs = _ints(1, 3, dev) + (score,)
    _, samples = _compare((True, 0.0, tpb, "argmax"), inputs, inputs, floats, ct)
    assert torch.equal(samples, score)


@pytest.mark.parametrize("v", HVS)
def test_hier_free_running_matches_plain_by_the_teacher_trick(dev, v):
    score, floats, ct = _hier_inputs(dev, 2, v)
    cfg = (True, 0.0, HTPB, "argmax")
    free = _ints(0, 3, dev) + (score,)
    w_k, s_k, _ = _kernel_run(cfg, *free, floats)
    assert torch.equal(s_k, hk.argmax_lowest(w_k).clamp(0, v - 1).to(torch.int32))
    _compare(cfg, free, _ints(1, 3, dev) + (s_k,), floats, ct)


@pytest.mark.parametrize("v", HVS)
def test_hier_dropout_masks_match_plain_in_train(dev, v):
    seed = torch.tensor([123457], dtype=torch.int32, device=dev)
    kept = float((hk.dropout_mask(seed, HT - 1, HB, HH, 0.5) > 0).float().mean())
    assert abs(kept - 0.5) < 0.02  # 32,768 draws: sd 0.0028
    score, floats, ct = _hier_inputs(dev, 4, v)
    cfg = (True, 0.5, HTPB, "argmax")
    teacher = torch.ones(1, dtype=torch.int32, device=dev)
    w_drop, _ = _compare(cfg, (teacher, seed, score), (teacher, seed, score), floats, ct)
    no_drop = _kernel_run((True, 0.0, HTPB, "argmax"), teacher, seed, score, floats)
    assert not torch.equal(w_drop, no_drop[0])
    evaluated = _kernel_run((False, 0.5, HTPB, "argmax"), teacher, seed, score, floats)
    assert torch.equal(evaluated[0], no_drop[0])


@pytest.mark.parametrize("v", HVS)
def test_hier_multinomial_in_distribution(dev, v):
    score, floats, ct = _hier_inputs(dev, 6, v, zero=True)
    peak = v // 2
    floats[-1][peak] = 1e4  # peaked logits: Gumbel-max is the argmax
    cfg = (True, 0.0, HTPB, "multinomial")
    teacher, seed = _ints(0, 9, dev)
    _, s_peak, _ = _kernel_run(cfg, teacher, seed, score, floats)
    assert bool((s_peak == peak).all())
    floats[-1].zero_()  # uniform logits: samples spread over the vocabulary
    _, s_flat, _ = _kernel_run(cfg, teacher, seed, score, floats)
    counts = torch.bincount(s_flat.flatten().long(), minlength=v)
    assert int((counts > 0).sum()) == v  # 6,144 draws, 47.3 a token expected at V=130
    assert int(counts.max()) < 2 * HT * HB // v


@pytest.mark.parametrize("h,layers", [(HH, 2)] + WIDE_DEEP)
@pytest.mark.parametrize("v", HVS)
def test_hier_plan_mirrors_the_kernel_layout(dev, v, h, layers):
    plan = hk.hier_plan(HB, h, HE, v, layers)
    lib = hk._library()
    assert 4 * lib.hier_tick_chain_smem_floats(h, HE, v, plan.clusters, plan.rows, layers,
                                               int(plan.streamed)) == plan.smem_bytes
    # the plan's count of the clusters the card holds at once is the card's
    assert lib.hier_tick_chain_resident_clusters(int(plan.streamed), plan.clusters,
                                                 plan.smem_bytes) == hk.held_clusters(plan)


def _flat(dev, v, peak_cols=(), nan_col=None):
    """Zero weights, out_b = 5 at ``peak_cols`` (NaN at ``nan_col``): the
    logits of every row and tick are out_b."""
    score, floats, _ = _hier_inputs(dev, 10, v, zero=True)
    for col in peak_cols:
        floats[-1][col] = 5.0
    if nan_col is not None:
        floats[-1][nan_col] = float("nan")
    return score, floats


def test_hier_argmax_tie_across_ctas_takes_the_lower_index(dev):
    v = HVS[-1]
    plan = hk.hier_plan(HB, HH, HE, v)
    edge = -(-v // plan.clusters)  # CTA 1's first vocabulary column
    score, floats = _flat(dev, v, (edge - 1, edge))
    cfg = (True, 0.0, HTPB, "argmax")
    _, samples, _ = _kernel_run(cfg, *_ints(0, 3, dev), score, floats)
    assert bool((samples == edge - 1).all())
    assert torch.equal(samples, _plain_run(cfg, *_ints(0, 3, dev), score, floats)[1])


def test_hier_nan_logit_samples_the_last_token(dev):
    v = HVS[-1]
    score, floats = _flat(dev, v, (3,), nan_col=7)
    cfg = (True, 0.0, HTPB, "argmax")
    w_k, s_k, _ = _kernel_run(cfg, *_ints(0, 3, dev), score, floats)
    assert bool((s_k == v - 1).all())  # NaN row: index V, clamped to V-1
    w_p, s_p, _ = _plain_run(cfg, *_ints(0, 3, dev), score, floats)
    assert torch.equal(s_k, s_p)
    torch.testing.assert_close(w_k, w_p, rtol=FWD_RTOL, atol=FWD_ATOL, equal_nan=True)


def test_hier_autograd_launches_kernels(dev):
    score, floats, ct = _hier_inputs(dev, 7, HVS[0])
    leaves = [f.clone().requires_grad_(True) for f in floats]
    hk.reset_launches()
    weights, samples = hk.tick_chain(HT, True, 0.0, HTPB, "argmax", *_ints(1, 3, dev), score,
                                     *hk.chain_operands(leaves))
    (weights * ct).sum().backward()
    assert hk.LAUNCHES == {"fwd": 1, "bwd": 1}
    assert samples.dtype == torch.int32 and not samples.requires_grad
    w_p, _, _ = _plain_run((True, 0.0, HTPB, "argmax"), *_ints(1, 3, dev), score, floats)
    _close(weights.detach(), w_p, FWD_RTOL, FWD_ATOL, "weights")


@pytest.mark.parametrize("v", HVS)
@pytest.mark.parametrize("tpb", [HTPB, HT], ids=["hier", "one_beat"])
def test_hier_eval_mode_matches_plain(dev, tpb, v):
    """``train=False``: free-running argmax with no dropout, forward and
    backward, as GLSR differentiates its eval decodes. A dropout rate
    passed in eval changes nothing: no mask is drawn or replayed."""
    score, floats, ct = _hier_inputs(dev, 11, v, tpb)
    cfg = (False, 0.5, tpb, "argmax")
    free = _ints(0, 3, dev) + (score,)
    w_k, s_k, g_k = _kernel_run(cfg, *free, floats, ct)
    assert torch.equal(s_k, hk.argmax_lowest(w_k).clamp(0, v - 1).to(torch.int32))
    w_0, s_0, g_0 = _kernel_run((False, 0.0, tpb, "argmax"), *free, floats, ct)
    for x, y in zip((w_k, s_k, *g_k), (w_0, s_0, *g_0)):
        assert torch.equal(x, y)
    # the backward re-embeds the samples the free-running decode fed
    _compare(cfg, free, _ints(1, 3, dev) + (s_k,), floats, ct)


@pytest.mark.parametrize("h,layers", WIDE_DEEP)
def test_hier_wide_and_deep_match_plain(dev, h, layers):
    """Teacher-forced; free-running with dropout 0.5 (the teacher trick on
    the kernel's own samples with the same seed: every gap's mask bitwise
    equal); eval; and the SR decoder's one beat of 24 ticks."""
    v = HVS[-1]
    score, floats, ct = _hier_inputs(dev, 30 + layers, v, h=h, layers=layers)
    forced = _ints(1, 3, dev) + (score,)
    _compare((True, 0.0, HTPB, "argmax"), forced, forced, floats, ct)
    seed = torch.tensor([123457], dtype=torch.int32, device=dev)
    free = (torch.zeros(1, dtype=torch.int32, device=dev), seed, score)
    cfg = (True, 0.5, HTPB, "argmax")
    w_k, s_k, _ = _kernel_run(cfg, *free, floats)
    assert torch.equal(s_k, hk.argmax_lowest(w_k).clamp(0, v - 1).to(torch.int32))
    _compare(cfg, free, (torch.ones_like(free[0]), seed, s_k), floats, ct)
    free = _ints(0, 3, dev) + (score,)
    s_eval = _kernel_run((False, 0.5, HTPB, "argmax"), *free, floats)[1]
    _compare((False, 0.5, HTPB, "argmax"), free, _ints(1, 3, dev) + (s_eval,), floats, ct)
    score, floats, ct = _hier_inputs(dev, 40 + layers, v, HT, h=h, layers=layers)
    forced = _ints(1, 3, dev) + (score,)
    _compare((True, 0.0, HT, "argmax"), forced, forced, floats, ct)


def test_gru_chain_at_the_reference_width_launches_the_kernels(dev):
    args, ct = _gru_inputs(24, 2, 64, 512, dev, seed=3)
    leaves = [a.clone().requires_grad_(True) for a in args]
    gk.reset_launches()
    (gk.gru_chain(*leaves) * ct).sum().backward()
    assert gk.LAUNCHES == {"fwd": 1, "bwd": 1}
    ref = [a.clone().requires_grad_(True) for a in args]
    (gk.gru_chain_reference(*ref) * ct).sum().backward()
    for a, b in zip(leaves, ref):
        _close_grad(a.grad, b.grad)


def _decoder(dev, h, layers):
    from arvae_tpu_torch.models.measure_vae import MeasureVAE, draw_measure_noise

    dec = MeasureVAE(HVS[0], HE, latent_space_dim=32, num_decoder_layers=layers,
                     decoder_hidden_size=h, decoder_dropout_prob=0.0).decoder.to(dev)
    rng = np.random.RandomState(h + layers)
    z = torch.tensor(rng.randn(HB, 32), dtype=torch.float32, device=dev)
    score = torch.tensor(rng.randint(0, HVS[0], (HB, HT)), dtype=torch.int32, device=dev)
    noise = draw_measure_noise(HB, 32, torch.Generator(dev).manual_seed(0), dev)
    return dec, z, score, noise


@pytest.mark.parametrize("h,layers", [(256, 2), (512, 2), (128, 3), (128, 4), (128, 1)],
                         ids=["wide", "reference", "deep", "deeper", "shallow"])
def test_wide_and_deep_decoders_launch_the_tick_loop_kernels(dev, h, layers):
    dec, z, score, noise = _decoder(dev, h, layers)
    zz = z.clone().requires_grad_(True)
    gk.reset_launches()
    hk.reset_launches()
    weights, _ = dec(zz, score, noise, train=True)
    weights.sum().backward()
    assert hk.LAUNCHES == {"fwd": 1, "bwd": 1}
    assert gk.LAUNCHES == {"fwd": layers, "bwd": layers}  # the beat GRU's layers
    assert bool(torch.isfinite(weights).all()) and bool(torch.isfinite(zz.grad).all())


def test_a_tick_gru_depth_outside_the_range_raises_before_the_tick_loop_launches(dev):
    dec, z, score, noise = _decoder(dev, HH, 5)
    hk.reset_launches()
    with pytest.raises(ValueError, match=f"H={HH}, L=5"):
        dec(z, score, noise, train=True)
    assert hk.LAUNCHES == {"fwd": 0, "bwd": 0}
