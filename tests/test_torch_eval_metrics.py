"""The port's metric suite (numpy and scipy only) against the JAX
package's, which calls scikit-learn.

Each metric runs on the same arrays on both sides: the JAX one under
``np.random.seed(s)`` (scikit-learn's MI estimator jitters through
numpy's global generator), the port's with ``np.random.RandomState(s)``.
Every number must agree within 1e-12, which in practice means bit for
bit: the port copies scikit-learn's arithmetic step by step, in the
same dtypes. Fixtures: the continuous one of ``tests/test_metrics.py``
(its golden MIG and modularity are reproduced), float32 latents with
float32 attributes whose values tie as dSprites' factor values do,
music-like attributes (fractions of 24 and 26 ticks), a constant
attribute column and a constant latent dim.
"""

import ast
import pathlib
import warnings

import numpy as np
import pytest
from sklearn.feature_selection import mutual_info_regression as sk_mutual_info
from sklearn.linear_model import LinearRegression

import arvae_tpu.eval.metrics as jm
from arvae_tpu_torch.eval import metrics as pm

ATOL = 1e-12
N = 500


def _continuous():
    """tests/test_metrics.py's golden fixture."""
    rng = np.random.RandomState(1234)
    z = rng.randn(400, 8).astype(np.float64)
    attrs = np.stack([2.0 * z[:, 0] + 0.05 * rng.randn(400),
                      -1.5 * z[:, 3] + 0.3 * z[:, 5] + 0.05 * rng.randn(400),
                      0.7 * z[:, 1] + 0.7 * z[:, 2] + 0.05 * rng.randn(400)], axis=1)
    return z, attrs


def _dsprites_like():
    """float32 codes; float32 attributes on dSprites' factor values
    (shape, scale, orientation, posx, posy), so most rows tie."""
    rng = np.random.RandomState(5)
    values = [np.arange(1, 4.0), np.linspace(0.5, 1.0, 6), np.linspace(0, 2 * np.pi, 40),
              np.linspace(0, 1, 32), np.linspace(0, 1, 32)]
    attrs = np.stack([rng.choice(v, N) for v in values], 1).astype(np.float32)
    z = rng.randn(N, 10).astype(np.float32)
    z[:, 2] += attrs[:, 1] * 3
    z[:, 7] -= attrs[:, 3]
    return z, attrs


def _music_like():
    """The four music attributes' value sets: rhythm complexity and note
    density as counts of ticks, pitch range and contour in 26ths."""
    rng = np.random.RandomState(6)
    density = rng.randint(1, 12, N)
    attrs = np.stack([density / 17.0, rng.randint(0, 14, N) / 26.0, density / 24.0,
                      rng.randint(-8, 9, N) / 26.0], 1).astype(np.float32)
    z = rng.randn(N, 8).astype(np.float32)
    z[:, 0] += 4 * attrs[:, 2]
    return z, attrs


def _constant_attribute():
    rng = np.random.RandomState(7)
    z = rng.randn(N, 6).astype(np.float32)
    attrs = np.stack([z[:, 1] + 0.1 * rng.randn(N), np.full(N, 2.0)], 1).astype(np.float32)
    return z, attrs


def _constant_latent():
    z, attrs = _dsprites_like()
    z[:, 4] = 1.25
    return z, attrs


FIXTURES = {"continuous": _continuous, "dsprites_like_float32_ties": _dsprites_like,
            "music_like": _music_like, "constant_attribute": _constant_attribute,
            "constant_latent_dim": _constant_latent}


def _names(attrs):
    return [f"a{i}" for i in range(attrs.shape[1])]


def _jax_metric(name, z, a, seed):
    np.random.seed(seed)
    if name == "interpretability":
        return jm.compute_interpretability_metric(z, a, _names(a))
    return getattr(jm, name)(z, a)


def _port_metric(name, z, a, seed):
    rng = np.random.RandomState(seed)
    if name == "interpretability":
        return pm.compute_interpretability_metric(z, a, _names(a), rng)
    if name in ("compute_mig", "compute_modularity"):
        return getattr(pm, name)(z, a, rng)
    return getattr(pm, name)(z, a)


def _assert_same(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, tuple):  # interpretability: (dim, score)
            assert g[0] == w[0], k
            assert g[1] == pytest.approx(w[1], abs=ATOL), k
        else:
            assert g == pytest.approx(w, abs=ATOL), k


@pytest.mark.parametrize("metric", ["interpretability", "compute_mig", "compute_modularity",
                                    "compute_correlation_score", "compute_sap_score"])
@pytest.mark.parametrize("fixture", list(FIXTURES))
def test_metric_matches_jax(fixture, metric):
    z, a = FIXTURES[fixture]()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # MIG's zero-entropy warning
        want = _jax_metric(metric, z, a, seed=3)
        got = _port_metric(metric, z, a, seed=3)
    _assert_same(got, want)


@pytest.mark.parametrize("fixture", ["dsprites_like_float32_ties", "music_like"])
def test_suite_with_one_rng_matches_jax_under_one_seed(fixture):
    """compute_all threads one RandomState through the metrics in the
    JAX trainers' order; the JAX suite in that order draws the same
    jitter from the global generator seeded once."""
    z, a = FIXTURES[fixture]()
    np.random.seed(11)
    want = {"interpretability": jm.compute_interpretability_metric(z, a, _names(a))}
    want.update(jm.compute_correlation_score(z, a))
    want.update(jm.compute_modularity(z, a))
    want.update(jm.compute_mig(z, a))
    want.update(jm.compute_sap_score(z, a))
    got = pm.compute_all(z, a, _names(a), np.random.RandomState(11))
    assert list(got) == list(want)
    _assert_same(got["interpretability"], want.pop("interpretability"))
    got.pop("interpretability")
    _assert_same(got, want)


def test_golden_mig_and_modularity():
    z, a = _continuous()
    assert pm.compute_mig(z, a, np.random.RandomState(0))["mig"] == pytest.approx(
        0.36253347424653054, abs=ATOL)
    assert pm.compute_modularity(z, a, np.random.RandomState(0))[
        "modularity_score"] == pytest.approx(0.8199665626389419, abs=ATOL)


def test_mi_of_tied_column_keeps_its_dtype():
    """A float32 target keeps float32 through the scaling and jitter, so
    its ties stay ties: the self-MI of a 4-valued column is another number
    in float32 than in float64, and the port gives scikit-learn's for each."""
    col = np.random.RandomState(2).randint(0, 4, 1000)
    got = {}
    for dtype in (np.float32, np.float64):
        a = col.astype(dtype)
        np.random.seed(0)
        want = sk_mutual_info(a.reshape(-1, 1), a)[0]
        got[dtype] = pm.mutual_info_regression(a.reshape(-1, 1), a,
                                               np.random.RandomState(0))[0]
        assert got[dtype] == pytest.approx(want, abs=ATOL)
    assert abs(got[np.float32] - got[np.float64]) > 1e-3


@pytest.mark.parametrize("fixture", list(FIXTURES))
def test_mi_estimator_and_linear_fit_match_sklearn(fixture):
    z, a = FIXTURES[fixture]()
    for j in range(a.shape[1]):
        np.random.seed(j)
        want = sk_mutual_info(z, a[:, j])
        np.testing.assert_allclose(pm.mutual_info_regression(z, a[:, j],
                                                             np.random.RandomState(j)),
                                   want, rtol=0, atol=ATOL)
        for d in range(z.shape[1]):
            x = z[:, d:d + 1]
            want = LinearRegression().fit(x, a[:, j]).score(x, a[:, j])
            assert pm.linear_r2(x, a[:, j]) == pytest.approx(want, abs=ATOL), (j, d)


def test_degenerate_columns():
    z, a = _constant_attribute()
    with pytest.warns(RuntimeWarning, match="zero kNN self-entropy"):
        mig = pm.compute_mig(z, a, np.random.RandomState(0))["mig"]
    assert np.isfinite(mig)
    # the constant attribute's column of the SAP matrix is all 0
    assert not pm._compute_score_matrix(z, a)[:, 1].any()
    assert np.isfinite(pm.compute_sap_score(z, a)["SAP_score"])
    # a constant latent dim fits no line: R² 0; a constant attribute that
    # is fit exactly (force_finite): 1
    z, a = _constant_latent()
    assert pm.linear_r2(z[:, 4:5], a[:, 0]) == 0.0
    assert pm.linear_r2(z[:, :1], np.full(N, 3.0, np.float32)) == 1.0


def test_normalize_data_matches():
    x = np.random.RandomState(3).randn(50, 4) * 7.0 + 3.0
    for got, want in zip(pm.normalize_data(x), jm.normalize_data(x)):
        np.testing.assert_array_equal(got, want)


def test_mi_takes_an_explicit_random_state():
    with pytest.raises(TypeError, match="RandomState"):
        pm.mutual_info_regression(np.zeros((5, 1)), np.zeros(5), None)


def test_metrics_import_only_numpy_scipy_and_the_standard_library():
    src = pathlib.Path(pm.__file__).read_text()
    roots = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert roots <= {"__future__", "math", "warnings", "numpy", "scipy"}, roots
