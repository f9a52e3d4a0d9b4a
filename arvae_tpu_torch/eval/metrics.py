"""Disentanglement metric suite on the host, with numpy and scipy only.

Counterpart of ``arvae_tpu/eval/metrics.py``: the same five metrics
(Interpretability, MIG, Modularity, SCC, SAP), the same schema and the
same degenerate-column guards. That module calls scikit-learn's
``mutual_info_regression`` and ``LinearRegression``; scikit-learn is
not on the card's machine, so both are rebuilt here step by step from
scikit-learn 1.9's arithmetic, in the same dtypes, so that the numbers
are the same to the last bit:

- :func:`mutual_info_regression` is the Kraskov (KSG) estimator with 3
  Chebyshev neighbours. ``X`` is cast to float64 and the target keeps
  its dtype: a float32 attribute column stays float32 through the
  scaling and the 1e-10 jitter, so the jitter rounds away and ties stay
  ties. Each call draws its jitter from the ``np.random.RandomState``
  it is given, ``X``'s first, then ``y``'s, as scikit-learn draws from
  numpy's global generator when it is given none: one RandomState
  seeded with ``s`` and passed through the metrics in the JAX package's
  order gives the JAX numbers under ``np.random.seed(s)``.
- :func:`linear_r2` is ``LinearRegression().fit(x, y).score(x, y)`` on
  one column: centring, scipy's ``lstsq`` (``cond=1e-6``), the
  intercept, and ``r2_score`` with its ``force_finite`` rule, in the
  column's dtype.
- :func:`discrete_mutual_info` is ``mutual_info_score(labels_true,
  labels_pred)``: every distinct value a category (``np.unique``), the
  contingency's nonzero cells in row-major order, natural logs, and the
  same operations in the same order.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
from scipy.linalg import lstsq
from scipy.spatial import cKDTree
from scipy.special import digamma
from scipy.stats import spearmanr

EVAL_METRIC_DICT = {
    "interpretability": "Interpretability",
    "modularity_score": "Modularity",
    "mig": "MIG",
    "SAP_score": "SAP",
    "Corr_score": "SCC",
}

N_NEIGHBORS = 3


# -- the KSG estimator ---------------------------------------------------------


def _first_true(pred, n):
    """Per row i, the least j in [0, n] with ``pred(j)[i]``, for a
    predicate that is False then True along j (a vectorised bisection)."""
    lo = np.zeros(n, np.intp)
    hi = np.full(n, n, np.intp)
    while True:
        open_ = lo < hi
        if not open_.any():
            return lo
        mid = (lo + hi) // 2
        ok = np.zeros(n, bool)
        ok[open_] = pred(mid[open_], open_)
        hi = np.where(open_ & ok, mid, hi)
        lo = np.where(open_ & ~ok, mid + 1, lo)


def _count_within(v, radius):
    """#{j : |v_j − v_i| <= radius_i} for each i, computed with the same
    float64 difference and comparison that a Chebyshev KD-tree's radius
    query makes. The difference is monotone in v_j, so the points within
    the radius are a run of the sorted values; its ends are found by
    bisection on the exact predicate (a ``searchsorted`` on v_i ± r_i
    would round the bound and flip boundary points)."""
    v = np.asarray(v, np.float64)
    s = np.sort(v)
    n = len(v)

    # first j whose s_j is not left of the ball: s_j >= v_i or v_i − s_j <= r_i
    def inside_or_right(j, rows):
        sj, vi, ri = s[j], v[rows], radius[rows]
        return (sj >= vi) | (vi - sj <= ri)

    # first j right of the ball: s_j − v_i > r_i
    def right_of(j, rows):
        return s[j] - v[rows] > radius[rows]

    return _first_true(right_of, n) - _first_true(inside_or_right, n)


def _compute_mi_cc(x, y, n_neighbors=N_NEIGHBORS):
    """KSG mutual information of two continuous columns, clipped at 0."""
    n_samples = x.size
    xy = np.hstack((x.reshape((-1, 1)), y.reshape((-1, 1))))
    # the distance to the k-th neighbour in the joint space, the point
    # itself excluded (it is the first of the k + 1 nearest)
    dist = cKDTree(xy).query(xy, k=n_neighbors + 1, p=np.inf)[0]
    radius = np.nextafter(dist[:, -1], 0)
    nx = np.array(_count_within(x, radius)) - 1.0
    ny = np.array(_count_within(y, radius)) - 1.0
    mi = (digamma(n_samples) + digamma(n_neighbors)
          - np.mean(digamma(nx + 1)) - np.mean(digamma(ny + 1)))
    return max(0, mi)


def mutual_info_regression(X, y, rng: np.random.RandomState):
    """MI of each column of ``X`` with the continuous target ``y``
    (scikit-learn's ``mutual_info_regression`` with its defaults and
    ``random_state=rng``)."""
    if not isinstance(rng, np.random.RandomState):
        raise TypeError("mutual_info_regression takes an explicit np.random.RandomState")
    X = np.asarray(X)
    y = np.ravel(np.asarray(y))
    if X.ndim != 2 or len(X) != len(y):
        raise ValueError(f"X {X.shape} and y {y.shape} do not pair up")
    if y.dtype.kind not in "fc":
        y = y.astype(np.float64)
    n_samples, n_features = X.shape
    X = np.array(X, np.float64)
    std = np.nanstd(X, 0)
    std[std < 10 * np.finfo(std.dtype).eps] = 1.0
    X /= std
    means = np.maximum(1, np.mean(np.abs(X), axis=0))
    X += 1e-10 * means * rng.standard_normal(size=(n_samples, n_features))
    y = np.array(y, copy=True)
    y_std = np.nanstd(y, 0)
    if y_std == 0.0:
        y_std = 1.0
    y /= y_std
    y += 1e-10 * np.maximum(1, np.mean(np.abs(y))) * rng.standard_normal(size=n_samples)
    return np.array([_compute_mi_cc(X[:, i], y) for i in range(n_features)])


# -- the one-column linear fit ------------------------------------------------


def linear_r2(x, y) -> float:
    """R² of the least-squares line (with an intercept) through
    (x, y), x of shape (n, 1), in x's float dtype."""
    X = np.asarray(x)
    dtype = X.dtype if X.dtype in (np.float32, np.float64) else np.float64
    Xc = np.array(X, dtype)
    yc = np.array(y, dtype, copy=True)
    X_offset = np.asarray(np.average(Xc, axis=0)).astype(dtype, copy=False)
    Xc -= X_offset
    y_offset = np.asarray(np.average(yc, axis=0))
    yc -= y_offset
    coef = np.ravel(lstsq(Xc, yc, cond=1e-6)[0].T).astype(dtype, copy=False)
    intercept = y_offset - X_offset @ coef
    pred = np.asarray(X, dtype) @ coef + intercept

    y = np.asarray(y)
    y_dtype = np.result_type(y.dtype, pred.dtype) if y.dtype.kind == "f" else pred.dtype
    y_true = y.astype(y_dtype, copy=False).reshape(-1, 1)
    pred = pred.astype(y_true.dtype, copy=False).reshape(-1, 1)
    numerator = np.sum(1.0 * (y_true - pred) ** 2, axis=0)
    denominator = np.sum(1.0 * (y_true - np.asarray(np.average(y_true, axis=0))) ** 2,
                         axis=0)
    # r2_score's force_finite rule: a perfect fit scores 1, a constant
    # target that is not fit perfectly scores 0
    if numerator[0] == 0:
        return 1.0
    if denominator[0] == 0:
        return 0.0
    return float((np.ones(1, numerator.dtype) - numerator / denominator)[0])


# -- the discrete mutual information -----------------------------------------


def discrete_mutual_info(labels_true, labels_pred) -> float:
    """Mutual information in nats between two labellings, each distinct
    value a category (float labels are not rounded)."""
    _, class_idx = np.unique(np.asarray(labels_true).reshape(-1), return_inverse=True)
    clusters, cluster_idx = np.unique(np.asarray(labels_pred).reshape(-1),
                                      return_inverse=True)
    if class_idx.shape != cluster_idx.shape:
        raise ValueError(f"labellings of {class_idx.size} and {cluster_idx.size} samples")
    n_clusters = clusters.shape[0]
    # the contingency's nonzero cells (row, column, count), rows then columns
    cells, nz_val = np.unique(class_idx.astype(np.int64) * n_clusters + cluster_idx,
                              return_counts=True)
    nzx, nzy = cells // n_clusters, cells % n_clusters
    nz_val = nz_val.astype(np.int64)
    pi = np.bincount(nzx, weights=nz_val).astype(np.int64)
    pj = np.bincount(nzy, weights=nz_val, minlength=n_clusters).astype(np.int64)
    if pi.size == 1 or pj.size == 1:  # a single category: zero entropy
        return 0.0
    contingency_sum = nz_val.sum()
    log_contingency_nm = np.log(nz_val)
    contingency_nm = nz_val / contingency_sum
    outer = pi.take(nzx) * pj.take(nzy)
    log_outer = -np.log(outer) + math.log(pi.sum()) + math.log(pj.sum())
    mi = (contingency_nm * (log_contingency_nm - math.log(contingency_sum))
          + contingency_nm * log_outer)
    mi = np.where(np.abs(mi) < np.finfo(mi.dtype).eps, 0.0, mi)
    return float(np.clip(mi.sum(), 0.0, None))


# -- the five metrics --------------------------------------------------------


def _mi_profiles(latent_codes, attributes, rng) -> list:
    """One MI profile per attribute: MI(latent dim d ; attribute a) over d."""
    return [mutual_info_regression(latent_codes, a, rng) for a in attributes.T]


def compute_interpretability_metric(latent_codes, attributes, attr_list, rng):
    """Per attribute, (the latent dim of most MI, the R² of a line on it),
    and ``"mean": (-1, mean R²)``."""
    interpretability_metrics = {}
    total = 0.0
    for i, attr_name in enumerate(attr_list):
        attr_labels = attributes[:, i]
        mutual_info = mutual_info_regression(latent_codes, attr_labels, rng)
        dim = int(np.argmax(mutual_info))
        score = linear_r2(latent_codes[:, dim:dim + 1], attr_labels)
        interpretability_metrics[attr_name] = (dim, score)
        total += score
    interpretability_metrics["mean"] = (-1, total / len(attr_list))
    return interpretability_metrics


def compute_mig(latent_codes, attributes, rng):
    """Mutual information gap: per attribute, the gap between its two
    most informative latent dims over its own MI (self-entropy), averaged
    over attributes; an attribute with zero self-MI counts 0."""
    profiles = _mi_profiles(latent_codes, attributes, rng)
    entropies = [mutual_info_regression(a.reshape(-1, 1), a, rng)[0]
                 for a in attributes.T]
    gaps = []
    for profile, h in zip(profiles, entropies):
        second, best = np.partition(profile, profile.size - 2)[-2:]
        if h <= 0.0:
            warnings.warn("compute_mig: attribute with zero kNN self-entropy; "
                          "its gap contributes 0", RuntimeWarning)
            gaps.append(0.0)
        else:
            gaps.append((best - second) / h)
    return {"mig": float(np.mean(gaps))}


def compute_modularity(latent_codes, attributes, rng):
    """Modularity (Ridgeway & Mozer): per latent dim, 1 − its off-target
    squared MI over the one-hot bound; a dim with no MI scores 0."""
    profiles = np.stack(_mi_profiles(latent_codes, attributes, rng))
    per_dim = []
    for dim_profile in profiles.T:
        energy = dim_profile**2
        best = energy.max()
        if best == 0.0:
            per_dim.append(0.0)
        else:
            off_target = energy.sum() - best
            per_dim.append(1.0 - off_target / (best * (energy.size - 1.0)))
    return {"modularity_score": float(np.mean(per_dim))}


def _compute_correlation_matrix(mus, ys):
    score_matrix = np.zeros([mus.shape[1], ys.shape[1]])
    for i in range(mus.shape[1]):
        for j in range(ys.shape[1]):
            rho, p = spearmanr(mus[:, i], ys[:, j])
            score_matrix[i, j] = np.abs(rho) if p <= 0.05 else 0.0
    return score_matrix


def compute_correlation_score(latent_codes, attributes):
    """Spearman correlation score, gated at p <= 0.05."""
    corr_matrix = _compute_correlation_matrix(latent_codes, attributes)
    return {"Corr_score": float(np.mean(np.max(corr_matrix, axis=0)))}


def _compute_score_matrix(mus, ys):
    score_matrix = np.zeros([mus.shape[1], ys.shape[1]])
    for i in range(mus.shape[1]):
        for j in range(ys.shape[1]):
            cov = np.cov(mus[:, i], ys[:, j], ddof=1)
            var_mu, var_y = cov[0, 0], cov[1, 1]
            # a constant column has no information: 0, not 0/0
            if var_mu > 1e-12 and var_y > 1e-12:
                score_matrix[i, j] = cov[0, 1] ** 2 / (var_mu * var_y)
    return score_matrix


def _compute_avg_diff_top_two(matrix):
    sorted_matrix = np.sort(matrix, axis=0)
    return float(np.mean(sorted_matrix[-1, :] - sorted_matrix[-2, :]))


def compute_sap_score(latent_codes, attributes):
    """Separated attribute predictability."""
    score_matrix = _compute_score_matrix(latent_codes, attributes)
    if score_matrix.shape != (latent_codes.shape[1], attributes.shape[1]):
        raise ValueError(f"score matrix {score_matrix.shape}")
    return {"SAP_score": _compute_avg_diff_top_two(score_matrix)}


def compute_all(latent_codes, attributes, attr_list, rng) -> dict:
    """The five metrics in the JAX trainers' order, one ``rng`` through
    all of them: the first half of ``results_dict.json``."""
    out = {"interpretability": compute_interpretability_metric(
        latent_codes, attributes, attr_list, rng)}
    out.update(compute_correlation_score(latent_codes, attributes))
    out.update(compute_modularity(latent_codes, attributes, rng))
    out.update(compute_mig(latent_codes, attributes, rng))
    out.update(compute_sap_score(latent_codes, attributes))
    return out


def normalize_data(data, mean=None, stddev=None):
    """z-score normalisation."""
    if mean is None:
        mean = np.mean(data, axis=0)
    if stddev is None:
        stddev = np.std(data, axis=0)
    return (data - mean[np.newaxis, :]) / stddev[np.newaxis, :], mean, stddev
