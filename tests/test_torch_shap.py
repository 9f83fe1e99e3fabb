"""TreeSHAP (``predict(pred_contrib=True)``) of the port against the
reference's ``cpu/shap.py`` on the CPU.

The port walks each tree once over (N, depth) float64 tensors; the
reference recurses per row in Python.  Held: within atol 1e-9 of the
reference's ``predict_contrib`` on binary, multiclass K=3, a categorical
model with missing values, and rf (only the order in which leaves add into
a row's contributions differs); efficiency, contributions plus bias equal
to the raw predict within 1e-5; the brute-force Shapley oracle of
``tests/test_shap.py`` (path-dependent cover weighting, copied below) on a
4-feature model; a model without covers is refused.
"""

import itertools
import math

import numpy as np
import pytest

import dryad_tpu
from dryad_tpu.datasets import covertype_like, higgs_like

import dryad_tpu_torch as dt
from torch_layout import one_torch_thread, port_of  # noqa: F401 (autouse)

ROWS = 150


def _brute_force_shap(trees, t, cover, xbins, F):
    """Shapley values by subset enumeration with the path-dependent
    conditional expectation TreeSHAP defines: features outside the
    coalition average children by training covers."""
    feature = trees["feature"][t]
    threshold = trees["threshold"][t]
    left, right = trees["left"][t], trees["right"][t]
    value = trees["value"][t]
    dleft = trees["default_left"][t]

    def f_S(S, node=0):
        f = feature[node]
        if f < 0:
            return float(value[node])
        if f in S:
            b = int(xbins[f])
            go_left = b <= threshold[node] and (dleft[node] or b != 0)
            return f_S(S, left[node] if go_left else right[node])
        cl, cr = float(cover[left[node]]), float(cover[right[node]])
        return (cl * f_S(S, left[node]) + cr * f_S(S, right[node])) / (cl + cr)

    phi = np.zeros(F + 1)
    feats = list(range(F))
    for i in feats:
        for r in range(F):
            for S in itertools.combinations([f for f in feats if f != i], r):
                w = math.factorial(r) * math.factorial(F - r - 1) / math.factorial(F)
                phi[i] += w * (f_S(set(S) | {i}) - f_S(set(S)))
    phi[F] = f_S(set())
    return phi


def _model(kind):
    """(binned rows, reference booster)."""
    if kind == "categorical":
        rng = np.random.default_rng(7)
        X = rng.normal(size=(3000, 6)).astype(np.float32)
        X[:, 0] = rng.integers(0, 12, 3000)
        X[rng.random((3000, 6)) < 0.1] = np.nan
        y = ((X[:, 0] % 3 == 0) ^ (np.nan_to_num(X[:, 1]) > 0)).astype(
            np.float32)
        ds = dryad_tpu.Dataset(X, y, categorical_features=[0], max_bins=32)
        p = dict(objective="binary", num_trees=6, num_leaves=15)
    elif kind == "multiclass":
        X, y = covertype_like(2000, 12, 3, seed=4)
        ds = dryad_tpu.Dataset(X, y, max_bins=32)
        p = dict(objective="multiclass", num_class=3, num_trees=3,
                 num_leaves=15)
    else:
        X, y = higgs_like(3000, seed=17)
        ds = dryad_tpu.Dataset(X, y, max_bins=32)
        p = dict(objective="binary", num_trees=6, num_leaves=31)
        if kind == "rf":
            p.update(boosting="rf", subsample=0.7, colsample=0.8, seed=5)
    jb = dryad_tpu.train(p, ds, backend="cpu")
    return ds.X_binned[:ROWS], jb


@pytest.mark.parametrize("kind", ["binary", "multiclass", "categorical",
                                  "rf"])
def test_contrib_matches_reference_and_is_efficient(kind):
    Xb, jb = _model(kind)
    if kind == "categorical":
        assert jb.is_cat.any() and (Xb == 0).any()
    tb = port_of(jb)
    want = jb.predict_binned(Xb, pred_contrib=True)
    got = tb.predict_binned(Xb, pred_contrib=True, device="cpu")
    assert got.dtype == np.float64 and got.shape == want.shape
    F = tb.mapper.num_features
    assert got.shape[-1] == F + 1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    raw = tb.predict_binned(Xb, raw_score=True, device="cpu")
    np.testing.assert_allclose(got.sum(axis=-1), raw, rtol=0, atol=1e-5)
    # pred_contrib takes precedence over pred_leaf, as in the reference
    np.testing.assert_array_equal(
        tb.predict_binned(Xb, pred_contrib=True, pred_leaf=True,
                          device="cpu"), got)


def test_contrib_matches_bruteforce_small_tree():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(600, 4)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.1 * rng.normal(size=600)
         ).astype(np.float32)
    ds = dt.Dataset(X, y, max_bins=16)
    b = dt.train(dict(objective="regression", num_trees=3, num_leaves=7,
                      max_depth=3, max_bins=16, learning_rate=0.5), ds,
                 device="cpu")
    Xb = ds.X_binned[:5]
    got = b.predict_binned(Xb, pred_contrib=True, device="cpu")
    trees = b.tree_arrays()
    for n in range(5):
        want = np.zeros(5)
        want[4] = float(b.init_score[0])
        for t in range(b.num_total_trees):
            want += _brute_force_shap(trees, t, trees["cover"][t], Xb[n], 4)
        np.testing.assert_allclose(got[n], want, rtol=1e-5, atol=1e-6)


def test_contrib_needs_covers():
    Xb, jb = _model("binary")
    tb = port_of(jb)
    tb.arrays["cover"][2] = 0.0
    with pytest.raises(ValueError, match="covers"):
        tb.predict_binned(Xb, pred_contrib=True, device="cpu")
    # the trees before the coverless one still explain
    assert tb.predict_binned(Xb, pred_contrib=True, num_iteration=2,
                             device="cpu").shape == (ROWS, Xb.shape[1] + 1)
