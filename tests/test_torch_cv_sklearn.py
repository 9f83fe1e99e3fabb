"""``dryad_tpu_torch.cv`` and the scikit-learn-style estimators against the
reference's on the CPU.

* ``_fold_indices`` is bitwise the reference's, stratified or not,
  shuffled or not.
* On ``higgs_like(6000, seed=13)`` at 32 bins, nfold 3: every fold's trees
  equal those of the reference ``cv(backend="cpu")`` booster of the same
  fold (integer arrays equal, values within rtol 1e-5 / atol 1e-6), and
  the ``-mean``/``-stdv`` curves are within 1e-6 of the reference's.
* Early stopping truncates the curves to the shortest fold; ranking data,
  ``nfold < 2`` and unlabeled sets are refused.
* The estimators, on the reference's ``tests/test_sklearn_api.py``
  fixtures with ``device="cpu"`` (fewer trees): the classifier (binary;
  multiclass with non-contiguous labels), the regressor with an
  ``eval_set`` and early stopping, and the ranker give the reference
  estimators' trees; ``predict_proba`` equals ``dryad_tpu_torch.predict``
  of ``booster_``; ``get_params``/``set_params`` round-trip.
"""

import numpy as np
import pytest

import dryad_tpu
from dryad_tpu.cv import _fold_indices as j_fold_indices
from dryad_tpu.datasets import covertype_like, higgs_like, mslr_like
from dryad_tpu.sklearn import DryadClassifier as JClassifier
from dryad_tpu.sklearn import DryadRanker as JRanker
from dryad_tpu.sklearn import DryadRegressor as JRegressor

import dryad_tpu_torch as dt
from dryad_tpu_torch.cv import _fold_indices
from dryad_tpu_torch.sklearn import DryadClassifier, DryadRanker, DryadRegressor
from torch_layout import one_torch_thread  # noqa: F401 (autouse)

_INT = ("feature", "threshold", "left", "right", "default_left", "is_cat",
        "cat_bitset")
# leaf-wise depth caps keep the wired arm's mandated tiles (2 * 2^D + 2 a
# level) cheap in the plain versions
CV_PARAMS = dict(objective="binary", num_trees=5, num_leaves=7, max_depth=3,
                 max_bins=32)
FAST = dict(num_trees=6, num_leaves=15, max_depth=4, max_bins=64)


def _same_trees(ta: dict, ja: dict) -> None:
    for k in _INT:
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    np.testing.assert_allclose(ta["value"], ja["value"], rtol=1e-5,
                               atol=1e-6)


@pytest.fixture(scope="module")
def data():
    X, y = higgs_like(6000, seed=13)
    return (dt.Dataset(X, y, max_bins=32),
            dryad_tpu.Dataset(X, y, max_bins=32))


@pytest.mark.parametrize("stratified,shuffle", [(True, True), (True, False),
                                                (False, True),
                                                (False, False)])
def test_fold_indices_bitwise_reference(stratified, shuffle):
    y = np.random.default_rng(2).integers(0, 3, 1001).astype(np.float32)
    for nfold, seed in ((2, 0), (4, 3), (7, 11)):
        got = _fold_indices(y, nfold, stratified, shuffle, seed)
        want = j_fold_indices(y, nfold, stratified, shuffle, seed)
        assert len(got) == len(want) == nfold
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(np.sort(np.concatenate(got)),
                                      np.arange(1001))


def test_cv_folds_and_curves_match_reference(data):
    tds, jds = data
    kw = dict(nfold=3, seed=9, return_boosters=True)
    got = dt.cv(CV_PARAMS, tds, device="cpu", **kw)
    want = dryad_tpu.cv(CV_PARAMS, jds, backend="cpu", **kw)
    assert len(got["boosters"]) == 3
    for tb, jb in zip(got["boosters"], want["boosters"]):
        _same_trees(tb.tree_arrays(), jb.tree_arrays())
        th = np.asarray(tb.train_state["eval_history"]["valid_auc"])
        jh = np.asarray(jb.train_state["eval_history"]["valid_auc"])
        np.testing.assert_array_equal(th[:, 0], jh[:, 0])
        np.testing.assert_allclose(th[:, 1], jh[:, 1], rtol=0, atol=1e-6)
    keys = {k for k in want if k != "boosters"}
    assert keys == {k for k in got if k != "boosters"} == {
        "valid_auc-mean", "valid_auc-stdv"}
    for k in keys:
        assert len(got[k]) == CV_PARAMS["num_trees"]
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)
    assert got["valid_auc-mean"][-1] > got["valid_auc-mean"][0]
    again = dt.cv(CV_PARAMS, tds, device="cpu", **kw)
    assert again["valid_auc-mean"] == got["valid_auc-mean"]


def test_cv_early_stopping_truncates_to_shortest(data):
    tds, _ = data
    res = dt.cv(dict(CV_PARAMS, num_trees=30, learning_rate=1.5,
                     early_stopping_rounds=2), tds, nfold=3, seed=2,
                device="cpu", return_boosters=True)
    lengths = [b.num_iterations for b in res["boosters"]]
    assert min(lengths) < 30
    assert len(res["valid_auc-mean"]) == len(res["valid_auc-stdv"]) == min(
        lengths)


def test_cv_rejects_ranking_nfold_and_unlabeled(data):
    tds, _ = data
    X, y, group = mslr_like(num_queries=20, seed=3)
    ds = dt.Dataset(X, y, group=group, max_bins=32)
    with pytest.raises(ValueError, match="ranking"):
        dt.cv(dict(objective="lambdarank", num_trees=2), ds, device="cpu")
    with pytest.raises(ValueError, match="nfold"):
        dt.cv(dict(objective="binary", num_trees=2), tds, nfold=1,
              device="cpu")
    unlabeled = dt.Dataset.from_binned(tds.X_binned, tds.mapper, None)
    with pytest.raises(ValueError, match="labels"):
        dt.cv(dict(objective="binary", num_trees=2), unlabeled,
              device="cpu")


def test_classifier_binary_matches_reference():
    X, y = higgs_like(4000, seed=31)
    clf = DryadClassifier(device="cpu", **FAST).fit(X[:3000], y[:3000])
    ref = JClassifier(backend="cpu", **FAST).fit(X[:3000], y[:3000])
    _same_trees(clf.booster_.tree_arrays(), ref.booster_.tree_arrays())
    proba = clf.predict_proba(X[3000:])
    assert proba.shape == (1000, 2)
    np.testing.assert_array_equal(
        proba[:, 1], dt.predict(clf.booster_, X[3000:], device="cpu"))
    np.testing.assert_allclose(proba.sum(axis=1), 1.0, rtol=1e-5)
    np.testing.assert_array_equal(clf.classes_, ref.classes_)
    assert set(np.unique(clf.predict(X[3000:]))) <= set(clf.classes_)
    np.testing.assert_allclose(clf.feature_importances_,
                               ref.feature_importances_, rtol=1e-5)


def test_classifier_multiclass_with_label_remap_matches_reference():
    X, y = covertype_like(4000, seed=33)
    y_lab = y * 10 + 3                       # non-contiguous labels
    kw = dict(FAST, num_trees=2)
    clf = DryadClassifier(device="cpu", **kw).fit(X, y_lab)
    ref = JClassifier(backend="cpu", **kw).fit(X, y_lab)
    np.testing.assert_array_equal(clf.classes_, np.unique(y_lab))
    assert clf.booster_.num_outputs == 7
    _same_trees(clf.booster_.tree_arrays(), ref.booster_.tree_arrays())
    proba = clf.predict_proba(X[:100])
    assert proba.shape == (100, 7)
    np.testing.assert_array_equal(
        proba, dt.predict(clf.booster_, X[:100], device="cpu"))
    assert set(np.unique(clf.predict(X[:500]))) <= set(np.unique(y_lab))
    with pytest.raises(ValueError, match="never appear"):
        clf.fit(X, y_lab, eval_set=(X[:10], np.full(10, 999)))


def test_regressor_with_eval_set_matches_reference():
    rng = np.random.default_rng(35)
    X = rng.normal(size=(3000, 10)).astype(np.float32)
    y = X[:, 0] * 2 + np.sin(X[:, 1]) + rng.normal(scale=0.1, size=3000)
    kw = dict(FAST, num_trees=12, early_stopping_rounds=5)
    reg = DryadRegressor(device="cpu", **kw)
    reg.fit(X[:2500], y[:2500], eval_set=(X[2500:], y[2500:]))
    ref = JRegressor(backend="cpu", **kw)
    ref.fit(X[:2500], y[:2500], eval_set=(X[2500:], y[2500:]))
    _same_trees(reg.booster_.tree_arrays(), ref.booster_.tree_arrays())
    assert reg.best_iteration_ == ref.best_iteration_ > 0
    pred = reg.predict(X[2500:])
    np.testing.assert_allclose(pred, ref.predict(X[2500:]), rtol=1e-5,
                               atol=1e-5)
    assert float(np.mean((pred - y[2500:]) ** 2)) < np.var(y) * 0.5


def test_ranker_matches_reference():
    X, y, group = mslr_like(num_queries=80, seed=37)
    kw = dict(FAST, num_trees=3)
    rk = DryadRanker(device="cpu", **kw).fit(X, y, group=group)
    ref = JRanker(backend="cpu", **kw).fit(X, y, group=group)
    _same_trees(rk.booster_.tree_arrays(), ref.booster_.tree_arrays())
    np.testing.assert_array_equal(
        rk.predict(X), dt.predict(rk.booster_, X, raw_score=True,
                                  device="cpu"))


def test_get_set_params_roundtrip():
    clf = DryadClassifier(num_trees=7, learning_rate=0.3, device="cpu")
    p = clf.get_params()
    assert p["num_trees"] == 7 and p["learning_rate"] == 0.3
    assert p["device"] == "cpu" and "backend" not in p
    clf.set_params(num_trees=9, num_class=3, device=None)
    assert clf.num_trees == 9 and clf.extra_params["num_class"] == 3
    assert clf.device is None
    assert DryadClassifier(**clf.get_params()).get_params() == \
        clf.get_params()
    assert DryadRegressor()._params().objective == "regression"
    with pytest.raises(RuntimeError, match="fit"):
        DryadRanker().predict(np.zeros((2, 3), np.float32))
