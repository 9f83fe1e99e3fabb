"""The port's training and predict against the reference package.

* Training: ``dryad_tpu.train(..., backend="tpu", hist_backend="pallas",
  growth="depthwise")`` (the wired path, Pallas in interpret mode) vs
  ``dryad_tpu_torch.train(..., device="cpu")`` on tie-free fixtures (short
  runs, <= 64 bins).  Integer tree arrays equal; leaf values within 1e-4
  (histogram sums differ at the ulp level between the packages, and the
  difference compounds through the boosted scores over a few trees).
* Predict from a model carried across with ``booster_from_reference``:
  bitwise equal, since traversal compares integers and the leaf values
  add in fp32 in the same order.
"""

import json

import numpy as np
import pytest
import torch

import dryad_tpu
from dryad_tpu import datasets as jdatasets
from dryad_tpu.engine.predict import pack_node_words as j_pack
from dryad_tpu.metrics import auc as j_auc
from dryad_tpu.objectives import Binary as JBinary

import dryad_tpu_torch as dt
from dryad_tpu_torch import datasets as tdatasets
from dryad_tpu_torch.convert import booster_from_reference
from dryad_tpu_torch.engine.predict import pack_node_words, unpack_node_words
from dryad_tpu_torch.metrics import auc
from dryad_tpu_torch.objectives import Binary

_INT_KEYS = ("feature", "threshold", "left", "right", "is_cat", "cat_bitset",
             "default_left")


def _reference_model(params, X, y, max_bins):
    ds = dryad_tpu.Dataset(X, y, max_bins=max_bins)
    return ds, dryad_tpu.train(params, ds, backend="tpu",
                               hist_backend="pallas")


@pytest.mark.parametrize("n,seed,depth,leaves,trees,max_bins", [
    (6000, 31, 5, 31, 4, 64),
    (4000, 7, 4, 12, 3, 32),          # leaf budget below 2^depth
])
def test_train_matches_reference_wired_path(n, seed, depth, leaves, trees,
                                            max_bins):
    X, y = jdatasets.higgs_like(n, seed=seed)
    params = dict(objective="binary", num_trees=trees, num_leaves=leaves,
                  max_depth=depth, max_bins=max_bins, growth="depthwise")
    jds, jb = _reference_model(params, X, y, max_bins)
    tds = dt.Dataset(X, y, max_bins=max_bins)
    np.testing.assert_array_equal(tds.X_binned, jds.X_binned)
    tb = dt.train(params, tds, device="cpu")
    ref, got = jb.tree_arrays(), tb.to_reference_arrays()
    assert set(ref) == set(got)
    for k in _INT_KEYS:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
        assert got[k].dtype == np.asarray(ref[k]).dtype, k
    np.testing.assert_array_equal(got["cover"], ref["cover"])
    np.testing.assert_allclose(got["value"], ref["value"], atol=1e-4)
    assert tb.max_depth_seen == jb.max_depth_seen
    np.testing.assert_array_equal(tb.init_score, jb.init_score)
    # the port's own predict of its own model tracks the reference's
    np.testing.assert_allclose(
        dt.predict(tb, X, raw_score=True, device="cpu"),
        dryad_tpu.predict(jb, X, raw_score=True), atol=1e-4)


@pytest.mark.parametrize("raw_score", [True, False])
def test_carried_model_predicts_bitwise(raw_score):
    X, y = jdatasets.higgs_like(5000, seed=3)
    X[::17, 2] = np.nan                     # missing values route too
    params = dict(objective="binary", num_trees=5, num_leaves=20,
                  max_depth=5, max_bins=48, growth="depthwise")
    _, jb = _reference_model(params, X, y, 48)
    tb = booster_from_reference(
        jb.tree_arrays(), json.loads(json.dumps(jb.mapper.to_json_dict())),
        jb.init_score, jb.params.to_dict(), jb.max_depth_seen)
    Xt, _ = jdatasets.higgs_like(3000, seed=4)
    Xt[::13, 2] = np.nan
    want = dryad_tpu.predict(jb, Xt, raw_score=raw_score)
    got = dt.predict(tb, Xt, raw_score=raw_score, device="cpu")
    np.testing.assert_array_equal(got, want)
    for n_it in (1, 3):
        np.testing.assert_array_equal(
            tb.predict(Xt, raw_score=True, num_iteration=n_it, device="cpu"),
            jb.predict(Xt, raw_score=True, num_iteration=n_it))


def test_mapper_and_datasets_match_reference():
    X, y = jdatasets.higgs_like(3000, seed=9)
    Xp, yp = tdatasets.higgs_like(3000, seed=9)
    np.testing.assert_array_equal(X, Xp)
    np.testing.assert_array_equal(y, yp)
    X[::7, 0] = np.nan
    jds = dryad_tpu.Dataset(X, y, max_bins=200)
    tds = dt.Dataset(X, y, max_bins=200)
    assert tds.mapper.to_json_dict() == jds.mapper.to_json_dict()
    np.testing.assert_array_equal(tds.X_binned, jds.X_binned)
    assert tds.has_missing == jds.has_missing is True


def test_pack_node_words_round_trip():
    rng = np.random.default_rng(0)
    M = 31
    feature = np.where(rng.random((3, M)) < 0.5, rng.integers(0, 28, (3, M)), -1)
    threshold = rng.integers(0, 256, (3, M))
    left = rng.integers(1, M, (3, M))
    right = rng.integers(1, M, (3, M))
    dleft = rng.random((3, M)) < 0.5
    is_cat = np.zeros((3, M), bool)
    words = pack_node_words(feature, threshold, left, right, dleft, is_cat)
    assert words.dtype == np.int64
    ref = j_pack(feature, threshold, left, right, dleft, is_cat)
    np.testing.assert_array_equal(words, ref.astype(np.int64))
    back = unpack_node_words(words)
    internal = feature >= 0
    np.testing.assert_array_equal(back["feature"], np.where(internal, feature, -1))
    for k, v in (("threshold", threshold), ("left", left), ("right", right)):
        np.testing.assert_array_equal(back[k], np.where(internal, v, 0))
    np.testing.assert_array_equal(back["default_left"], internal & dleft)
    with pytest.raises(ValueError, match="feature"):
        pack_node_words(np.array([5000]), [0], [1], [2], [True], [False])


def test_objective_and_auc_match_reference():
    rng = np.random.default_rng(1)
    y = (rng.random(500) < 0.3).astype(np.float32)
    s = rng.normal(size=500).astype(np.float32)
    assert Binary().init_score(y) == JBinary().init_score(y)
    g, h = Binary().grad_hess(torch.from_numpy(s), torch.from_numpy(y))
    jg, jh = JBinary().grad_hess_np(s, y)
    np.testing.assert_allclose(g.numpy(), jg, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(h.numpy(), jh, rtol=1e-6, atol=1e-7)
    s[::5] = s[0]                                      # ties -> midranks
    assert auc(y, s) == pytest.approx(j_auc(y, s), abs=1e-12)


def test_params_aliases_and_slice_limits():
    p = dt.Params.from_dict({"n_estimators": 7, "eta": 0.3, "max_bin": 63,
                             "grow_policy": "depth", "max_depth": 3,
                             "subsample": 1.0, "boosting_type": "gbdt"})
    assert (p.num_trees, p.learning_rate, p.max_bins, p.growth) == (
        7, 0.3, 63, "depthwise")
    assert p.effective_num_leaves == 8 and p.max_nodes == 15
    # leaf-wise growth and max_depth <= 0 (the reference's defaults) are
    # accepted
    for ok in ({"growth": "leafwise", "max_depth": 4}, {"max_depth": 4},
               {}, {"grow_policy": "lossguide", "unbounded_depth": "exact"},
               {"growth": "depthwise", "max_depth": -1}):
        q = dt.Params.from_dict(ok)
        assert q.growth == ok.get("growth", "leafwise").replace(
            "lossguide", "leafwise")
        assert q.max_depth == ok.get("max_depth", -1)
    for bad, name in (({"unbounded_depth": "bogus"}, "unbounded_depth"),
                      ({"categorical_features": [1]}, "categorical_features"),
                      ({"growth": "depthwise", "max_depth": 4,
                        "categorical_features": [1]}, "categorical_features"),
                      ({"growth": "depthwise", "max_depth": 4,
                        "top_rate": 0.5}, "goss_top_rate"),
                      ({"growth": "depthwise", "max_depth": 4,
                        "boosting": "dart"}, "boosting"),
                      ({"growth": "depthwise", "max_depth": 4,
                        "objective": "multiclass"}, "objective"),
                      ({"growth": "depthwise", "max_depth": 4,
                        "colsampel": 0.5}, "colsampel")):
        with pytest.raises(ValueError, match=name):
            dt.Params.from_dict(bad)
