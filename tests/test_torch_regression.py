"""Regression end to end: the port's boosting loop on an Epsilon-shaped
fixture (309-byte records, so the legacy plan arm) against the reference's
``train_device`` (Pallas in interpret mode), the ``Regression`` objective
against the reference's, and a carried regression model.

Tolerances: integer tree arrays equal (a tie-free fixture: seed 87 is the
reference's own, tests/test_wide_features.py); leaf values and raw
predictions within 1e-4 (histogram sums differ at the ulp level between the
packages and compound over the boosted scores); grad/hess and init score
exact (the same fp32 expressions); a carried model's predictions bitwise.
"""

import json

import numpy as np
import torch

import dryad_tpu
from dryad_tpu.datasets import epsilon_like as j_epsilon_like
from dryad_tpu.metrics import rmse as j_rmse
from dryad_tpu.objectives import Regression as JRegression

import dryad_tpu_torch as dt
from dryad_tpu_torch.convert import booster_from_reference
from dryad_tpu_torch.datasets import epsilon_like
from dryad_tpu_torch.metrics import rmse
from dryad_tpu_torch.objectives import Regression
from torch_layout import one_torch_thread  # noqa: F401 (autouse)

PARAMS = dict(objective="regression", num_trees=4, num_leaves=31,
              max_depth=5, growth="depthwise", max_bins=64)
_INT_KEYS = ("feature", "threshold", "left", "right", "is_cat", "cat_bitset",
             "default_left")


def test_regression_train_matches_reference():
    X, y = j_epsilon_like(n=3000, num_features=300, seed=87)
    Xp, yp = epsilon_like(n=3000, num_features=300, seed=87)
    np.testing.assert_array_equal(X, Xp)
    np.testing.assert_array_equal(y, yp)
    jds = dryad_tpu.Dataset(X, y, max_bins=64)
    jb = dryad_tpu.train(PARAMS, jds, backend="tpu", hist_backend="pallas")
    tds = dt.Dataset(X, y, max_bins=64)
    tb = dt.train(PARAMS, tds, device="cpu")
    ref, got = jb.tree_arrays(), tb.to_reference_arrays()
    for k in _INT_KEYS:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
    np.testing.assert_array_equal(got["cover"], ref["cover"])
    np.testing.assert_allclose(got["value"], ref["value"], atol=1e-4)
    np.testing.assert_array_equal(tb.init_score, jb.init_score)
    assert tb.max_depth_seen == jb.max_depth_seen
    pred = dt.predict(tb, X, device="cpu")
    np.testing.assert_allclose(pred, dryad_tpu.predict(jb, X), atol=1e-4)
    assert rmse(y, pred) == j_rmse(y, pred)
    assert rmse(y, pred) < float(np.std(y))             # it learned


def test_regression_objective_matches_reference():
    rng = np.random.default_rng(4)
    y = rng.normal(size=700).astype(np.float32)
    s = rng.normal(size=700).astype(np.float32)
    assert Regression().init_score(y) == JRegression().init_score(y)
    g, h = Regression().grad_hess(torch.from_numpy(s), torch.from_numpy(y))
    jg, jh = JRegression().grad_hess_np(s, y)
    np.testing.assert_array_equal(g.numpy(), jg)
    np.testing.assert_array_equal(h.numpy(), jh)
    p = dt.Params.from_dict({"objective": "l2", "growth": "depthwise",
                             "max_depth": 3, "deep_layout": "legacy"})
    assert (p.objective, p.deep_layout) == ("regression", "legacy")


def test_carried_regression_model_predicts_bitwise():
    X, y = j_epsilon_like(n=1500, num_features=12, seed=5)
    params = dict(PARAMS, num_trees=3, num_leaves=12, max_depth=4)
    jb = dryad_tpu.train(params, dryad_tpu.Dataset(X, y, max_bins=32),
                         backend="tpu", hist_backend="pallas")
    tb = booster_from_reference(
        jb.tree_arrays(), json.loads(json.dumps(jb.mapper.to_json_dict())),
        jb.init_score, jb.params.to_dict(), jb.max_depth_seen)
    assert tb.params.objective == "regression"
    Xt, _ = j_epsilon_like(n=800, num_features=12, seed=6)
    np.testing.assert_array_equal(dt.predict(tb, Xt, device="cpu"),
                                  dryad_tpu.predict(jb, Xt))
