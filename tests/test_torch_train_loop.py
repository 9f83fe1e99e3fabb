"""The port's boosting loop against the reference's device trainer.

The reference runs as ``dryad_tpu.train(..., backend="tpu")`` on the CPU
(``hist_backend="pallas"`` in interpret mode for the depthwise wired arm
and the bagged early-stopping run, the XLA histogram arm elsewhere, to
keep the file fast); the port as
``dryad_tpu_torch.train(..., device="cpu")`` (the kernels' plain
versions).  Fixtures are tie-free: short runs, <= 32 bins, as in the
earlier slices' tests.

Tolerances:
* trees: integer arrays (node ids, features, thresholds, missing
  directions) and covers equal; leaf values within 1e-4 (histogram sums
  round differently between the packages and the difference compounds
  through the boosted scores);
* evals: within 1e-6 of the reference's.  AUC is an fp32 rank sum in both
  packages, reduced in a different order (~1e-7 apart here).  The
  early-stopping fixtures were chosen (learning rate 0.5, 4000 rows) so
  that consecutive evals around the best sit more than 1e-5 apart, which
  each test asserts, so ``best_iteration`` and the early-stop iteration
  cannot flip within the tolerance: those compare exactly.
"""

import numpy as np
import pytest

import dryad_tpu
from dryad_tpu import datasets as jdatasets

import dryad_tpu_torch as dt

_INT_KEYS = ("feature", "threshold", "left", "right", "default_left",
             "is_cat")


def _same_trees(tb, jb):
    ref, got = jb.tree_arrays(), tb.to_reference_arrays()
    for k in _INT_KEYS:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
    np.testing.assert_array_equal(got["cover"], ref["cover"])
    np.testing.assert_allclose(got["value"], ref["value"], atol=1e-4)
    assert tb.max_depth_seen == jb.max_depth_seen
    np.testing.assert_array_equal(tb.init_score, jb.init_score)


def _pair(X, y, n_train, max_bins=32, **kw):
    jw = kw.pop("weight", None)
    jds = dryad_tpu.Dataset(X[:n_train], y[:n_train], max_bins=max_bins,
                            weight=jw)
    tds = dt.Dataset(X[:n_train], y[:n_train], max_bins=max_bins,
                     weight=jw)
    return jds, tds


@pytest.fixture(scope="module")
def higgs():
    return jdatasets.higgs_like(5000, seed=31)


BAGGED = dict(objective="binary", num_trees=6, num_leaves=31, max_depth=5,
              max_bins=32, seed=1, learning_rate=0.3, subsample=0.7,
              colsample=0.6)


@pytest.mark.parametrize("arm,extra,hist_backend", [
    ("depthwise wired", dict(growth="depthwise"), "pallas"),
    ("depthwise legacy", dict(growth="depthwise", deep_layout="legacy"),
     "xla"),
    ("leaf-wise batched wired", dict(growth="leafwise", num_leaves=20),
     "xla"),
    ("leaf-wise batched legacy", dict(growth="leafwise", num_leaves=20,
                                      deep_layout="legacy"), "xla"),
])
def test_bagged_colsampled_matches_reference(higgs, arm, extra,
                                             hist_backend):
    X, y = higgs
    jds, tds = _pair(X, y, 4000)
    params = dict(BAGGED, **extra)
    jb = dryad_tpu.train(params, jds, backend="tpu",
                         hist_backend=hist_backend)
    tb = dt.train(params, tds, device="cpu")
    _same_trees(tb, jb)
    # the bag reached the histograms: the roots cover ~70% of the rows,
    # each tree its own draw
    roots = tb.arrays["cover"][:, 0]
    assert (roots < 0.75 * 4000).all() and len(set(roots.tolist())) > 1


@pytest.mark.parametrize("objective,spw", [("binary", 1.0), ("binary", 3.0),
                                           ("regression", 1.0)])
def test_weighted_training_matches_reference(higgs, objective, spw):
    X, y = higgs
    w = np.random.Generator(np.random.Philox(13)).uniform(
        0.25, 4.0, size=4000).astype(np.float32)
    jds, tds = _pair(X, y, 4000, weight=w)
    params = dict(objective=objective, num_trees=4, num_leaves=10,
                  max_depth=4, max_bins=32, scale_pos_weight=spw,
                  growth="depthwise")
    jb = dryad_tpu.train(params, jds, backend="tpu", hist_backend="xla")
    tb = dt.train(params, tds, device="cpu")
    _same_trees(tb, jb)
    # the weights change the model
    tu = dt.train(params, dt.Dataset(X[:4000], y[:4000], max_bins=32),
                  device="cpu")
    assert not np.array_equal(tu.arrays["value"], tb.arrays["value"])


def test_weight_length_is_validated():
    X = np.zeros((10, 2), np.float32)
    with pytest.raises(ValueError, match="weight length 9 != num_rows 10"):
        dt.Dataset(X, np.zeros(10), weight=np.ones(9))


def _evals(infos, key):
    return [(i["iteration"], i[key]) for i in infos if key in i]


ES_PARAMS = dict(objective="binary", num_trees=40, num_leaves=31,
                 max_depth=5, growth="depthwise", max_bins=32,
                 learning_rate=0.5, early_stopping_rounds=3)


# the bagged case holds against the Pallas arm: the XLA arm's fp32 sums
# break an exact gain tie at tree 7, node 26 (thresholds 18 and 19, gain
# 0.22354126 both) the other way, the near-tie class between the
# reference's own arms; the port and the Pallas arm agree
@pytest.mark.parametrize("extra,hist_backend", [
    ({}, "xla"), (dict(subsample=0.8, colsample=0.8, seed=5), "pallas")])
def test_early_stopping_matches_reference(higgs, extra, hist_backend):
    X, y = higgs
    jds, tds = _pair(X, y, 4000)
    jdv, tdv = jds.bind(X[4000:], y[4000:]), tds.bind(X[4000:], y[4000:])
    params = dict(ES_PARAMS, **extra)
    ji, ti = [], []
    jb = dryad_tpu.train(params, jds, [jdv], backend="tpu",
                         hist_backend=hist_backend,
                         callback=lambda it, info: ji.append(info))
    tb = dt.train(params, tds, [tdv], device="cpu",
                  callback=lambda it, info: ti.append(info))
    je, te = _evals(ji, "valid_auc"), _evals(ti, "valid_auc")
    assert [i for i, _ in te] == [i for i, _ in je]
    np.testing.assert_allclose([v for _, v in te], [v for _, v in je],
                               rtol=0, atol=1e-6)
    # the fixture stops early, and its evals are well separated
    assert tb.num_iterations == jb.num_iterations < params["num_trees"]
    assert tb.best_iteration == jb.best_iteration > 0
    assert tb.num_iterations == tb.best_iteration + 3
    vals = np.array([v for _, v in je])
    assert np.abs(np.diff(vals)).min() > 1e-5
    _same_trees(tb, jb)
    assert tb.train_state["stale"] == jb.train_state["stale"] == 3
    assert tb.train_state["best_value"] == pytest.approx(
        jb.train_state["best_value"], abs=1e-6)
    # predict stops at the best iteration by default
    np.testing.assert_array_equal(
        dt.predict(tb, X[4000:], raw_score=True, device="cpu"),
        dt.predict(tb, X[4000:], raw_score=True, device="cpu",
                   num_iteration=tb.best_iteration))


def test_deferred_eval_history_matches_reference(higgs):
    """No early stopping and no callback: evals stay on the device until
    the end and land in ``train_state["eval_history"]``."""
    X, y = higgs
    jds, tds = _pair(X, y, 4000)
    jdv, tdv = jds.bind(X[4000:], y[4000:]), tds.bind(X[4000:], y[4000:])
    params = dict(ES_PARAMS, num_trees=8, early_stopping_rounds=0,
                  metric="binary_logloss")
    jb = dryad_tpu.train(params, jds, [jdv], backend="tpu",
                         hist_backend="xla")
    tb = dt.train(params, tds, [tdv], device="cpu")
    want = jb.train_state["eval_history"]["valid_binary_logloss"]
    got = tb.train_state["eval_history"]["valid_binary_logloss"]
    assert [i for i, _ in got] == [i for i, _ in want] == list(range(8))
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=0, atol=1e-6)
    assert tb.best_iteration == jb.best_iteration
    _same_trees(tb, jb)


def test_multiple_valid_sets_and_names(higgs):
    X, y = higgs
    tds = dt.Dataset(X[:3000], y[:3000], max_bins=32)
    dv1, dv2 = tds.bind(X[3000:4000], y[3000:4000]), tds.bind(X[4000:],
                                                              y[4000:])
    seen = []
    b = dt.train(dict(objective="binary", num_trees=15, num_leaves=15,
                      max_depth=4, early_stopping_rounds=4, max_bins=32),
                 tds,
                 [dv1, dv2], device="cpu",
                 callback=lambda it, info: seen.append(info))
    evaled = [s for s in seen if len(s) > 1]
    assert all("valid_0_auc" in s and "valid_1_auc" in s for s in evaled)
    assert b.best_iteration > 0
    # early stopping watched the first set
    curve = [s["valid_0_auc"] for s in evaled]
    assert curve[b.best_iteration - 1] == max(curve[: b.best_iteration])
    seen.clear()
    dt.train({"objective": "binary", "num_trees": 3, "num_leaves": 7,
              "max_depth": 3, "max_bins": 32}, tds, valid_sets=[dv1, tds],
             valid_names=["holdout", "train"], device="cpu",
             callbacks=[lambda it, info: seen.append(info)])
    assert all("holdout_auc" in s and "train_auc" in s for s in seen)
    with pytest.raises(ValueError, match="valid_names"):
        dt.train({"num_trees": 2}, tds, valid_sets=[dv1],
                 valid_names=["a", "b"], device="cpu")


def test_eval_period_evaluates_tail():
    X, y = jdatasets.higgs_like(2000, seed=107)
    ds = dt.Dataset(X, y, max_bins=32)
    valid = ds.bind(X[:500], y[:500])
    infos = []
    b = dt.train(dict(objective="binary", num_trees=20, num_leaves=7,
                      max_depth=3, max_bins=32, eval_period=7), ds, [valid],
                 device="cpu", callback=lambda it, i: infos.append(i))
    evaled = [i["iteration"] for i in infos
              if any(k.startswith("valid_") for k in i)]
    assert evaled == [6, 13, 19]       # every 7th plus the forced final
    assert b.best_iteration > 0


def test_train_argument_errors(higgs):
    X, y = higgs
    ds = dt.Dataset(X[:500], y[:500], max_bins=16)
    m = dt.train({"num_trees": 1, "num_leaves": 4}, ds, device="cpu")
    with pytest.raises(ValueError, match="not both"):
        dt.train({"num_trees": 1}, ds, init_model=m, init_booster=m,
                 device="cpu")
    with pytest.raises(ValueError, match="ambiguous"):
        dt.train({"num_trees": 1}, ds, init_model=m, resume=True,
                 checkpoint_dir="unused", device="cpu")
    with pytest.raises(ValueError, match="requires checkpoint_dir"):
        dt.train({"num_trees": 1}, ds, resume=True, device="cpu")
    with pytest.raises(ValueError, match="init_model"):
        dt.train({"num_trees": 0}, ds, device="cpu")
    with pytest.raises(ValueError, match="subsample"):
        dt.train({"num_trees": 1, "subsample": 0.0}, ds, device="cpu")
    with pytest.raises(ValueError, match="scale_pos_weight"):
        dt.Params(scale_pos_weight=0.0).validate()
    with pytest.raises(ValueError, match="eval_period"):
        dt.Params(eval_period=0).validate()
