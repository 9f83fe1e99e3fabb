"""Multiclass softmax (K trees per iteration) in the port against the
reference.

The reference runs as ``dryad_tpu.train(..., backend="tpu")`` on the CPU:
its Pallas histogram arm in interpret mode on the smallest fixture (the
arm the port follows: each class grows its own root through K1), its XLA
arm elsewhere to keep the file fast.  Under ``hist_backend="xla"`` the
reference takes shared-plan fp32 multiclass roots, which the port does
not build, so those comparisons use tie-free fixtures (short runs, <= 48
bins).  The port runs with ``device="cpu"`` (the kernels' plain
versions).

Tolerances:
* grad/hess: within 2 fp32 ulps of the row's scale (2 * 2^-23 times the
  row weight) of ``grad_hess_jax``.  Not bitwise: torch's ``exp`` and
  XLA's differ in the last bit on ~10% of entries; the row sums match
  bitwise (both add the K columns in order);
* trees: integer arrays (node ids, features, thresholds, missing
  directions) equal; leaf values within 1e-4 (atol, as the earlier port
  tests);
* raw predict of one model: bitwise (integer traversal, fp32 adds in tree
  order per column);
* evals: within 1e-6 (absolute, or relative above 1) of the reference's
  device metric and of the host oracles (fp32 reductions in different
  orders); the early-stopping
  fixture's consecutive evals sit more than 1e-5 apart (asserted), so
  ``best_iteration`` compares exactly.
"""

import numpy as np
import pytest
import torch

import dryad_tpu
from dryad_tpu import datasets as jdatasets
from dryad_tpu import metrics as jmetrics
from dryad_tpu.objectives import Multiclass as JMulticlass

import dryad_tpu_torch as dt
from dryad_tpu_torch import datasets, metrics
from dryad_tpu_torch.convert import booster_from_reference
from dryad_tpu_torch.metrics.device import eval_value
from dryad_tpu_torch.objectives import Multiclass
from torch_layout import one_torch_thread  # noqa: F401 (autouse)

_INT_KEYS = ("feature", "threshold", "left", "right", "default_left",
             "is_cat")


def _same_trees(tb, jb):
    ref, got = jb.tree_arrays(), tb.to_reference_arrays()
    for k in _INT_KEYS:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
    np.testing.assert_allclose(got["value"], ref["value"], atol=1e-4)
    assert tb.max_depth_seen == jb.max_depth_seen
    np.testing.assert_array_equal(tb.init_score, jb.init_score)
    assert tb.num_outputs == jb.num_outputs


def _pair(X, y, n_train, max_bins=32):
    return (dryad_tpu.Dataset(X[:n_train], y[:n_train], max_bins=max_bins),
            dt.Dataset(X[:n_train], y[:n_train], max_bins=max_bins))


@pytest.fixture(scope="module")
def cov3():
    return datasets.covertype_like(3000, 20, 3, seed=43)


@pytest.mark.parametrize("args", [(500, 54, 7, 11), (2500, 20, 7, 11),
                                  (3000, 20, 3, 43)])
def test_covertype_like_matches_reference(args):
    n, f, k, seed = args
    X, y = datasets.covertype_like(n, f, k, seed=seed)
    Xj, yj = jdatasets.covertype_like(n, f, k, seed=seed)
    assert X.dtype == Xj.dtype and y.dtype == yj.dtype
    np.testing.assert_array_equal(X, Xj)
    np.testing.assert_array_equal(y, yj)
    assert set(np.unique(y).tolist()) <= set(range(k))


@pytest.mark.parametrize("K", [3, 7])
@pytest.mark.parametrize("weighted", [False, True])
def test_grad_hess_matches_reference(K, weighted):
    import jax.numpy as jnp

    rng = np.random.default_rng(K)
    n = 4000
    # rows at three scales, up to |score| = 50 (saturated softmax)
    s = rng.normal(size=(n, K)) * rng.choice([1.0, 10.0, 50.0], size=(n, 1))
    s = np.clip(s, -50, 50).astype(np.float32)
    y = rng.integers(0, K, n).astype(np.float32)
    w = (rng.uniform(0.2, 3.0, n).astype(np.float32) if weighted
         else None)
    gj, hj = JMulticlass(K).grad_hess_jax(
        jnp.asarray(s), jnp.asarray(y), None if w is None else jnp.asarray(w))
    gt, ht = Multiclass(K).grad_hess(
        torch.from_numpy(s), torch.from_numpy(y),
        None if w is None else torch.from_numpy(w))
    scale = (np.ones(n, np.float32) if w is None else w)[:, None]
    tol = 2 * 2.0 ** -23 * scale
    for ref, got in ((np.asarray(gj), gt.numpy()), (np.asarray(hj),
                                                    ht.numpy())):
        assert got.shape == (n, K) and got.dtype == np.float32
        assert (np.abs(got - ref) <= tol).all()
        # most entries are bitwise; the rest differ by torch's exp
        assert (got == ref).mean() > 0.8


@pytest.mark.parametrize("K", [2, 7])
def test_init_score_and_transform_match_reference(K):
    y = np.arange(50, dtype=np.float32) % K
    np.testing.assert_array_equal(Multiclass(K).init_score(y),
                                  JMulticlass(K).init_score(y))
    s = np.random.default_rng(1).normal(size=(50, K)).astype(np.float32) * 30
    np.testing.assert_array_equal(Multiclass.transform_np(s),
                                  JMulticlass.transform_np(s))


@pytest.mark.parametrize("name", ["multi_logloss", "error", "accuracy"])
@pytest.mark.parametrize("scale", [1.0, 40.0])
def test_device_metrics_match_reference_and_host(name, scale):
    import jax.numpy as jnp
    from dryad_tpu.metrics.device import eval_value as jeval

    rng = np.random.default_rng(7)
    K, n = 7, 3000
    s = (rng.normal(size=(n, K)) * scale).astype(np.float32)
    y = rng.integers(0, K, n).astype(np.float32)
    got = float(eval_value(name, torch.from_numpy(y), torch.from_numpy(s)))
    ref = float(jeval(name, 10, jnp.asarray(y), jnp.asarray(s)))
    assert got == pytest.approx(ref, rel=1e-6, abs=1e-6)
    prob = JMulticlass.transform_np(s)
    host = {"multi_logloss": metrics.multi_logloss,
            "error": metrics.error_rate, "accuracy": metrics.accuracy}[name]
    assert got == pytest.approx(host(y, prob), rel=1e-6, abs=1e-6)


def test_host_metrics_match_reference():
    rng = np.random.default_rng(3)
    p = rng.dirichlet(np.ones(5), size=400).astype(np.float32)
    p[::7, 2] = 0.0                            # clipped to eps
    y = rng.integers(0, 5, 400)
    assert metrics.multi_logloss(y, p) == jmetrics.multi_logloss(y, p)
    assert metrics.accuracy(y, p) == jmetrics.accuracy(y, p)
    assert metrics.error_rate(y, p) == jmetrics.error_rate(y, p)


PALLAS = dict(objective="multiclass", num_class=3, num_trees=3,
              growth="depthwise", max_depth=3, num_leaves=8, max_bins=32)


def test_trees_and_predict_match_reference_pallas_arm(cov3):
    """The arm the port follows, interpret mode: per-class roots through
    the masked histogram kernel."""
    X, y = cov3
    jds, tds = _pair(X, y, 1500)
    jb = dryad_tpu.train(PALLAS, jds, backend="tpu", hist_backend="pallas")
    tb = dt.train(PALLAS, tds, device="cpu")
    assert tb.num_total_trees == 9 and tb.num_iterations == 3
    _same_trees(tb, jb)
    # the same model through convert predicts the reference's raw scores
    # bit for bit, (N, K)
    c = booster_from_reference(
        jb.tree_arrays(), jb.mapper.to_json_dict(), jb.init_score,
        jb.params.to_dict(), jb.max_depth_seen)
    for n_iter in (None, 2):
        raw = dt.predict(c, X, raw_score=True, num_iteration=n_iter,
                         device="cpu")
        assert raw.shape == (3000, 3)
        np.testing.assert_array_equal(
            raw, jb.predict(X, raw_score=True, num_iteration=n_iter))
    prob = dt.predict(c, X, device="cpu")
    np.testing.assert_array_equal(prob, jb.predict(X))
    np.testing.assert_allclose(prob.sum(1), 1.0, atol=1e-6)


def test_bag_and_colsample_match_reference(cov3, monkeypatch):
    """One bag and one feature mask per iteration, shared by its K
    trees."""
    from dryad_tpu_torch.engine import train as engine_train

    X, y = cov3
    jds, tds = _pair(X, y, 2000)
    params = dict(PALLAS, num_trees=4, subsample=0.7, colsample=0.6,
                  seed=1, learning_rate=0.3)
    seen = []
    real = engine_train.grow_any

    def spy(p, B, Xb, g, h, bag, fmask, **kw):
        seen.append((bag.clone(), fmask.clone(), g.is_contiguous()))
        return real(p, B, Xb, g, h, bag, fmask, **kw)

    monkeypatch.setattr(engine_train, "grow_any", spy)
    tb = dt.train(params, tds, device="cpu")
    jb = dryad_tpu.train(params, jds, backend="tpu", hist_backend="xla")
    _same_trees(tb, jb)
    assert len(seen) == 12 and all(c for _, _, c in seen)
    for it in range(4):
        bags = [b for b, _, _ in seen[3 * it:3 * it + 3]]
        masks = [f for _, f, _ in seen[3 * it:3 * it + 3]]
        assert all(torch.equal(bags[0], b) for b in bags)
        assert all(torch.equal(masks[0], f) for f in masks)
        assert 0.6 < float(bags[0].float().mean()) < 0.8
        used = tb.arrays["feature"][3 * it:3 * it + 3]
        assert masks[0][torch.from_numpy(used[used >= 0]).long()].all()
    assert not torch.equal(seen[0][0], seen[3][0])


ES = dict(objective="multiclass", num_class=3, num_trees=40,
          growth="depthwise", max_depth=3, num_leaves=8, max_bins=32,
          learning_rate=1.0, early_stopping_rounds=3)


def test_early_stopping_on_multi_logloss_matches_reference(cov3):
    X, y = cov3
    jds, tds = _pair(X, y, 2000)
    jdv, tdv = jds.bind(X[2000:], y[2000:]), tds.bind(X[2000:], y[2000:])
    ji, ti = [], []
    jb = dryad_tpu.train(ES, jds, [jdv], backend="tpu", hist_backend="xla",
                         callback=lambda it, info: ji.append(info))
    tb = dt.train(ES, tds, [tdv], device="cpu",
                  callback=lambda it, info: ti.append(info))
    je = [i["valid_multi_logloss"] for i in ji]
    te = [i["valid_multi_logloss"] for i in ti]
    np.testing.assert_allclose(te, je, rtol=0, atol=1e-6)
    # the fixture stops early, and its evals are well separated
    assert tb.num_iterations == jb.num_iterations < ES["num_trees"]
    assert tb.best_iteration == jb.best_iteration > 0
    assert tb.num_iterations == tb.best_iteration + 3
    assert np.abs(np.diff(je)).min() > 1e-5
    assert tb.num_total_trees == 3 * tb.num_iterations
    _same_trees(tb, jb)
    # predict stops at the best iteration by default, and its last eval
    # is the host oracle's on predict
    Xv = X[2000:]
    best = dt.predict(tb, Xv, raw_score=True, device="cpu")
    np.testing.assert_array_equal(best, dt.predict(
        tb, Xv, raw_score=True, device="cpu",
        num_iteration=tb.best_iteration))
    last = dt.predict(tb, Xv, device="cpu",
                      num_iteration=tb.num_iterations)
    assert te[-1] == pytest.approx(metrics.multi_logloss(y[2000:], last),
                                   abs=1e-6)

    # deferred evals (no early stopping, no callback): eval_history
    params = dict(ES, num_trees=6, early_stopping_rounds=0, metric="error")
    jb = dryad_tpu.train(params, jds, [jdv], backend="tpu",
                         hist_backend="xla")
    tb = dt.train(params, tds, [tdv], device="cpu")
    want = jb.train_state["eval_history"]["valid_error"]
    got = tb.train_state["eval_history"]["valid_error"]
    assert [i for i, _ in got] == [i for i, _ in want] == list(range(6))
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=0, atol=1e-6)
    assert tb.best_iteration == jb.best_iteration


def test_refusals(cov3):
    X, y = cov3
    tds = dt.Dataset(X[:500], y[:500], max_bins=16)
    tdv = tds.bind(X[500:700], y[500:700])
    for k in (0, 1):
        with pytest.raises(ValueError, match="num_class >= 2"):
            dt.train(dict(objective="multiclass", num_class=k), tds,
                     device="cpu")
        with pytest.raises(ValueError, match="num_class >= 2"):
            dryad_tpu.Params.from_dict(dict(objective="multiclass",
                                            num_class=k))
    base = dict(objective="multiclass", num_class=3, num_trees=1,
                max_depth=2, growth="depthwise", max_bins=16)
    # one-score metrics on K columns: the reference's device metric fails
    # on the shapes, the port refuses before training
    for name in ("auc", "binary_logloss", "rmse", "mse", "mae"):
        with pytest.raises(ValueError, match="one score per row"):
            dt.train(dict(base, metric=name), tds, [tdv], device="cpu")
        with pytest.raises(ValueError, match="one score per row"):
            eval_value(name, torch.zeros(4), torch.zeros(4, 3))
    # and multi_logloss on one score column
    with pytest.raises(ValueError, match="multi_logloss"):
        dt.train(dict(objective="binary", num_trees=1, max_bins=16,
                      metric="multi_logloss"), tds, [tdv], device="cpu")
    # a K-output model does not continue as another K
    m = dt.train(base, tds, device="cpu")
    with pytest.raises(ValueError, match="num_class must match"):
        dt.train(dict(base, num_class=4, num_trees=2), tds,
                 init_booster=m, device="cpu")
    # the aliases of the reference
    for alias in ("softmax", "multi:softmax", "multiclassova"):
        assert dt.Params.from_dict(dict(objective=alias, num_classes=3)
                                   ).num_outputs == 3
    assert dt.Params.from_dict(dict(objective="binary",
                                    num_class=1)).num_outputs == 1
