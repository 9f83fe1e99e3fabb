"""The port's model API against the reference on the CPU: ``pred_leaf``,
the structure-of-arrays traversal, ``feature_importance``, ``dump_model``,
``transform_raw`` and the text model.

Reference models are grown by ``dryad_tpu``'s CPU trainer and carried
across by ``convert.booster_from_reference`` (``torch_layout.port_of``).

* pred_leaf: (N, T) int32, bitwise the reference's
  ``predict_binned(pred_leaf=True)`` on binary, multiclass K=3, rf, a
  categorical model with missing values and a model stopped early (T =
  best_iteration * K); ``init + sum_t value[t, leaf]`` in tree order is
  bitwise the raw predict.
* SoA arm: a model re-indexed so that its features sit at ids >= 4096,
  over a widened binned matrix, predicts bitwise as the original through
  the packed arm, and as the reference's device predict with
  ``predict_layout="legacy"`` (JAX CPU backend); ``"packed"`` raises on
  it; ``"legacy"`` on the original is bitwise the packed arm.
* ``feature_importance`` and ``dump_model`` equal the reference's.
* The text model: ``dump_text`` -> ``from_text`` both ways (port ->
  reference, reference -> port), tree arrays and predict bitwise, on
  binary, multiclass, a bundled (EFB) categorical model and rf;
  ``load_any`` sniffs both formats of both packages; the version guard.
* ``Params.to_dict`` loads in the reference's ``Params.from_dict`` and
  back through ``from_reference_dict`` in every mode.
"""

import json

import numpy as np
import pytest
from test_bundling import _sparse_cat_csr

import dryad_tpu
from dryad_tpu.config import Params as JParams
from dryad_tpu.datasets import covertype_like, higgs_like
from dryad_tpu.engine.predict import predict_binned_device

import dryad_tpu_torch as dt
from dryad_tpu_torch.booster import ARRAY_KEYS
from torch_layout import one_torch_thread, port_of  # noqa: F401 (autouse)

WIDE = 4096     # re-indexed feature ids start here, past the packed 12 bits


def _cat_nan(n=4000, seed=7):
    """Categoricals, NaNs and learned missing directions in one model."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6)).astype(np.float32)
    X[:, 0] = rng.integers(0, 12, n)
    X[rng.random((n, 6)) < 0.1] = np.nan
    y = ((X[:, 0] % 3 == 0) ^ (np.nan_to_num(X[:, 1]) > 0)).astype(
        np.float32)
    return X, y


def _fit(kind):
    """(raw rows, binned rows, reference booster) of one fixture."""
    if kind == "multiclass":
        X, y = covertype_like(3000, 20, 3, seed=5)
        p = dict(objective="multiclass", num_class=3, num_trees=5,
                 num_leaves=15)
    elif kind == "categorical":
        X, y = _cat_nan()
        ds = dryad_tpu.Dataset(X, y, categorical_features=[0], max_bins=64)
        jb = dryad_tpu.train(dict(objective="binary", num_trees=10,
                                  num_leaves=15), ds, backend="cpu")
        return X, ds.X_binned, jb
    else:
        X, y = higgs_like(4000, seed=21)
        p = dict(objective="binary", num_trees=10, num_leaves=15)
        if kind == "rf":
            p.update(boosting="rf", subsample=0.7, colsample=0.8, seed=3)
        elif kind == "early":
            ds = dryad_tpu.Dataset(X[:3000], y[:3000], max_bins=32)
            dv = ds.bind(X[3000:], y[3000:])
            jb = dryad_tpu.train(dict(p, num_trees=40, learning_rate=1.0,
                                      early_stopping_rounds=2), ds, [dv],
                                 backend="cpu")
            assert 0 < jb.best_iteration < jb.num_iterations
            return X, ds.mapper.transform(X), jb
    ds = dryad_tpu.Dataset(X, y, max_bins=32)
    return X, ds.X_binned, dryad_tpu.train(dict(p, max_bins=32), ds,
                                           backend="cpu")


@pytest.fixture(scope="module")
def models():
    return {k: _fit(k) for k in ("binary", "multiclass", "rf",
                                 "categorical", "early")}


@pytest.mark.parametrize("kind", ["binary", "multiclass", "rf",
                                  "categorical", "early"])
def test_pred_leaf_bitwise_reference(models, kind):
    X, Xb, jb = models[kind]
    tb = port_of(jb)
    want = jb.predict_binned(Xb, pred_leaf=True)
    got = tb.predict_binned(Xb, pred_leaf=True, device="cpu")
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        dt.predict(tb, X, pred_leaf=True, device="cpu"),
        dryad_tpu.predict(jb, X, pred_leaf=True))
    n_iter = (jb.best_iteration if kind == "early" else jb.num_iterations)
    assert got.shape == (X.shape[0], n_iter * jb.num_outputs)
    np.testing.assert_array_equal(
        tb.predict_binned(Xb, pred_leaf=True, num_iteration=2,
                          device="cpu"),
        jb.predict_binned(Xb, pred_leaf=True, num_iteration=2))


def test_leaf_values_sum_to_the_raw_predict(models):
    X, Xb, jb = models["multiclass"]
    tb = port_of(jb)
    leaves = tb.predict_binned(Xb, pred_leaf=True, device="cpu")
    K = tb.num_outputs
    score = np.broadcast_to(tb.init_score, (Xb.shape[0], K)).copy()
    value = tb.arrays["value"]
    for t in range(leaves.shape[1]):
        score[:, t % K] += value[t, leaves[:, t]]
    np.testing.assert_array_equal(
        score, tb.predict_binned(Xb, raw_score=True, device="cpu"))


def _widened(jb, Xb):
    """The reference booster with every split feature moved to WIDE + f,
    and the binned rows placed at those columns of a wider matrix."""
    ta = {k: v.copy() for k, v in jb.tree_arrays().items()}
    internal = ta["feature"] >= 0
    ta["feature"] = np.where(internal, ta["feature"] + WIDE, -1).astype(
        np.int32)
    Xw = np.zeros((Xb.shape[0], WIDE + Xb.shape[1]), Xb.dtype)
    Xw[:, WIDE:] = Xb
    jw = dryad_tpu.Booster(
        jb.params.replace(predict_layout="legacy"), jb.mapper,
        ta["feature"], ta["threshold"], ta["left"], ta["right"],
        ta["value"], ta["is_cat"], ta["cat_bitset"], jb.init_score,
        jb.max_depth_seen, gain=ta["gain"], cover=ta["cover"],
        default_left=ta["default_left"])
    return jw, Xw


@pytest.mark.parametrize("kind", ["binary", "categorical", "multiclass"])
def test_soa_arm_bitwise_packed_and_reference_legacy(models, kind):
    X, Xb, jb = models[kind]
    Xb = Xb[:500]
    tb = port_of(jb)
    packed = tb.predict_binned(Xb, raw_score=True, device="cpu")
    jw, Xw = _widened(jb, Xb)
    tw = port_of(jw)
    assert tw.params.predict_layout == "legacy"
    tw_auto = dt.Booster(tw.params.replace(predict_layout="auto"),
                         tw.mapper, tw.arrays, tw.init_score,
                         tw.max_depth_seen)
    for b in (tw, tw_auto):
        np.testing.assert_array_equal(
            b.predict_binned(Xw, raw_score=True, device="cpu"), packed)
        np.testing.assert_array_equal(
            b.predict_binned(Xw, pred_leaf=True, device="cpu"),
            tb.predict_binned(Xb, pred_leaf=True, device="cpu"))
    np.testing.assert_array_equal(
        np.asarray(predict_binned_device(jw, Xw)).reshape(packed.shape),
        packed)
    with pytest.raises(ValueError, match="does not fit"):
        dt.Booster(tw.params.replace(predict_layout="packed"), tw.mapper,
                   tw.arrays, tw.init_score,
                   tw.max_depth_seen).predict_binned(Xw, device="cpu")
    legacy = dt.Booster(tb.params.replace(predict_layout="legacy"),
                        tb.mapper, tb.arrays, tb.init_score,
                        tb.max_depth_seen)
    np.testing.assert_array_equal(
        legacy.predict_binned(Xb, raw_score=True, device="cpu"), packed)


@pytest.mark.parametrize("kind", ["binary", "multiclass", "categorical"])
def test_importance_dump_and_transform_equal_reference(models, kind):
    X, Xb, jb = models[kind]
    tb = port_of(jb)
    for typ, dtype in (("split", np.int64), ("gain", np.float64)):
        got = tb.feature_importance(typ)
        assert got.dtype == dtype
        np.testing.assert_array_equal(got, jb.feature_importance(typ))
    with pytest.raises(ValueError, match="importance_type"):
        tb.feature_importance("cover")
    want = jb.dump_model()
    got = tb.dump_model()
    assert got["trees"] == want["trees"]
    for key in ("num_iterations", "num_class", "init_score"):
        assert got[key] == want[key]
    assert tb.has_categorical_splits == jb.has_categorical_splits == (
        kind == "categorical")
    raw = tb.predict_binned(Xb, raw_score=True, device="cpu")
    np.testing.assert_array_equal(
        tb.transform_raw(raw.reshape(raw.shape[0], -1)),
        jb.transform_raw(raw.reshape(raw.shape[0], -1)))


def _bundled():
    csr, y, cat = _sparse_cat_csr(n=3000)
    ds = dryad_tpu.Dataset(None, y, csr=csr, categorical_features=cat,
                           max_bins=64)
    jb = dryad_tpu.train(dict(objective="binary", num_trees=6,
                              num_leaves=15, max_bins=64), ds,
                         backend="cpu")
    assert jb.mapper.to_json_dict()["type"] == "bundled"
    assert jb.is_cat.any()
    return ds.X_binned, jb


def _same_arrays(a: dict, b: dict) -> None:
    for k in ARRAY_KEYS:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("kind", ["binary", "multiclass", "rf", "bundled"])
def test_text_model_crosses_both_ways(models, kind, tmp_path):
    if kind == "bundled":
        Xb, jb = _bundled()
    else:
        _, Xb, jb = models[kind]
    tb = port_of(jb)
    want = jb.predict_binned(Xb, raw_score=True)
    # port -> reference
    path = str(tmp_path / "port.json")
    tb.save_text(path)
    jr = dryad_tpu.Booster.load_text(path)
    _same_arrays(jr.tree_arrays(), tb.arrays)
    assert jr.max_depth_seen == tb.max_depth_seen
    np.testing.assert_array_equal(jr.predict_binned(Xb, raw_score=True),
                                  want)
    # reference -> port
    tr = dt.Booster.from_text(jb.dump_text())
    _same_arrays(tr.arrays, jb.tree_arrays())
    np.testing.assert_array_equal(tr.init_score, jb.init_score)
    assert (tr.max_depth_seen, tr.best_iteration) == (
        jb.max_depth_seen, jb.best_iteration)
    assert tr.mapper.to_json_dict() == jb.mapper.to_json_dict()
    np.testing.assert_array_equal(
        tr.predict_binned(Xb, raw_score=True, device="cpu"), want)
    np.testing.assert_array_equal(
        tr.predict_binned(Xb, pred_leaf=True, device="cpu"),
        jb.predict_binned(Xb, pred_leaf=True))
    # a second round trip through the port writes the same document
    assert dt.Booster.from_text(tb.dump_text()).dump_text() == \
        tb.dump_text()


def test_load_any_sniffs_both_formats(models, tmp_path):
    X, _, jb = models["categorical"]
    tb = port_of(jb)
    want = jb.predict(X, raw_score=True)
    for name, save in (("t.npz", tb.save), ("t.txt", tb.save_text),
                       ("j.npz", jb.save), ("j.txt", jb.save_text)):
        path = str(tmp_path / name)
        save(path)
        np.testing.assert_array_equal(
            dt.Booster.load_any(path).predict(X, raw_score=True,
                                              device="cpu"), want)
        np.testing.assert_array_equal(
            dryad_tpu.Booster.load_any(path).predict(X, raw_score=True),
            want)


def test_text_version_guard(models):
    tb = port_of(models["binary"][2])
    doc = json.loads(tb.dump_text())
    assert doc["format"] == "dryad-text" and doc["format_version"] == 1
    assert "profile" not in doc
    doc["format_version"] = 99
    with pytest.raises(ValueError, match="newer"):
        dt.Booster.from_text(json.dumps(doc))
    with pytest.raises(ValueError, match="not a dryad"):
        dt.Booster.from_text(json.dumps({"format": "something-else"}))


@pytest.mark.parametrize("extra", [
    dict(objective="multiclass", num_class=4),
    dict(boosting="rf", subsample=0.7),
    dict(boosting="dart", drop_rate=0.2, max_drop=7),
    dict(boosting="goss", goss_top_rate=0.3),
    dict(categorical_features=[0, 2], monotone_constraints=[0, 1, 0]),
    dict(objective="quantile", alpha=0.3, predict_layout="legacy"),
])
def test_params_cross_both_ways(extra):
    tp = dt.Params.from_dict(dict(num_trees=7, num_leaves=15, **extra))
    jp = JParams.from_dict(tp.to_dict())
    back = dt.Params.from_reference_dict(jp.to_dict())
    assert back == tp
    for k, v in tp.to_dict().items():
        assert getattr(jp, k) == v, k


def test_model_api_refuses_without_a_card(models, monkeypatch):
    """cv, refit, pred_leaf, pred_contrib and the estimators default to
    the card and raise without one; nothing falls back to the CPU."""
    import torch

    from dryad_tpu_torch.sklearn import DryadRegressor

    X, Xb, jb = models["binary"]
    tb = port_of(jb)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    y = (X[:, 0] > 0).astype(np.float32)
    ds = dt.Dataset(X[:600], y[:600], max_bins=16)
    calls = (lambda: tb.predict_binned(Xb, pred_leaf=True),
             lambda: tb.predict_binned(Xb, pred_contrib=True),
             lambda: dt.predict(tb, X, pred_leaf=True),
             lambda: tb.refit(X, y),
             lambda: dt.cv({"num_trees": 1}, ds, nfold=2),
             lambda: DryadRegressor(num_trees=1).fit(X[:600], y[:600]))
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
