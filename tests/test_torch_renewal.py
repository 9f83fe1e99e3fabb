"""L1-family leaf renewal in the port (``engine/train.renew_values``,
gated by ``objectives.renew_alpha``) against the reference.

* ``renew_values`` against ``dryad_tpu.engine.train._renew_values`` on the
  same (value, feature, leaves, y, score, bag): equal bit for bit.  The
  residuals include +0.0, -0.0 and repeated values: the reference's
  stable ``lax.sort`` compares -0.0 equal to +0.0 and keeps row order,
  and so does the port's one stable sort of combined keys, so even the
  sign of a selected zero agrees.
* The reference's ``tests/test_renewal.py`` cases, run on the port:
  one tree's leaves are the type-1 medians of their residuals times the
  learning rate (exactly); bagged runs renew from in-bag rows only and
  match the reference's trees (integer arrays equal, values within 1e-5
  as the reference's own cross-backend bound, rtol 1e-4); weighted data
  skips renewal; renewal lowers the pinball loss of a quantile model.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dryad_tpu
from dryad_tpu.cpu.predict import predict_tree_leaves
from dryad_tpu.engine.train import _renew_values

import dryad_tpu_torch as dt
from dryad_tpu_torch.engine import train as engine_train
from dryad_tpu_torch.engine.train import renew_values
from torch_layout import one_torch_thread  # noqa: F401 (autouse)


def _toy(n=6000, seed=4):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 8)).astype(np.float32)
    y = (X[:, 0] * 2 + np.sin(X[:, 1] * 3)
         + rng.standard_t(2.0, n) * 0.5).astype(np.float32)
    return X, y


@pytest.mark.parametrize("alpha", [0.5, 0.9, 0.1, 0.999])
@pytest.mark.parametrize("bag_rate", [1.0, 0.6])
def test_renew_values_equal_reference(alpha, bag_rate):
    rng = np.random.Generator(np.random.Philox(12))
    n, M = 5000, 15
    feature = np.where(rng.random(M) < 0.5, -1, 3).astype(np.int64)
    leaves = rng.integers(0, M, size=n).astype(np.int64)
    leaves[leaves == 4] = 5                  # node 4 holds no row
    y = np.round(rng.normal(size=n), 1).astype(np.float32)
    score = np.round(rng.normal(size=n), 1).astype(np.float32)
    score[::7] = y[::7]                      # +0.0 residuals
    y[::11], score[::11] = -0.0, 0.0         # -0.0 residuals
    bag = rng.random(n) < bag_rate
    value = rng.normal(size=M).astype(np.float32)
    got = renew_values(*(torch.from_numpy(a) for a in
                         (value, feature, leaves, y, score, bag)),
                       alpha, 0.3, M).numpy()
    want = np.asarray(_renew_values(*(jnp.asarray(a) for a in
                                      (value, feature, leaves, y, score,
                                       bag)), alpha, 0.3, M))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert got[4] == value[4] and (got[feature >= 0] == value[feature >= 0]
                                   ).all()


def test_single_tree_leaves_are_residual_medians():
    X, y = _toy(2000)
    ds = dt.Dataset(X, y, max_bins=64)
    b = dt.train(dict(objective="l1", num_trees=1, num_leaves=4, max_depth=2,
                      learning_rate=0.3, min_data_in_leaf=20), ds,
                 device="cpu")
    lv = predict_tree_leaves(b.tree_arrays(), ds.X_binned, 0,
                             b.max_depth_seen)
    r = (y - np.float32(b.init_score[0])).astype(np.float32)
    value = b.arrays["value"]
    for node in np.unique(lv):
        rs = np.sort(r[lv == node])
        kf = np.ceil(np.float32(0.5) * np.float32(rs.size))
        kidx = min(max(int(kf) - 1, 0), rs.size - 1)
        assert value[0, node] == np.float32(rs[kidx]) * np.float32(0.3)


@pytest.mark.parametrize("obj,extra", [("l1", {"subsample": 0.6, "seed": 9}),
                                       ("quantile", {"alpha": 0.9})])
def test_renewal_matches_reference(obj, extra):
    X, y = _toy()
    p = dict(objective=obj, num_trees=6, num_leaves=15, max_depth=4,
             max_bins=32, learning_rate=0.2, **extra)
    jb = dryad_tpu.train(p, dryad_tpu.Dataset(X, y, max_bins=32),
                         backend="tpu", hist_backend="xla")
    tb = dt.train(p, dt.Dataset(X, y, max_bins=32), device="cpu")
    ref = jb.tree_arrays()
    for k in ("feature", "threshold", "left", "right", "default_left"):
        np.testing.assert_array_equal(tb.arrays[k], np.asarray(ref[k]),
                                      err_msg=k)
    np.testing.assert_allclose(tb.arrays["value"], ref["value"], rtol=1e-4,
                               atol=1e-5)


def test_weighted_data_skips_renewal(monkeypatch):
    X, y = _toy(3000)
    p = dict(objective="l1", num_trees=4, num_leaves=15, max_depth=4)
    b_w = dt.train(p, dt.Dataset(X, y, weight=np.ones_like(y)),
                   device="cpu")
    monkeypatch.setattr(engine_train, "renew_alpha", lambda *a, **k: None)
    b_off = dt.train(p, dt.Dataset(X, y), device="cpu")
    np.testing.assert_array_equal(b_w.arrays["value"], b_off.arrays["value"])


def test_renewal_improves_quantile_loss(monkeypatch):
    X, y = _toy(8000)
    ds = dt.Dataset(X[:6000], y[:6000], max_bins=64)
    Xt, yt = X[6000:], y[6000:]
    p = dict(objective="quantile", alpha=0.9, num_trees=8, num_leaves=15,
             growth="depthwise", max_depth=4, max_bins=64)
    b_on = dt.train(p, ds, device="cpu")
    monkeypatch.setattr(engine_train, "renew_alpha", lambda *a, **k: None)
    b_off = dt.train(p, ds, device="cpu")

    def pinball(b):
        d = yt - dt.predict(b, Xt, device="cpu")
        return float(np.mean(np.maximum(0.9 * d, -0.1 * d)))

    assert pinball(b_on) < pinball(b_off)
