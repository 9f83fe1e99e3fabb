"""Monotone constraints: the port against the reference on the CPU.

* The split scan's monotone arm on seeded histograms, with finite and
  infinite candidate bounds, both missing-value planes, against the
  reference's ``find_best_split(monotone=...)``: the choice (feature,
  threshold, default direction) and the left count equal; gains and
  left sums within rtol 1e-5, as the unconstrained scan's test holds them
  (XLA fuses the gain's arithmetic on the CPU and rounds it a few ulp
  apart from torch's separate operations).
* The reference's fixtures (``tests/test_goss_monotone.py:121-171``):
  stumps, deep leaf-wise and depthwise (depth 6), a decreasing constraint
  and the 15-leaf parity fixture.  Integer tree arrays equal to the
  reference's CPU trainer's on every grower and arm (the batched
  leaf-wise grower wired and legacy, the sequential grower, depthwise
  wired and legacy; the wired arm grows the first trees of a fixture,
  the costlier one in the plain versions), and to its device arm (XLA
  histograms) on the parity fixture; leaf values within rtol 1e-5, atol 1e-6 (the packages sum
  histograms in different orders and precisions).
* Predictions monotone along each constrained feature over a grid (64
  base rows x 48 points, the reference test's), within 1e-6.
* A bundled (EFB) Dataset refuses monotone constraints.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import dryad_tpu
from dryad_tpu.engine.split import find_best_split as j_find

import dryad_tpu_torch as dt
from dryad_tpu_torch.engine.split import find_best_split as t_find

_INT = ("feature", "threshold", "left", "right", "default_left")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the module (its module-scoped fits
    included): these fixtures are small, and under the suite's parallel
    workers torch's thread pools would oversubscribe the cores many times
    over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_trees(tb, jb):
    """``tb``'s trees equal the first ones of ``jb``."""
    ta, ja = tb.tree_arrays(), jb.tree_arrays()
    n = tb.num_total_trees
    for k in _INT:
        np.testing.assert_array_equal(ta[k], ja[k][:n], err_msg=k)
    np.testing.assert_allclose(ta["value"], ja["value"][:n], rtol=1e-5,
                               atol=1e-6)


def _both(params, X, y, bins):
    jb = dryad_tpu.train(params, dryad_tpu.Dataset(X, y, max_bins=bins),
                         backend="cpu")
    tds = dt.Dataset(X, y, max_bins=bins)
    return tds, jb


def _grid_scores(booster, X, feature, rng, n_base=64, n_grid=48):
    base = rng.normal(size=(n_base, X.shape[1])).astype(np.float32)
    grid = np.linspace(X[:, feature].min(), X[:, feature].max(), n_grid,
                       dtype=np.float32)
    pts = np.repeat(base, grid.size, axis=0)
    pts[:, feature] = np.tile(grid, n_base)
    return booster.predict(pts, raw_score=True, device="cpu").reshape(
        n_base, n_grid)


@pytest.mark.parametrize("learn_missing", [False, True])
def test_scan_monotone_arm_bitwise_equal_reference(learn_missing):
    rng = np.random.default_rng(5 + learn_missing)
    K, F, B = 6, 5, 24
    c = rng.integers(0, 40, (K, F, B)).astype(np.float32)
    if not learn_missing:
        c[:, :, 0] = 0
    g = (rng.normal(size=(K, F, B)) * c).astype(np.float32)
    h = (rng.uniform(0.1, 0.3, (K, F, B)) * c).astype(np.float32)
    hist = np.stack([g, h, c], 1)
    G, H, C = (hist[:, i, 0].sum(-1) for i in range(3))
    mono = np.array([1, -1, 0, 1, 0], np.int32)
    lo = np.array([-np.inf, -0.5, -np.inf, 0.0, -1.0, -0.2], np.float32)
    hi = np.array([np.inf, 0.5, 0.3, np.inf, 1.0, 0.2], np.float32)
    fmask = np.ones(F, bool)
    allow = np.ones(K, bool)
    kw = dict(lambda_l2=1.0, min_child_weight=1e-3, min_data_in_leaf=20,
              min_split_gain=0.0)
    got = t_find(torch.from_numpy(hist), torch.from_numpy(G),
                 torch.from_numpy(H), torch.from_numpy(C),
                 feat_mask=torch.from_numpy(fmask),
                 allow=torch.from_numpy(allow), learn_missing=learn_missing,
                 monotone=torch.from_numpy(mono), lo=torch.from_numpy(lo),
                 hi=torch.from_numpy(hi), **kw)
    free = t_find(torch.from_numpy(hist), torch.from_numpy(G),
                  torch.from_numpy(H), torch.from_numpy(C),
                  feat_mask=torch.from_numpy(fmask),
                  allow=torch.from_numpy(allow), learn_missing=learn_missing,
                  **kw)
    for k in range(K):
        ref = j_find(jnp.asarray(hist[k]), jnp.float32(G[k]),
                     jnp.float32(H[k]), jnp.float32(C[k]),
                     feat_mask=jnp.asarray(fmask),
                     is_cat_feat=jnp.zeros(F, bool),
                     allow=jnp.asarray(allow[k]), has_cat=False,
                     monotone=jnp.asarray(mono), lo=jnp.float32(lo[k]),
                     hi=jnp.float32(hi[k]), learn_missing=learn_missing,
                     **kw)
        for name in ("feature", "threshold", "default_left", "c_left"):
            np.testing.assert_array_equal(
                got[name][k].numpy(), np.asarray(getattr(ref, name)),
                err_msg=f"{name}[{k}]")
        for name in ("gain", "g_left", "h_left"):
            np.testing.assert_allclose(
                got[name][k].numpy(), np.asarray(getattr(ref, name)),
                rtol=1e-5, err_msg=f"{name}[{k}]")
    # the constraint changes some choice on this grid
    assert not torch.equal(got["gain"], free["gain"])


def test_stumps_hold_and_refuse_the_wrong_sign():
    rng = np.random.default_rng(77)
    X = rng.normal(size=(3000, 4)).astype(np.float32)
    y = (X[:, 0] - X[:, 1] + 0.3 * rng.normal(size=3000) > 0
         ).astype(np.float32)
    base = dict(objective="binary", num_trees=30, num_leaves=2, max_depth=1,
                max_bins=64)
    tds, jb = _both(dict(base, monotone_constraints=(1, -1, 0, 0)), X, y, 64)
    tb = dt.train(dict(base, monotone_constraints=(1, -1, 0, 0)), tds,
                  device="cpu")
    _same_trees(tb, jb)
    for f, sign in ((0, 1), (1, -1)):
        X2 = X[:500].copy()
        X2[:, f] += 1.0
        d = (tb.predict(X2, raw_score=True, device="cpu")
             - tb.predict(X[:500], raw_score=True, device="cpu"))
        assert (sign * d >= -1e-7).all()
    flip = dict(base, monotone_constraints=(-1, 1, 0, 0))
    tf = dt.train(flip, tds, device="cpu")
    _same_trees(tf, dryad_tpu.train(flip, dryad_tpu.Dataset(X, y,
                                                            max_bins=64),
                                    backend="cpu"))
    used = tf.arrays["feature"][tf.arrays["feature"] >= 0]
    assert used.size and not np.isin(used, [0, 1]).any()


@pytest.mark.parametrize("growth", ["leafwise", "depthwise"])
def test_deep_trees_match_cpu_trainer_and_stay_monotone(growth):
    rng = np.random.default_rng(81)
    X = rng.normal(size=(4000, 4)).astype(np.float32)
    y = (X[:, 0] + 0.8 * np.sin(2 * X[:, 1]) + 0.3 * rng.normal(size=4000)
         ).astype(np.float32)
    params = dict(objective="regression", num_trees=25, num_leaves=31,
                  max_depth=6, growth=growth, max_bins=64,
                  monotone_constraints=(1, 0, 0, 0))
    tds, jb = _both(params, X, y, 64)
    # the 25 trees on the legacy arm, the first 5 on the default wired one
    _same_trees(dt.train(dict(params, num_trees=5), tds, device="cpu"), jb)
    tb = dt.train(dict(params, deep_layout="legacy"), tds, device="cpu")
    _same_trees(tb, jb)
    assert tb.max_depth_seen >= 3
    s = _grid_scores(tb, X, 0, rng)
    assert (np.diff(s, axis=1) >= -1e-6).all()


def test_decreasing_constraint_on_the_legacy_arm():
    rng = np.random.default_rng(83)
    X = rng.normal(size=(3000, 3)).astype(np.float32)
    y = (-X[:, 0] + 0.5 * X[:, 1] ** 2 + 0.2 * rng.normal(size=3000)
         ).astype(np.float32)
    params = dict(objective="regression", num_trees=15, num_leaves=31,
                  max_bins=32, monotone_constraints=(-1, 0, 0))
    tds, jb = _both(params, X, y, 32)
    # the default depth 9 takes the wired arm; its legacy arm grows the
    # same trees (tests/test_torch_leafwise.py) at a fraction of the
    # plain versions' cost
    tb = dt.train(dict(params, deep_layout="legacy"), tds, device="cpu")
    assert tb.params.max_depth == 9
    _same_trees(tb, jb)
    s = _grid_scores(tb, X, 0, rng, n_base=32, n_grid=32)
    assert (np.diff(s, axis=1) <= 1e-6).all()


def test_parity_fixture_on_every_leafwise_grower(tmp_path):
    rng = np.random.default_rng(79)
    X = rng.normal(size=(3000, 5)).astype(np.float32)
    y = (X[:, 0] + np.sin(X[:, 2]) + 0.2 * rng.normal(size=3000)
         ).astype(np.float32)
    params = dict(objective="regression", num_trees=8, num_leaves=15,
                  max_bins=32, monotone_constraints=(1, 0, 0, 0, 0))
    tds, jb = _both(params, X, y, 32)
    jdev = dryad_tpu.train(dict(params, hist_backend="xla"),
                           dryad_tpu.Dataset(X, y, max_bins=32),
                           backend="tpu")
    # the default depth 8 takes the wired arm (its first two trees here),
    # the legacy arm and the sequential grower all eight
    for extra in ({"num_trees": 2}, {"deep_layout": "legacy"},
                  {"unbounded_depth": "exact"}):
        tb = dt.train(dict(params, **extra), tds, device="cpu")
        _same_trees(tb, jb)
        _same_trees(tb, jdev)
    # the sequential grower is the one unbounded_depth="exact" takes
    assert tb.params.max_depth == -1
    path = str(tmp_path / "mono.dryad")
    tb.save(path)
    j_of_t = dryad_tpu.Booster.load(path)
    assert tuple(j_of_t.params.monotone_constraints) == (1, 0, 0, 0, 0)
    np.testing.assert_array_equal(j_of_t.predict(X, raw_score=True),
                                  tb.predict(X, raw_score=True,
                                             device="cpu"))


def test_bundled_dataset_refuses_monotone():
    from test_bundling import _sparse_cat_csr

    csr, y, cat = _sparse_cat_csr(n=3000)
    ds = dt.Dataset(None, y, csr=csr, categorical_features=cat, max_bins=32)
    assert getattr(ds.mapper, "bundled_mask", None) is not None
    with pytest.raises(ValueError, match="bundling"):
        dt.train({"objective": "binary", "num_trees": 1,
                  "monotone_constraints": [1]}, ds, device="cpu")
