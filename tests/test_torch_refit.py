"""``Booster.refit`` of the port against the reference's on the CPU.

The same reference model (its CPU trainer) and the same new rows go
through ``dryad_tpu.Booster.refit`` and, carried across by
``convert.booster_from_reference``, the port's ``refit(device="cpu")``.
Tree structure arrays are equal and leaf values within rtol 1e-5 / atol
1e-6: the reference sums numpy's g/h in f64 on the host, the port sums
g/h in ``grad_hess_jax``'s op order as int64 fixed point, each sum
rounded once.  Cases: decay 0.9 on shifted rows, decay 0 on the
training rows, l1 at decay 0 (the renewal convention), multiclass K=3,
rf, and weighted rows.  Decay 1.0 returns the values bitwise; DART,
lambdarank and decay 1.5 are refused with the reference's messages; two
refits are bitwise equal; the result has no best iteration and no loop
state.
"""

import numpy as np
import pytest

import dryad_tpu
from dryad_tpu.datasets import covertype_like, higgs_like, mslr_like

import dryad_tpu_torch as dt
from dryad_tpu_torch.booster import ARRAY_KEYS
from torch_layout import one_torch_thread, port_of  # noqa: F401 (autouse)

RTOL, ATOL = 1e-5, 1e-6
BASE = dict(num_trees=8, num_leaves=15, max_bins=32)


def _model(kind):
    """(X, y, reference booster) trained on the reference's CPU."""
    if kind == "multiclass":
        X, y = covertype_like(3000, 20, 3, seed=8)
        p = dict(BASE, objective="multiclass", num_class=3, num_trees=4)
    else:
        X, y = higgs_like(4000, seed=12)
        p = dict(BASE, objective="binary")
        if kind == "rf":
            p.update(boosting="rf", subsample=0.7, colsample=0.8, seed=2)
        elif kind == "l1":
            y = (X[:, 0] * 2 + X[:, 1] + 0.1 * y).astype(np.float32)
            p.update(objective="l1")
    ds = dryad_tpu.Dataset(X, y, max_bins=32)
    return X, y, dryad_tpu.train(p, ds, backend="cpu")


@pytest.fixture(scope="module")
def models():
    return {k: _model(k) for k in ("binary", "multiclass", "rf", "l1")}


def _check(jr, tr, jb):
    for k in ARRAY_KEYS:
        if k != "value":
            np.testing.assert_array_equal(tr.arrays[k], jb.tree_arrays()[k],
                                          err_msg=k)
    np.testing.assert_allclose(tr.arrays["value"], jr.value, rtol=RTOL,
                               atol=ATOL)
    assert not np.array_equal(tr.arrays["value"], jb.value)
    assert tr.best_iteration == jr.best_iteration == -1
    assert tr.train_state == {}


@pytest.mark.parametrize("kind,decay,shift", [
    ("binary", 0.9, 0.3),
    ("binary", 0.0, 0.0),
    ("l1", 0.0, 0.2),
    ("multiclass", 0.5, 0.1),
    ("rf", 0.9, 0.3),
])
def test_refit_matches_reference(models, kind, decay, shift):
    X, y, jb = models[kind]
    Xn = (X + np.float32(shift)).astype(np.float32)
    jr = jb.refit(Xn, y, decay_rate=decay)
    tb = port_of(jb)
    tr = tb.refit(Xn, y, decay_rate=decay, device="cpu")
    _check(jr, tr, jb)
    np.testing.assert_allclose(
        tr.predict(Xn, raw_score=True, device="cpu"),
        jr.predict(Xn, raw_score=True), rtol=1e-4, atol=1e-5)


def test_weighted_refit_matches_reference(models):
    X, y, jb = models["binary"]
    w = np.random.default_rng(4).uniform(0.5, 2.0, X.shape[0]).astype(
        np.float32)
    jr = jb.refit(X, y, weight=w, decay_rate=0.3)
    tr = port_of(jb).refit(X, y, weight=w, decay_rate=0.3, device="cpu")
    _check(jr, tr, jb)


def test_decay_one_returns_the_values_and_refits_repeat(models):
    X, y, jb = models["multiclass"]
    tb = port_of(jb)
    same = tb.refit(X[:1000], y[:1000], decay_rate=1.0, device="cpu")
    np.testing.assert_array_equal(same.arrays["value"], tb.arrays["value"])
    a = tb.refit(X, y, decay_rate=0.7, device="cpu")
    b = tb.refit(X, y, decay_rate=0.7, device="cpu")
    np.testing.assert_array_equal(a.arrays["value"], b.arrays["value"])


def test_refit_refusals_match_reference():
    X, y = higgs_like(1500, seed=1)
    ds = dryad_tpu.Dataset(X, y, max_bins=16)
    dart = dryad_tpu.train(dict(objective="binary", num_trees=3,
                                num_leaves=7, boosting="dart"), ds,
                           backend="cpu")
    Xr, yr, group = mslr_like(num_queries=20, seed=3)
    rds = dryad_tpu.Dataset(Xr, yr, group=group, max_bins=16)
    rank = dryad_tpu.train(dict(objective="lambdarank", num_trees=2,
                                num_leaves=7), rds, backend="cpu")
    plain = dryad_tpu.train(dict(objective="binary", num_trees=2,
                                 num_leaves=7), ds, backend="cpu")
    for jb, Xn, yn, decay in ((dart, X, y, 0.9), (rank, Xr, yr, 0.9),
                              (plain, X, y, 1.5), (plain, X, y, -0.1)):
        with pytest.raises(ValueError) as want:
            jb.refit(Xn, yn, decay_rate=decay)
        with pytest.raises(ValueError) as got:
            port_of(jb).refit(Xn, yn, decay_rate=decay, device="cpu")
        assert str(got.value) == str(want.value)
