"""Random-forest mode (``boosting="rf"``): the port against the reference
on the CPU.

* The reference's fixture (``tests/test_rf.py``: ``PARAMS``,
  ``higgs_like(8000, seed=3)``): integer tree arrays equal to its CPU
  trainer's and its device arm's (XLA histograms), leaf values within
  rtol 1e-4, atol 1e-6 (the reference test's tolerance).  The 25 trees
  grow on the legacy arm; the default wired arm grows the first 5 (rf
  trees are independent of one another: constant g/h, a bag each).
* Predict is ``rf_average`` of the raw tree sums, bitwise; the port's
  model file predicts bitwise in the reference and the reference's in
  the port.
* The streamed valid metric scores the averaged model: within 1e-5 of
  the host AUC of predict at the full length.
* Kill and resume bitwise; continuing across rf and non-rf is refused.
* Multiclass rf (3 classes): trees equal to the CPU trainer's, values
  within rtol 1e-4, atol 1e-6.
"""

import numpy as np
import pytest
import torch

import dryad_tpu
from dryad_tpu.cpu.predict import rf_average as j_rf_average
from dryad_tpu.datasets import covertype_like, higgs_like

import dryad_tpu_torch as dt
from dryad_tpu_torch.engine.predict import accumulate, rf_average, stage_trees
from dryad_tpu_torch.metrics import auc

PARAMS = dict(objective="binary", boosting="rf", num_trees=25,
              num_leaves=31, max_depth=6, max_bins=64, subsample=0.7,
              colsample=0.8, seed=5)
LEGACY = dict(PARAMS, deep_layout="legacy")
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


@pytest.fixture(scope="module")
def data():
    X, y = higgs_like(8000, seed=3)
    tds = dt.Dataset(X, y, max_bins=64)
    jds = dryad_tpu.Dataset(X, y, max_bins=64)
    return X, y, tds, jds, dt.train(LEGACY, tds, device="cpu")


def _same_trees(ta, ja, n=None):
    for k in _INT:
        np.testing.assert_array_equal(ta[k], ja[k][:n], err_msg=k)
    np.testing.assert_allclose(ta["value"], ja["value"][:n], rtol=1e-4,
                               atol=1e-6)


def test_rf_params():
    with pytest.raises(ValueError, match="subsample"):
        dt.Params.from_dict(dict(PARAMS, subsample=1.0))
    p = dt.Params.from_dict(dict(PARAMS, learning_rate=0.05))
    assert p.effective_learning_rate == 1.0
    assert dt.Params.from_dict(dict(PARAMS, boosting="gbdt",
                                    learning_rate=0.05)
                               ).effective_learning_rate == 0.05


def test_rf_trees_match_reference_trainers(data, tmp_path):
    X, y, tds, jds, tb = data
    jb = dryad_tpu.train(PARAMS, jds, backend="cpu")
    _same_trees(tb.tree_arrays(), jb.tree_arrays())
    # the reference's model file loads in the port and predicts averaged,
    # bitwise
    path = str(tmp_path / "ref_rf.dryad")
    jb.save(path)
    np.testing.assert_array_equal(
        dt.Booster.load(path).predict(X, raw_score=True, device="cpu"),
        jb.predict(X, raw_score=True))
    jdev = dryad_tpu.train(dict(PARAMS, hist_backend="xla"), jds,
                           backend="tpu")
    _same_trees(tb.tree_arrays(), jdev.tree_arrays())
    wired = dt.train(dict(PARAMS, num_trees=5), tds, device="cpu")
    _same_trees(wired.tree_arrays(), jb.tree_arrays(), 5)


def test_rf_predict_is_the_average(data, tmp_path):
    X, y, tds, _, tb = data
    raw = tb.predict(X, raw_score=True, device="cpu")
    words, value, _, init, n = stage_trees(tb)
    total = accumulate(torch.from_numpy(words), torch.from_numpy(value),
                       torch.from_numpy(tds.X_binned),
                       torch.zeros(1), tb.max_depth_seen).numpy()
    sums = accumulate(torch.from_numpy(words), torch.from_numpy(value),
                      torch.from_numpy(tds.X_binned),
                      torch.from_numpy(init), tb.max_depth_seen).numpy()
    assert n == 25
    np.testing.assert_array_equal(raw, rf_average(sums, init, n)[:, 0])
    np.testing.assert_array_equal(rf_average(sums, init, n),
                                  j_rf_average(sums, init, n))
    # full-strength trees, averaged: the raw scores stay bounded
    assert np.abs(raw).max() < np.abs(total).max()
    path = str(tmp_path / "rf.dryad")
    tb.save(path)
    jb = dryad_tpu.Booster.load(path)
    np.testing.assert_array_equal(jb.predict(X, raw_score=True), raw)
    np.testing.assert_array_equal(
        dt.Booster.load(path).predict(X, raw_score=True, device="cpu"), raw)


def test_rf_valid_books_score_the_average(data):
    X, y, tds, _, _ = data
    seen = {}
    b = dt.train(dict(LEGACY, num_trees=10), tds, [tds], device="cpu",
                 callback=lambda it, info: seen.update(info))
    recomp = auc(y, dt.predict(b, X, raw_score=True,
                               num_iteration=b.num_iterations, device="cpu"))
    assert abs(seen["valid_auc"] - recomp) < 1e-5


def test_rf_kill_and_resume_bitwise(tmp_path, data):
    X, y, tds, _, _ = data
    p = dict(LEGACY, num_trees=12)
    full = dt.train(p, tds, device="cpu")

    class Crash(RuntimeError):
        pass

    def crash_at(it, info):
        if it == 7:
            raise Crash

    ckdir = str(tmp_path / "ck")
    with pytest.raises(Crash):
        dt.train(p, tds, device="cpu", checkpoint_dir=ckdir,
                 checkpoint_every=3, callback=crash_at)
    resumed = dt.train(p, tds, device="cpu", checkpoint_dir=ckdir,
                       checkpoint_every=3, resume=True)
    for k in ("feature", "threshold", "value"):
        np.testing.assert_array_equal(full.arrays[k], resumed.arrays[k],
                                      err_msg=k)
    np.testing.assert_array_equal(
        dt.predict(full, X, raw_score=True, device="cpu"),
        dt.predict(resumed, X, raw_score=True, device="cpu"))


def test_rf_mixed_continuation_refused(data):
    X, y, tds, _, tb = data
    gb = dt.train(dict(LEGACY, boosting="gbdt", num_trees=2), tds,
                  device="cpu")
    with pytest.raises(ValueError, match="rf"):
        dt.train(dict(LEGACY, num_trees=4), tds, device="cpu",
                 init_booster=gb)
    with pytest.raises(ValueError, match="rf"):
        dt.train(dict(LEGACY, boosting="gbdt", num_trees=1), tds,
                 device="cpu", init_model=tb)


def test_rf_multiclass_matches_cpu_trainer():
    X, y = covertype_like(3000, 12, 3, seed=11)
    p = dict(PARAMS, objective="multiclass", num_class=3, max_bins=32,
             num_trees=4, max_depth=4, num_leaves=15, deep_layout="legacy")
    tb = dt.train(p, dt.Dataset(X, y, max_bins=32), device="cpu")
    jb = dryad_tpu.train(p, dryad_tpu.Dataset(X, y, max_bins=32),
                         backend="cpu")
    assert tb.num_total_trees == 12
    _same_trees(tb.tree_arrays(), jb.tree_arrays())
    prob = dt.predict(tb, X, device="cpu")
    np.testing.assert_allclose(prob.sum(1), 1.0, rtol=1e-5)
    assert (prob.argmax(1) == y).mean() > 0.5
