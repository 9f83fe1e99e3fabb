"""DART (``boosting="dart"``): the port against the reference on the CPU.

* The drop sets: ``loop_state.dart_drop_set`` equal to the reference's
  ``dart_drop_set`` over a grid of iterations, caps and skip rates.
* The reference's fixture (``tests/test_dart.py``: ``PARAMS``,
  ``higgs_like(4000, seed=23)``): integer tree arrays equal to its CPU
  trainer's and its device arm's (XLA histograms); leaf values within
  rtol 1e-5, atol 1e-6, the reference test's tolerance (separately
  trained value tables, rescaled by every drop, differ by summation
  order).
* The valid set's books: the last eval within 1e-5 of the host AUC of
  predict and within 1e-6 of the reference CPU trainer's; no best
  iteration; a DART continuation does not inherit one.
* Kill and resume (crash at iteration 7, checkpoints every 3): trees,
  values and predict bitwise equal to the straight run.
* Early stopping is refused; a reference DART model file loads in the
  port and predicts bitwise.
"""

import numpy as np
import pytest
import torch

import dryad_tpu
from dryad_tpu.config import make_params as j_make_params
from dryad_tpu.cpu.trainer import dart_drop_set as j_drop_set
from dryad_tpu.datasets import higgs_like

import dryad_tpu_torch as dt
from dryad_tpu_torch.engine.loop_state import dart_drop_set
from dryad_tpu_torch.metrics import auc

PARAMS = dict(objective="binary", boosting="dart", num_trees=20,
              num_leaves=15, max_depth=4, max_bins=32, drop_rate=0.4,
              skip_drop=0.3, seed=2)
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
    X, y = higgs_like(4000, seed=23)
    return (X, y, dt.Dataset(X, y, max_bins=32),
            dryad_tpu.Dataset(X, y, max_bins=32))


def test_drop_sets_equal_reference():
    for kw in ({}, {"skip_drop": 0.0, "drop_rate": 0.9, "max_drop": 5},
               {"skip_drop": 1.0}, {"drop_rate": 0.0}):
        jp = j_make_params(dict(PARAMS, **kw))
        tp = dt.Params.from_dict(dict(PARAMS, **kw))
        for it in range(40):
            got = dart_drop_set(tp, it, it)
            np.testing.assert_array_equal(got, j_drop_set(jp, it, it))
            assert got.dtype == np.int64
            assert got.size <= tp.max_drop
    assert any(dart_drop_set(dt.Params.from_dict(PARAMS), it, it).size
               for it in range(20))


def test_dart_trees_match_reference_trainers(data):
    X, y, tds, jds = data
    tb = dt.train(PARAMS, tds, device="cpu")
    ta = tb.tree_arrays()
    for jb in (dryad_tpu.train(PARAMS, jds, backend="cpu"),
               dryad_tpu.train(dict(PARAMS, hist_backend="xla"), jds,
                               backend="tpu")):
        ja = jb.tree_arrays()
        for k in _INT:
            np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
        np.testing.assert_allclose(ta["value"], ja["value"], rtol=1e-5,
                                   atol=1e-6)
    # drops happened: some trees were shrunk after they were grown
    peak = np.abs(ta["value"]).max(axis=1)
    assert (peak[1:] < peak.max()).any()


def test_dart_valid_books(data):
    X, y, tds, jds = data
    params = dict(PARAMS, num_trees=10)
    seen, jseen = {}, {}
    tb = dt.train(params, tds, [tds], device="cpu",
                  callback=lambda it, info: seen.update(info))
    dryad_tpu.train(params, jds, [jds], backend="cpu",
                    callback=lambda it, info: jseen.update(info))
    recomp = auc(y, dt.predict(tb, X, raw_score=True, device="cpu"))
    assert abs(seen["valid_auc"] - recomp) < 1e-5
    assert abs(seen["valid_auc"] - jseen["valid_auc"]) < 1e-6
    assert tb.best_iteration == -1
    # a DART continuation of a model with a best iteration drops it
    gb = dt.train(dict(PARAMS, boosting="gbdt", num_trees=4, metric="auc",
                       early_stopping_rounds=2), tds, [tds], device="cpu")
    assert gb.best_iteration > 0
    cont = dt.train(dict(PARAMS, num_trees=2), tds, [tds], device="cpu",
                    init_model=gb)
    assert cont.best_iteration == -1 and cont.num_iterations == 6


def test_dart_kill_and_resume_bitwise(tmp_path, data):
    X, y, tds, _ = data
    p = dict(PARAMS, num_trees=12)
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


def test_dart_rejects_early_stopping():
    with pytest.raises(ValueError, match="early_stopping"):
        dt.Params.from_dict(dict(PARAMS, early_stopping_rounds=3))
    for bad in ({"drop_rate": 1.5}, {"skip_drop": -0.1}, {"max_drop": 0}):
        with pytest.raises(ValueError):
            dt.Params.from_dict(dict(PARAMS, **bad))


def test_reference_dart_model_file_predicts_bitwise(tmp_path, data):
    X, y, _, jds = data
    jb = dryad_tpu.train(dict(PARAMS, num_trees=6), jds, backend="cpu")
    path = str(tmp_path / "dart.dryad")
    jb.save(path)
    tb = dt.Booster.load(path)
    assert tb.params.boosting == "dart" and tb.params.drop_rate == 0.4
    np.testing.assert_array_equal(tb.predict(X, raw_score=True,
                                             device="cpu"),
                                  jb.predict(X, raw_score=True))


# ROADMAP Queue 3's F1 fixture: the key features sit past the packed
# words' 12-bit feature field
WIDE_PARAMS = dict(objective="binary", boosting="dart", num_trees=8,
                   growth="depthwise", max_depth=2, num_leaves=4,
                   max_bins=16, drop_rate=0.5, skip_drop=0.0,
                   learning_rate=0.5, seed=1, min_data_in_leaf=5)


@pytest.fixture(scope="module")
def wide():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(2000, 4100)).astype(np.float32)
    y = (X[:, 4099] + 0.3 * X[:, 4098]
         + 0.2 * rng.normal(size=2000) > 0).astype(np.float32)
    return X, y, dt.Dataset(X, y, max_bins=16)


def test_dart_wide_features_match_reference(wide):
    X, y, tds = wide
    tb = dt.train(WIDE_PARAMS, tds, device="cpu")
    jb = dryad_tpu.train(WIDE_PARAMS, dryad_tpu.Dataset(X, y, max_bins=16),
                         backend="cpu")
    ta, ja = tb.tree_arrays(), jb.tree_arrays()
    assert (ta["feature"] >= 4096).any()
    for k in _INT:
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    np.testing.assert_allclose(ta["value"], ja["value"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tb.predict(X, raw_score=True, device="cpu"),
                               jb.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("boosting", ["gbdt", "dart"])
def test_valid_set_past_packed_widths(wide, boosting):
    X, y, tds = wide
    seen = {}
    vds = tds.bind(X[:500], y[:500])
    tb = dt.train(dict(WIDE_PARAMS, boosting=boosting, num_trees=4,
                       metric="auc"), tds, [vds], device="cpu",
                  callback=lambda it, info: seen.update(info))
    assert (tb.tree_arrays()["feature"] >= 4096).any()
    recomp = auc(y[:500], dt.predict(tb, X[:500], raw_score=True,
                                     num_iteration=4, device="cpu"))
    assert abs(seen["valid_auc"] - recomp) < 1e-6


def test_table_words_routes_around_packed_widths():
    from dryad_tpu_torch.engine.predict import (
        SOA_KEYS, pack_words, packed_fits, table_words, unpack_node_words)

    M = 7
    out = {k: torch.zeros((3, M), dtype=torch.int64) for k in SOA_KEYS}
    out["feature"][:] = -1
    out["feature"][:, 0] = torch.tensor([4099, 3, 4095])
    out["left"][:, 0], out["right"][:, 0] = 1, 2
    out["threshold"][:, 0] = 5
    assert packed_fits(4096, 65536)
    assert not packed_fits(4097, M) and not packed_fits(10, 65537)
    # past the width: the SoA dict, every field as it was
    wide_t = table_words(out, slice(0, 3), 4100)
    assert isinstance(wide_t, dict)
    assert wide_t["feature"][0, 0].item() == 4099
    one = table_words(out, 0, 4100)
    assert one["feature"].shape == (M,)
    # within it: the packed words, which read back every field
    narrow = table_words(out, slice(1, 3), 4096)
    assert torch.equal(narrow, pack_words(*(out[k][1:3] for k in (
        "feature", "threshold", "left", "right", "default_left",
        "is_cat"))))
    np.testing.assert_array_equal(
        unpack_node_words(narrow.numpy())["feature"][:, 0], [3, 4095])
