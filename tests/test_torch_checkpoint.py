"""Checkpoints, resume, model files and warm starts of the port.

* Kill-and-resume: a run that crashes after a checkpoint and resumes from
  it equals the straight run bit for bit (every tree array, raw predict),
  with and without a valid set and early stopping: the resumed run
  rebuilds its train and valid scores by replaying the trees in the
  straight run's fp32 order, and redraws the same bags.  Checked on the
  CPU here; ``chip_smoke.py`` checks it on the card.
* Model files cross both ways: a file the port saves loads in
  ``dryad_tpu.Booster.load`` and the two packages' raw predictions are
  bitwise equal, and the reverse (traversal compares integers; the leaf
  values add in fp32 in the same order).
* Warm start through ``init_model``: a different mapper is refused and a
  0-tree append predicts bitwise as the model; a 3-tree append equals the
  reference's append of the same model (integer arrays equal, values
  within 1e-4, as in the training tests).
* Multiclass (K=3 trees per iteration): resume, an ``init_booster``
  continuation and an ``init_model`` append equal the straight run bit for
  bit; model files cross both ways and predict (N, K) bitwise.
* Lambdarank and quantile models (with their objectives' params) cross
  both ways, through model files and ``booster_from_reference``, and
  predict bitwise.
"""

import json
import os

import numpy as np
import pytest

import dryad_tpu
from dryad_tpu.datasets import covertype_like, higgs_like, mslr_like

import dryad_tpu_torch as dt
from dryad_tpu_torch.checkpoint import Checkpointer
from dryad_tpu_torch.convert import booster_from_reference
from torch_layout import one_torch_thread  # noqa: F401 (autouse)

PARAMS = dict(objective="binary", num_trees=12, num_leaves=7, max_depth=3,
              max_bins=32, subsample=0.8, seed=3, min_data_in_leaf=5)


@pytest.fixture(scope="module")
def data():
    X, y = higgs_like(3000, seed=21)
    return dt.Dataset(X, y, max_bins=32)


@pytest.fixture(scope="module")
def es_data():
    """Train and valid rows of one task; at learning rate 0.5 early
    stopping ends the run at iteration 21 of 40 (best 17)."""
    X, y = higgs_like(4200, seed=21)
    ds = dt.Dataset(X[:3000], y[:3000], max_bins=32)
    return ds, ds.bind(X[3000:], y[3000:])


class Crash(RuntimeError):
    pass


def _crash_at(n):
    def cb(it, info):
        if it == n:
            raise Crash
    return cb


def _bitwise(a, b):
    assert a.num_iterations == b.num_iterations
    for k, v in a.tree_arrays().items():
        np.testing.assert_array_equal(v, b.tree_arrays()[k], err_msg=k)
    assert a.max_depth_seen == b.max_depth_seen
    assert a.best_iteration == b.best_iteration


@pytest.mark.parametrize("growth", ["leafwise", "depthwise"])
def test_kill_and_resume_bit_identical(tmp_path, data, growth):
    params = dict(PARAMS, growth=growth)
    full = dt.train(params, data, device="cpu")
    ckdir = str(tmp_path / growth)
    with pytest.raises(Crash):
        dt.train(params, data, device="cpu", checkpoint_dir=ckdir,
                 checkpoint_every=3, callback=_crash_at(6))
    latest = Checkpointer(ckdir).latest()
    assert latest is not None and latest[1] == 6
    resumed = dt.train(params, data, device="cpu", checkpoint_dir=ckdir,
                       checkpoint_every=3, resume=True)
    _bitwise(full, resumed)
    X = higgs_like(500, seed=22)[0]
    np.testing.assert_array_equal(
        dt.predict(full, X, raw_score=True, device="cpu"),
        dt.predict(resumed, X, raw_score=True, device="cpu"))


def test_resume_with_valid_and_early_stopping(tmp_path, es_data):
    data, valid = es_data
    params = dict(PARAMS, num_trees=40, learning_rate=0.5,
                  early_stopping_rounds=4)
    infos_full = []
    full = dt.train(params, data, [valid], device="cpu",
                    callback=lambda it, info: infos_full.append(info))
    assert full.num_iterations < 40          # the fixture stops early
    ckdir = str(tmp_path / "es")
    with pytest.raises(Crash):
        dt.train(params, data, [valid], device="cpu", checkpoint_dir=ckdir,
                 checkpoint_every=3, callback=_crash_at(6))
    infos_res = []
    resumed = dt.train(params, data, [valid], device="cpu",
                       checkpoint_dir=ckdir, checkpoint_every=3, resume=True,
                       callback=lambda it, info: infos_res.append(info))
    _bitwise(full, resumed)
    assert resumed.train_state["best_value"] == full.train_state["best_value"]
    assert resumed.train_state["stale"] == full.train_state["stale"]
    # the resumed segment saw exactly the straight run's later evals
    assert infos_res == infos_full[6:]


def test_resume_at_the_early_stop_boundary_grows_nothing(tmp_path,
                                                         es_data):
    data, valid = es_data
    params = dict(PARAMS, num_trees=40, learning_rate=0.5,
                  early_stopping_rounds=4)
    ckdir = str(tmp_path / "boundary")
    full = dt.train(params, data, [valid], device="cpu",
                    checkpoint_dir=ckdir, checkpoint_every=1)
    latest, it = Checkpointer(ckdir).latest()
    assert it == full.num_iterations
    assert latest.train_state["stale"] == 4
    grown = []
    resumed = dt.train(params, data, [valid], device="cpu",
                       checkpoint_dir=ckdir, checkpoint_every=1, resume=True,
                       callback=lambda it, info: grown.append(it))
    assert grown == []
    _bitwise(full, resumed)


def test_checkpoints_are_pruned_and_atomic(tmp_path, data):
    ckdir = tmp_path / "prune"
    ck = Checkpointer(str(ckdir), every=2, keep=2)
    dt.train(dict(PARAMS, num_trees=9), data, device="cpu",
             checkpoint_dir=str(ckdir), checkpoint_every=2)
    assert ck.iterations() == [6, 8]
    assert sorted(os.listdir(ckdir)) == ["ckpt_00000006.dryad",
                                         "ckpt_00000008.dryad"]
    # a torn write (a leftover temporary file) is never taken as a
    # checkpoint
    (ckdir / "ckpt_00000010.dryad.tmp").write_bytes(b"torn")
    b, it = ck.latest()
    assert it == 8 and b.num_iterations == 8
    with pytest.raises(ValueError, match="every"):
        Checkpointer(str(ckdir), every=0)


def test_checkpointer_keeps_deferred_evals_and_resume_merges_history(
        tmp_path):
    """A checkpointer does not force per-eval fetches: deferred evals are
    flushed at due checkpoints, and a resumed run merges the prior
    segment's history so it matches the straight run."""
    X, y = higgs_like(5000, seed=47)
    ds = dt.Dataset(X[:4000], y[:4000], max_bins=32)
    dv = ds.bind(X[4000:], y[4000:])
    p = dict(objective="binary", num_trees=12, num_leaves=7, max_depth=3,
             max_bins=32)
    full = dt.train(p, ds, valid_sets=[dv], device="cpu")
    d = str(tmp_path / "ck")
    dt.train(dict(p, num_trees=7), ds, valid_sets=[dv], device="cpu",
             checkpoint_dir=d, checkpoint_every=5)
    b = dt.train(p, ds, valid_sets=[dv], device="cpu", checkpoint_dir=d,
                 checkpoint_every=5, resume=True)
    want = full.train_state["eval_history"]["valid_auc"]
    got = b.train_state["eval_history"]["valid_auc"]
    assert [it for it, _ in got] == [it for it, _ in want] == list(range(12))
    assert got == want
    assert b.best_iteration == full.best_iteration
    _bitwise(full, b)


def _ref_pair(max_bins=32):
    X, y = higgs_like(4000, seed=5)
    X[::13, 1] = np.nan                       # missing values route too
    return X, y, dryad_tpu.Dataset(X[:3000], y[:3000], max_bins=max_bins)


def test_port_model_file_loads_in_reference(tmp_path):
    X, y, _ = _ref_pair()
    ds = dt.Dataset(X[:3000], y[:3000], max_bins=32)
    dv = ds.bind(X[3000:], y[3000:])
    b = dt.train(dict(PARAMS, num_trees=10, learning_rate=0.5,
                      early_stopping_rounds=2), ds, [dv], device="cpu")
    path = str(tmp_path / "port.dryad")
    b.save(path)
    jb = dryad_tpu.Booster.load(path)
    assert jb.best_iteration == b.best_iteration > 0
    assert jb.train_state == json.loads(json.dumps(b.train_state))
    assert jb.params.to_dict() == {**jb.params.to_dict(),
                                   **b.params.to_dict()}
    for k, v in b.tree_arrays().items():
        np.testing.assert_array_equal(np.asarray(jb.tree_arrays()[k]), v)
    for n_iter in (None, 3):
        np.testing.assert_array_equal(
            jb.predict(X, raw_score=True, num_iteration=n_iter),
            dt.predict(b, X, raw_score=True, num_iteration=n_iter,
                       device="cpu"))
    # and back: the port loads its own file
    b2 = dt.Booster.load(path)
    _bitwise(b, b2)
    assert b2.train_state == b.train_state
    assert b2.params == b.params


def test_reference_model_file_loads_in_port(tmp_path):
    X, y, jds = _ref_pair()
    jdv = jds.bind(X[3000:], y[3000:])
    jb = dryad_tpu.train(dict(PARAMS, num_trees=10, learning_rate=0.5,
                              early_stopping_rounds=2), jds, [jdv],
                         backend="cpu")
    path = str(tmp_path / "ref.dryad")
    jb.save(path)
    b = dt.Booster.load(path)
    assert b.best_iteration == jb.best_iteration > 0
    assert b.train_state == json.loads(json.dumps(jb.train_state))
    for n_iter in (None, 4):
        np.testing.assert_array_equal(
            dt.predict(b, X, raw_score=True, num_iteration=n_iter,
                       device="cpu"),
            jb.predict(X, raw_score=True, num_iteration=n_iter))
    # the converter carries the same state
    c = booster_from_reference(
        jb.tree_arrays(), jb.mapper.to_json_dict(), jb.init_score,
        jb.params.to_dict(), jb.max_depth_seen, jb.best_iteration,
        jb.train_state)
    assert c.best_iteration == b.best_iteration
    np.testing.assert_array_equal(
        dt.predict(c, X, raw_score=True, device="cpu"),
        dt.predict(b, X, raw_score=True, device="cpu"))


def test_mapper_bytes_cross_both_ways():
    X = higgs_like(2000, seed=9)[0]
    jm = dryad_tpu.Dataset(X, max_bins=48).mapper
    tm = dt.Dataset(X, max_bins=48).mapper
    from dryad_tpu.data.sketch import BinMapper as JBinMapper
    from dryad_tpu_torch.data.sketch import BinMapper

    assert (BinMapper.from_bytes(jm.to_bytes()).to_json_dict()
            == jm.to_json_dict())
    assert (JBinMapper.from_bytes(tm.to_bytes()).to_json_dict()
            == tm.to_json_dict())


def test_warm_start_append(tmp_path):
    X, y, jds = _ref_pair()
    tds = dt.Dataset(X[:3000], y[:3000], max_bins=32)
    params = dict(objective="binary", num_trees=4, num_leaves=7,
                  growth="depthwise", max_depth=3, max_bins=32)
    m = dt.train(params, tds, device="cpu")
    fresh = dt.Dataset(X[3000:], y[3000:], mapper=m.mapper)
    # a different bin space is refused
    with pytest.raises(ValueError, match="mapper"):
        dt.train(dict(params, num_trees=2), dt.Dataset(X[3000:], y[3000:]),
                 init_model=m, device="cpu")
    # a 0-tree append is a predict-identical copy
    same = dt.train(dict(params, num_trees=0), fresh, init_model=m,
                    device="cpu")
    np.testing.assert_array_equal(
        dt.predict(same, X, raw_score=True, device="cpu"),
        dt.predict(m, X, raw_score=True, device="cpu"))
    # a 3-tree append on fresh rows equals the reference's
    path = str(tmp_path / "m.dryad")
    m.save(path)
    jm = dryad_tpu.Booster.load(path)
    jfresh = dryad_tpu.Dataset(X[3000:], y[3000:], mapper=jm.mapper)
    ja = dryad_tpu.train(dict(params, num_trees=3), jfresh, init_model=jm,
                         backend="tpu", hist_backend="xla")
    ta = dt.train(dict(params, num_trees=3), fresh, init_model=m,
                  device="cpu")
    assert ta.num_iterations == ja.num_iterations == 7
    got, ref = ta.tree_arrays(), ja.tree_arrays()
    for k in ("feature", "threshold", "left", "right", "default_left"):
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
    np.testing.assert_allclose(got["value"], ref["value"], atol=1e-4)
    np.testing.assert_array_equal(ta.init_score, m.init_score)


MC = dict(objective="multiclass", num_class=3, num_trees=8, num_leaves=7,
          max_depth=3, max_bins=32, subsample=0.8, colsample=0.8, seed=3,
          min_data_in_leaf=5, learning_rate=0.5)


@pytest.fixture(scope="module")
def mc_data():
    X, y = covertype_like(2600, 20, 3, seed=21)
    ds = dt.Dataset(X[:2000], y[:2000], max_bins=32)
    return X, y, ds, ds.bind(X[2000:], y[2000:])


@pytest.mark.parametrize("growth", ["leafwise", "depthwise"])
def test_multiclass_kill_and_resume_bit_identical(tmp_path, mc_data,
                                                  growth):
    X, y, ds, dv = mc_data
    params = dict(MC, growth=growth, early_stopping_rounds=20)
    infos_full = []
    full = dt.train(params, ds, [dv], device="cpu",
                    callback=lambda it, info: infos_full.append(info))
    assert full.num_total_trees == 24 and full.num_outputs == 3
    ckdir = str(tmp_path / growth)
    with pytest.raises(Crash):
        dt.train(params, ds, [dv], device="cpu", checkpoint_dir=ckdir,
                 checkpoint_every=2, callback=_crash_at(5))
    latest, it = Checkpointer(ckdir).latest()
    assert it == 4 and latest.num_total_trees == 12
    infos_res = []
    resumed = dt.train(params, ds, [dv], device="cpu", checkpoint_dir=ckdir,
                       checkpoint_every=2, resume=True,
                       callback=lambda it, info: infos_res.append(info))
    _bitwise(full, resumed)
    assert infos_res == infos_full[4:]
    assert resumed.train_state == full.train_state
    raw = dt.predict(full, X, raw_score=True, device="cpu")
    assert raw.shape == (2600, 3)
    np.testing.assert_array_equal(
        raw, dt.predict(resumed, X, raw_score=True, device="cpu"))


def test_multiclass_continuations_bit_identical(mc_data):
    """``init_booster`` (total count) and ``init_model`` (append) from a
    3-iteration model on the same rows equal the straight 8-iteration
    run."""
    X, y, ds, _ = mc_data
    full = dt.train(MC, ds, device="cpu")
    head = dt.train(dict(MC, num_trees=3), ds, device="cpu")
    assert head.num_total_trees == 9
    cont = dt.train(MC, ds, init_booster=head, device="cpu")
    _bitwise(full, cont)
    app = dt.train(dict(MC, num_trees=5), ds, init_model=head,
                   device="cpu")
    _bitwise(full, app)
    np.testing.assert_array_equal(
        dt.predict(app, X, raw_score=True, device="cpu"),
        dt.predict(full, X, raw_score=True, device="cpu"))


def test_multiclass_model_files_cross_both_ways(tmp_path, mc_data):
    X, y, ds, dv = mc_data
    b = dt.train(dict(MC, early_stopping_rounds=2), ds, [dv], device="cpu")
    path = str(tmp_path / "port_mc.dryad")
    b.save(path)
    jb = dryad_tpu.Booster.load(path)
    assert jb.num_outputs == 3 and jb.params.num_class == 3
    assert jb.num_iterations == b.num_iterations
    assert jb.best_iteration == b.best_iteration > 0
    for n_iter in (None, 2):
        want = jb.predict(X, raw_score=True, num_iteration=n_iter)
        assert want.shape == (2600, 3)
        np.testing.assert_array_equal(
            want, dt.predict(b, X, raw_score=True, num_iteration=n_iter,
                             device="cpu"))
    np.testing.assert_array_equal(jb.predict(X),
                                  dt.predict(b, X, device="cpu"))
    b2 = dt.Booster.load(path)
    _bitwise(b, b2)
    assert b2.params == b.params

    # and the reference's multiclass file in the port
    jds = dryad_tpu.Dataset(X[:2000], y[:2000], max_bins=32)
    jm = dryad_tpu.train(dict(MC, num_trees=4), jds, backend="cpu")
    path = str(tmp_path / "ref_mc.dryad")
    jm.save(path)
    m = dt.Booster.load(path)
    assert m.num_outputs == 3 and m.num_total_trees == 12
    for n_iter in (None, 3):
        np.testing.assert_array_equal(
            dt.predict(m, X, raw_score=True, num_iteration=n_iter,
                       device="cpu"),
            jm.predict(X, raw_score=True, num_iteration=n_iter))


@pytest.mark.parametrize("objective", ["lambdarank", "quantile"])
def test_ranking_and_quantile_model_files_cross_both_ways(tmp_path,
                                                          objective):
    X, y, group = mslr_like(30, (5, 20), 6, seed=4)
    extra = ({"sigmoid": 2.0, "lambdarank_truncation": 10, "ndcg_at": 5}
             if objective == "lambdarank" else {"alpha": 0.3})
    params = dict(objective=objective, num_trees=4, num_leaves=6,
                  max_bins=16, **extra)
    kw = {"group": group} if objective == "lambdarank" else {}
    b = dt.train(params, dt.Dataset(X, y, max_bins=16, **kw), device="cpu")
    jb = dryad_tpu.train(params, dryad_tpu.Dataset(X, y, max_bins=16, **kw),
                         backend="cpu")
    for model, saver in ((b, "port"), (jb, "ref")):
        path = str(tmp_path / f"{saver}.dryad")
        model.save(path)
        in_port, in_ref = dt.Booster.load(path), dryad_tpu.Booster.load(path)
        for k, v in extra.items():
            assert getattr(in_port.params, k) == getattr(in_ref.params, k) \
                == v
        assert in_port.params.objective == in_ref.params.objective \
            == objective
        want = in_ref.predict(X, raw_score=True)
        np.testing.assert_array_equal(
            dt.predict(in_port, X, raw_score=True, device="cpu"), want)
        np.testing.assert_array_equal(dt.predict(in_port, X, device="cpu"),
                                      in_ref.predict(X))
    c = booster_from_reference(
        jb.tree_arrays(), jb.mapper.to_json_dict(), jb.init_score,
        jb.params.to_dict(), jb.max_depth_seen)
    assert c.params.alpha == jb.params.alpha
    assert c.params.sigmoid == jb.params.sigmoid
    np.testing.assert_array_equal(
        dt.predict(c, X, raw_score=True, device="cpu"),
        jb.predict(X, raw_score=True))
