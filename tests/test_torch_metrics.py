"""The port's loop state and metrics against the reference package.

* ``sample_masks``: bitwise equal to ``dryad_tpu.cpu.trainer.sample_masks``
  over a grid of subsample, colsample, seed and iteration (both draw from
  numpy's Philox on the host).
* Device metrics (run here on CPU tensors) against
  ``dryad_tpu.metrics.device`` on the same inputs, and against the numpy
  oracles: within 1e-5 absolute (fp32 reductions in a different order;
  the reference's own device-vs-oracle tests use the same bound), 1e-4 for
  MSE, whose values are ~1.5 and sum squares.  Ties, a degenerate NaN AUC
  and saturated logloss are covered; saturated logloss equals the
  reference's bitwise and its f64 oracle within 1e-3 (the oracle's clip
  at 1 - 1e-15 rounds on its own; the reference's bound).
* Host oracles equal the reference's to 1e-12; the metric tables are the
  reference's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dryad_tpu import metrics as JM
from dryad_tpu.config import Params as JParams
from dryad_tpu.cpu.trainer import sample_masks as j_sample_masks
from dryad_tpu.metrics import device as JD

import dryad_tpu_torch as dt
from dryad_tpu_torch import metrics as M
from dryad_tpu_torch.metrics import device as D
from dryad_tpu_torch.engine.loop_state import normalize_valids, sample_masks


@pytest.mark.parametrize("subsample,colsample", [
    (1.0, 1.0), (0.8, 1.0), (1.0, 0.5), (0.8, 0.8), (0.3, 0.05)])
@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_sample_masks_bitwise_equal_reference(subsample, colsample, seed):
    p = dt.Params(subsample=subsample, colsample=colsample, seed=seed)
    jp = JParams(subsample=subsample, colsample=colsample, seed=seed)
    for it in (0, 1, 5, 499):
        for n, f in ((1000, 28), (37, 3)):
            rm, fm = sample_masks(p, it, n, f)
            jrm, jfm = j_sample_masks(jp, it, n, f)
            for got, want in ((rm, jrm), (fm, jfm)):
                assert (got is None) == (want is None)
                if got is not None:
                    assert got.dtype == want.dtype
                    np.testing.assert_array_equal(got, want)
    if colsample < 1.0:
        assert sample_masks(p, 3, 10, 40)[1].sum() == max(
            1, round(colsample * 40))


@pytest.fixture(scope="module")
def scores():
    rng = np.random.default_rng(31)
    n = 20_000
    y = (rng.random(n) < 0.4).astype(np.float32)
    s = (y * 0.8 + rng.normal(size=n) * 1.2).astype(np.float32)
    s[: n // 3] = np.round(s[: n // 3] * 4) / 4        # heavy ties
    return y, s


def _both(fn_t, fn_j, y, s):
    got = float(fn_t(torch.from_numpy(y), torch.from_numpy(s)))
    want = float(fn_j(jnp.asarray(y), jnp.asarray(s)))
    return got, want


def test_auc_with_ties_matches_reference_and_oracle(scores):
    y, s = scores
    got, want = _both(D.auc_device, JD.auc_device, y, s)
    assert abs(got - want) < 1e-5
    assert abs(got - M.auc(y, s)) < 1e-5
    assert M.auc(y, s) == pytest.approx(JM.auc(y, s), abs=1e-12)
    # all scores tied: one midrank group, AUC one half
    flat = np.zeros_like(s)
    got, want = _both(D.auc_device, JD.auc_device, y, flat)
    assert abs(got - want) < 1e-5 and abs(got - 0.5) < 1e-5


@pytest.mark.parametrize("label", [0.0, 1.0])
def test_auc_degenerate_is_nan(label):
    y = np.full(64, label, np.float32)
    s = np.linspace(0, 1, 64, dtype=np.float32)
    got, want = _both(D.auc_device, JD.auc_device, y, s)
    assert np.isnan(got) and np.isnan(want) and np.isnan(M.auc(y, s))


@pytest.mark.parametrize("name,tol", [
    ("binary_logloss", 1e-5), ("rmse", 1e-5), ("mse", 1e-4), ("mae", 1e-5),
    ("error", 1e-6), ("accuracy", 1e-6)])
def test_scalar_metrics_match_reference_and_oracle(scores, name, tol):
    y, s = scores
    got = float(D.eval_value(name, torch.from_numpy(y), torch.from_numpy(s)))
    want = float(JD.eval_value(name, 10, jnp.asarray(y), jnp.asarray(s)))
    assert abs(got - want) < tol
    oracle = JM.evaluate_raw("binary", name, y, s)[1]
    assert abs(got - oracle) < tol


def test_binary_logloss_saturated_scores():
    y = np.array([1, 0, 1, 0], np.float32)
    s = np.array([40.0, -40.0, -40.0, 40.0], np.float32)
    got, want = _both(D.binary_logloss_device, JD.binary_logloss_device, y, s)
    oracle = M.binary_logloss(y, 1 / (1 + np.exp(-s.astype(np.float64))))
    assert np.isfinite(got)
    assert got == want
    # the oracle's f64 clip at 1 - 1e-15 carries its own rounding: the
    # capped stable form agrees to ~1e-5 relative (the reference's own
    # bound for this comparison, tests/test_device_metrics.py)
    assert abs(got - oracle) < 1e-3


def test_host_oracles_match_reference(scores):
    y, s = scores
    p = 1 / (1 + np.exp(-s))
    assert M.binary_logloss(y, p) == pytest.approx(
        JM.binary_logloss(y, p), abs=1e-12)
    assert M.mse(y, s) == JM.mse(y, s) and M.mae(y, s) == JM.mae(y, s)
    two = np.stack([-s, s], 1)
    assert M.accuracy(y, two) == JM.accuracy(y, two)
    assert M.error_rate(y, two) == JM.error_rate(y, two)
    assert M.DEFAULT_METRIC == JM.DEFAULT_METRIC
    assert M.HIGHER_BETTER == JM.HIGHER_BETTER
    assert M._METRIC_ALIASES == JM._METRIC_ALIASES


def test_make_evaluator_names_defaults_and_later_slices():
    X = np.random.default_rng(0).normal(size=(50, 2)).astype(np.float32)
    ds = dt.Dataset(X, (X[:, 0] > 0).astype(np.float32), max_bins=8)
    for obj, metric, want, higher in (("binary", "", "auc", True),
                                      ("regression", "", "rmse", False),
                                      ("binary", "logloss", "binary_logloss",
                                       False),
                                      ("regression", "l1", "mae", False)):
        name, hb, fn = D.make_evaluator(obj, metric, ds, "cpu")
        assert (name, hb) == (want, higher)
        v = fn(torch.zeros(50, 1))
        assert v.ndim == 0 and v.dtype == torch.float32
    for metric, slice_ in (("multi_logloss", "M8"), ("ndcg", "M9"),
                           ("poisson_deviance", "M9")):
        with pytest.raises(ValueError, match=slice_):
            D.make_evaluator("binary", metric, ds, "cpu")
    with pytest.raises(ValueError, match="unknown metric"):
        D.make_evaluator("binary", "bogus", ds, "cpu")


def test_normalize_valids_names():
    X = np.zeros((10, 2), np.float32)
    a, b = dt.Dataset(X, np.zeros(10)), dt.Dataset(X, np.zeros(10))
    assert normalize_valids(None) == []
    assert [n for n, _ in normalize_valids(a)] == ["valid"]
    assert [n for n, _ in normalize_valids([a])] == ["valid"]
    assert [n for n, _ in normalize_valids([a, b])] == ["valid_0", "valid_1"]
    assert [n for n, _ in normalize_valids([("x", a), b])] == ["x",
                                                               "valid_1"]
