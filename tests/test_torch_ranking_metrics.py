"""The port's ranking and count metrics against the reference.

* ``ndcg_device`` and ``poisson_deviance_device`` (torch on the CPU)
  against the reference's device functions (jax on the CPU) on the same
  inputs, and against the numpy oracles: within 1e-6 (fp32 reductions in
  different orders; NDCG is a mean of per-query ratios in [0, 1], the
  deviance is scaled to its mean here).
* The host oracles ``poisson_deviance``, ``dcg_at_k`` and ``ndcg_at_k``
  equal the reference's.
* The (Q, S) plan ``_pad_queries`` equals the reference's.
* The host arm of the NDCG evaluator: 70k one-row queries and one 250-row
  query give Q * S > 2^24, so the evaluator scores on the host, equal to
  ``ndcg_at_k``; a training run with such a valid set evaluates every
  iteration synchronously and records the oracle's value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dryad_tpu import metrics as JM
from dryad_tpu.metrics import device as JD

import dryad_tpu_torch as dt
from dryad_tpu_torch import metrics as M
from dryad_tpu_torch.metrics import device as D
from torch_layout import one_torch_thread  # noqa: F401 (autouse)


def _queries(seed, n_q=300, max_size=40):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, max_size, n_q)
    qoff = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    n = int(qoff[-1])
    y = rng.integers(0, 5, n).astype(np.float32)
    y[qoff[3]:qoff[4]] = 0.0                 # a query with zero ideal DCG
    s = (y + rng.normal(size=n) * 2).astype(np.float32)
    s[qoff[5]:qoff[6]] = 1.0                 # a query of tied scores
    return y, s, qoff


@pytest.mark.parametrize("k", [10, 1, 5, 1000])
@pytest.mark.parametrize("seed", [41, 7])
def test_ndcg_device_matches_reference_and_oracle(seed, k):
    y, s, qoff = _queries(seed)
    ids, n = D._pad_queries(qoff)
    jids, jn = JD._pad_queries(qoff)
    assert n == jn
    np.testing.assert_array_equal(ids, jids)
    got = float(D.ndcg_device(torch.from_numpy(y), torch.from_numpy(s),
                              torch.from_numpy(ids), k))
    want = float(JD.ndcg_device(jnp.asarray(y), jnp.asarray(s),
                                jnp.asarray(jids), k))
    oracle = M.ndcg_at_k(y, s, qoff, k)
    assert oracle == JM.ndcg_at_k(y, s, qoff, k)
    assert abs(got - want) <= 1e-6 and abs(got - oracle) <= 1e-6


@pytest.mark.parametrize("seed", [3, 9])
def test_poisson_deviance_device_matches_reference_and_oracle(seed):
    rng = np.random.default_rng(seed)
    s = rng.normal(size=20_000).astype(np.float32)
    y = rng.poisson(np.exp(s)).astype(np.float32)
    y[:5] = [0.0, 1e-31, 0.5, 3.0, 0.0]       # the clamp and y == 0 terms
    got = float(D.poisson_deviance_device(torch.from_numpy(y),
                                          torch.from_numpy(s)))
    want = float(JD.poisson_deviance_device(jnp.asarray(y), jnp.asarray(s)))
    oracle = M.poisson_deviance(y, s)
    assert oracle == JM.poisson_deviance(y, s)
    assert abs(got - want) <= 1e-6 * oracle
    assert abs(got - oracle) <= 1e-6 * oracle


def test_host_oracles_equal_reference():
    rels = np.array([3, 0, 2, 4, 1], np.float32)
    for k in (1, 3, 10):
        assert M.dcg_at_k(rels, k) == JM.dcg_at_k(rels, k)
    assert M.dcg_at_k(rels[:0], 5) == 0.0


def test_evaluator_takes_query_offsets_and_cutoff():
    y, s, qoff = _queries(5)
    X = np.zeros((y.size, 2), np.float32)
    ds = dt.Dataset(X, y, group=np.diff(qoff))
    for k in (10, 3):
        name, higher, fn = D.make_evaluator("lambdarank", "", ds, "cpu", 1,
                                            ndcg_at=k)
        assert (name, higher, fn.host_only) == ("ndcg", True, False)
        v = fn(torch.from_numpy(s)[:, None])
        assert v.ndim == 0 and abs(float(v) - M.ndcg_at_k(y, s, qoff, k)) \
            <= 1e-6
    name, higher, fn = D.make_evaluator("poisson", "", ds, "cpu")
    assert (name, higher) == ("poisson_deviance", False)
    with pytest.raises(ValueError, match="query groups"):
        D.make_evaluator("lambdarank", "ndcg", dt.Dataset(X, y), "cpu")
    with pytest.raises(ValueError, match="one score per row"):
        D.make_evaluator("multiclass", "ndcg", ds, "cpu", 3)


@pytest.fixture(scope="module")
def skewed():
    rng = np.random.default_rng(5)
    sizes = np.concatenate([np.ones(70_000, np.int64), [250]])
    n = int(sizes.sum())
    y = rng.integers(0, 3, size=n).astype(np.float32)
    X = rng.normal(size=(n, 3)).astype(np.float32)
    return X, y, sizes


def test_ndcg_host_arm_on_skewed_queries(skewed):
    X, y, sizes = skewed
    ds = dt.Dataset(X, y, group=sizes, max_bins=16)
    Q, S = sizes.size, int(sizes.max())
    assert Q * S > max(8 * y.size, 1 << 24)
    name, higher, fn = D.make_evaluator("lambdarank", "ndcg", ds, "cpu")
    assert fn.host_only and name == "ndcg" and higher
    score = np.random.default_rng(6).normal(size=y.size).astype(np.float32)
    got = fn(torch.from_numpy(score)[:, None])
    assert got.dtype == torch.float32 and got.ndim == 0
    want = M.ndcg_at_k(y, score, ds.query_offsets, 10)
    assert float(got) == np.float32(want)


def test_training_with_a_host_scored_valid_set(skewed):
    X, y, sizes = skewed
    rng = np.random.default_rng(8)
    gtrain = rng.integers(5, 20, 40)
    Xt = rng.normal(size=(int(gtrain.sum()), 3)).astype(np.float32)
    yt = rng.integers(0, 3, size=Xt.shape[0]).astype(np.float32)
    ds = dt.Dataset(Xt, yt, group=gtrain, max_bins=16)
    dv = ds.bind(X, y, group=sizes)
    calls = []
    b = dt.train(dict(objective="lambdarank", num_trees=2, num_leaves=4,
                      max_depth=2, min_data_in_leaf=5), ds, [dv],
                 device="cpu", callback=lambda it, info: calls.append(info))
    curve = [info["valid_ndcg"] for info in calls]
    assert len(curve) == 2
    want = M.ndcg_at_k(y, dt.predict(b, X, raw_score=True, device="cpu"),
                       dv.query_offsets, 10)
    assert curve[-1] == np.float32(want)
    # no callback: the host arm alone makes the loop evaluate synchronously
    # (a deferred eval would leave an eval_history), with the same trees
    b2 = dt.train(dict(objective="lambdarank", num_trees=2, num_leaves=4,
                       max_depth=2, min_data_in_leaf=5), ds, [dv],
                  device="cpu")
    assert "eval_history" not in b2.train_state
    for k, v in b.tree_arrays().items():
        np.testing.assert_array_equal(b2.tree_arrays()[k], v)
