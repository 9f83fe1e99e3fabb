"""Training of the new objectives in the port against the reference.

* LambdaMART on ``test_engine_parity.py::test_lambdarank_parity``'s
  fixture (``mslr_like(60, (5, 30), 16)``, 32 bins, 5 trees, 8 leaves;
  leaf-wise at the reference's defaults otherwise, effective depth 7).
* The robust and count family on
  ``test_objectives.py::test_robust_family_cpu_device_parity``'s fixture
  (3000 x 6, 32 bins, 8 trees, 15 leaves, max_depth 5): l1, huber, fair,
  quantile (with renewal for l1, huber and quantile) and poisson.

The reference runs ``dryad_tpu.train(..., backend="tpu",
hist_backend="xla")`` under jax on the CPU.  Both fixtures are tie-free:
no split sits near an fp32 gain tie, so the XLA arm and the Pallas arm in
interpret mode grow the same trees, and the port (which follows the
Pallas arm) matches both.  Tolerances: integer tree arrays equal, leaf
values within 1e-4 (atol, as ``test_torch_multiclass.py``); raw predict of
a reference model carried into the port bitwise; NDCG@10 of the two
models within 1e-6, and the port's valid NDCG within 1e-5 of the host
oracle on its predict.
"""

import numpy as np
import pytest

import dryad_tpu
from dryad_tpu.datasets import mslr_like

import dryad_tpu_torch as dt
from dryad_tpu_torch.convert import booster_from_reference
from dryad_tpu_torch.metrics import ndcg_at_k
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


def test_lambdarank_matches_reference():
    X, y, group = mslr_like(num_queries=60, docs_per_query=(5, 30),
                            num_features=16)
    params = dict(objective="lambdarank", num_trees=5, num_leaves=8,
                  max_bins=32)
    jb = dryad_tpu.train(params, dryad_tpu.Dataset(X, y, group=group,
                                                   max_bins=32),
                         backend="tpu", hist_backend="xla")
    ds = dt.Dataset(X, y, group=group, max_bins=32)
    # the first 45 queries train the valid-scored run, the rest validate
    n45 = int(group[:45].sum())
    tb = dt.train(params, ds, device="cpu")
    assert tb.params.max_depth == 7
    _same_trees(tb, jb)
    qoff = ds.query_offsets
    raw = dt.predict(tb, X, raw_score=True, device="cpu")
    jraw = jb.predict(X, raw_score=True)
    assert abs(ndcg_at_k(y, raw, qoff) - ndcg_at_k(y, jraw, qoff)) <= 1e-6
    assert ndcg_at_k(y, raw, qoff) > 0.6
    carried = booster_from_reference(
        jb.tree_arrays(), jb.mapper.to_json_dict(), jb.init_score,
        jb.params.to_dict(), jb.max_depth_seen)
    np.testing.assert_array_equal(
        dt.predict(carried, X, raw_score=True, device="cpu"), jraw)

    tr = dt.Dataset(X[:n45], y[:n45], group=group[:45], max_bins=32)
    dv = tr.bind(X[n45:], y[n45:], group=group[45:])
    vb = dt.train(params, tr, [dv], device="cpu")
    curve = [v for _, v in vb.train_state["eval_history"]["valid_ndcg"]]
    assert len(curve) == 5
    # predict stops at best_iteration by default; the last eval scored all
    host = ndcg_at_k(y[n45:], dt.predict(vb, X[n45:], raw_score=True,
                                         num_iteration=5, device="cpu"),
                     dv.query_offsets)
    assert abs(curve[-1] - host) <= 1e-5


@pytest.mark.parametrize("objective,extra", [
    ("l1", {}),
    ("huber", {"alpha": 0.5}),
    ("fair", {"fair_c": 1.5}),
    ("quantile", {"alpha": 0.75}),
    ("poisson", {}),
])
def test_robust_family_matches_reference(objective, extra):
    rng = np.random.default_rng(11)
    X = rng.normal(size=(3000, 6)).astype(np.float32)
    y = (X[:, 0] - 0.5 * X[:, 1]
         + rng.normal(scale=0.5, size=3000)).astype(np.float32)
    if objective == "poisson":
        y = rng.poisson(np.exp(np.clip(0.4 * X[:, 0], -3, 3))).astype(
            np.float32)
    p = dict(objective=objective, num_trees=8, num_leaves=15, max_bins=32,
             max_depth=5, **extra)
    jb = dryad_tpu.train(p, dryad_tpu.Dataset(X, y, max_bins=32),
                         backend="tpu", hist_backend="xla")
    tb = dt.train(p, dt.Dataset(X, y, max_bins=32), device="cpu")
    _same_trees(tb, jb)
    want = jb.predict(X)
    got = dt.predict(tb, X, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
