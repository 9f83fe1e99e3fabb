"""The port's LambdaMART lambda pass (``engine/lambdarank.py``) against the
reference.

Fixture: ``mslr_like(40, (3, 25), 8)`` with random scores from
``Philox(6)``, the same arrays in both packages (``datasets.mslr_like`` is
a copy, checked bitwise here).

Tolerances:
* against the reference's device pass
  ``dryad_tpu.engine.lambdarank._lambda_grad_padded`` (fp32, XLA on the
  CPU): rtol 1e-5, atol 1e-6 (the per-query sums reduce in torch's order,
  not XLA's);
* against the reference's f64 host oracle ``LambdaRank.grad_hess_np``:
  rtol 1e-3, atol 2e-4, the reference's own bound
  (``tests/test_engine_units.py::test_lambdarank_device_matches_host``);
* chunking over queries: bitwise equal to one chunk (each query's lambdas
  depend only on its own rows, every chunk keeps the global S);
* weights: the weighted pass is the unweighted one times the weight,
  bitwise, as in the reference.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dryad_tpu import datasets as jdatasets
from dryad_tpu.engine import lambdarank as JL
from dryad_tpu.objectives import LambdaRank as JLambdaRank

from dryad_tpu_torch import datasets
from dryad_tpu_torch.engine import lambdarank as L
from dryad_tpu_torch.objectives import LambdaRank
from torch_layout import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def fixture():
    X, y, group = datasets.mslr_like(40, (3, 25), 8)
    jX, jy, jgroup = jdatasets.mslr_like(40, (3, 25), 8)
    for a, b in ((X, jX), (y, jy), (group, jgroup)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    qoff = np.concatenate([[0], np.cumsum(group)]).astype(np.int64)
    rng = np.random.Generator(np.random.Philox(6))
    s = rng.normal(size=y.size).astype(np.float32)
    return s, y, qoff


def _port(s, y, qoff, sigma=1.0, trunc=30):
    plan = L.PaddingPlan(qoff)
    g, h = L.lambda_grad_padded(torch.from_numpy(s), torch.from_numpy(y),
                                plan, sigma, trunc)
    assert g.dtype == torch.float32 and g.shape == (y.size,)
    return g.numpy(), h.numpy()


@pytest.mark.parametrize("sigma,trunc", [(1.0, 30), (2.0, 5), (0.5, 1)])
def test_lambda_pass_matches_reference_device_and_host(fixture, sigma,
                                                       trunc):
    s, y, qoff = fixture
    gt, ht = _port(s, y, qoff, sigma, trunc)
    jp = JL.PaddingPlan(qoff)
    assert (L.PaddingPlan(qoff).Q, L.PaddingPlan(qoff).S) == (jp.Q, jp.S)
    gj, hj = JL._lambda_grad_padded(jnp.asarray(s), jnp.asarray(y),
                                    jp.row_ids, jp.col_ids, jp.Q, jp.S,
                                    sigma, trunc)
    np.testing.assert_allclose(gt, np.asarray(gj), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ht, np.asarray(hj), rtol=1e-5, atol=1e-6)
    gn, hn = JLambdaRank(sigma, trunc).grad_hess_np(s, y, None,
                                                    query_offsets=qoff)
    np.testing.assert_allclose(gt, gn, rtol=1e-3, atol=2e-4)
    np.testing.assert_allclose(ht, hn, rtol=1e-3, atol=2e-4)
    assert np.abs(gt).max() > 0.01 and (ht >= 0).all()


def test_single_row_and_equal_relevance_queries_are_zero(fixture):
    s, y, qoff = fixture
    sizes = np.diff(qoff)
    # prepend a one-row query and a query whose rows share one relevance
    y2 = np.concatenate([[3.0], np.full(6, 2.0), y]).astype(np.float32)
    s2 = np.concatenate([[0.5], np.linspace(-1, 1, 6), s]).astype(np.float32)
    qoff2 = np.concatenate([[0], np.cumsum(np.r_[1, 6, sizes])])
    g, h = _port(s2, y2, qoff2)
    assert not g[:7].any() and not h[:7].any()
    g_rest, h_rest = _port(s, y, qoff)
    np.testing.assert_array_equal(g[7:], g_rest)
    np.testing.assert_array_equal(h[7:], h_rest)


@pytest.mark.parametrize("chunk_bytes", [1, 3 * 32 * 32 * 4, 1 << 16])
def test_chunking_over_queries_changes_no_bit(fixture, chunk_bytes,
                                              monkeypatch):
    s, y, qoff = fixture
    one = _port(s, y, qoff)                  # one chunk at 512 MB
    monkeypatch.setattr(L, "CHUNK_BYTES", chunk_bytes)
    got = _port(s, y, qoff)
    np.testing.assert_array_equal(got[0], one[0])
    np.testing.assert_array_equal(got[1], one[1])


def test_weights_multiply_after_the_pass(fixture):
    s, y, qoff = fixture
    w = np.random.Generator(np.random.Philox(8)).uniform(
        0.2, 2.0, size=y.size).astype(np.float32)
    plan = L.PaddingPlan(qoff)
    args = (torch.from_numpy(s), torch.from_numpy(y))
    g0, h0 = L.grad_hess_ranking(LambdaRank(), *args, None, plan)
    gw, hw = L.grad_hess_ranking(LambdaRank(), *args, torch.from_numpy(w),
                                 plan)
    np.testing.assert_array_equal(gw.numpy(), g0.numpy() * w)
    np.testing.assert_array_equal(hw.numpy(), h0.numpy() * w)
    gj, hj = JL.grad_hess_ranking(JLambdaRank(), jnp.asarray(s),
                                  jnp.asarray(y), jnp.asarray(w), qoff)
    np.testing.assert_allclose(gw.numpy(), np.asarray(gj), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(hw.numpy(), np.asarray(hj), rtol=1e-5,
                               atol=1e-6)
