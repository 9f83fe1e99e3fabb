"""GOSS (``boosting="goss"``): the port against the reference on the CPU.

* The uniforms: the numpy copy (``loop_state.goss_uniform``) and the
  device draw (``goss.goss_uniform_dev``, int64 on values below 2^32)
  bitwise equal to the reference's host ``goss_uniform`` and its traced
  ``_goss_uniform_dev``, over the reference test's grid.
* The selection at K = 1 and K = 3, with ties at the threshold: the row
  mask bitwise equal to ``goss_select_np``'s; mask, amplified g and h
  bitwise equal to the reference's device ``_goss_body``.
* The reference's tie-free tree fixture (``tests/test_goss_monotone.py``:
  ``higgs_like(4000, seed=79)``, 32 bins, 8 trees, 15 leaves, rates 0.25
  and 0.15, seed 5) on the legacy arm, and its first two trees on the
  default wired arm: integer tree arrays equal to its CPU trainer's and
  its device arm's (XLA histograms); leaf values within rtol 1e-5, atol
  1e-6 (the CPU trainer amplifies g/h and sums in f64, the reference's
  device in f32 in its own order, the port in f32 and fixed point); the
  port's model file predicts bitwise in the reference.
* The validation errors.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dryad_tpu
from dryad_tpu.config import make_params as j_make_params
from dryad_tpu.cpu.trainer import goss_select_np, goss_uniform
from dryad_tpu.datasets import higgs_like
from dryad_tpu.engine.train import _goss_body, _goss_uniform_dev

import dryad_tpu_torch as dt
from dryad_tpu_torch.engine import goss, loop_state

_INT = ("feature", "threshold", "left", "right", "default_left")
PARAMS = dict(objective="binary", num_trees=8, num_leaves=15, max_bins=32,
              boosting="goss", goss_top_rate=0.25, goss_other_rate=0.15,
              seed=5)


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


def test_uniforms_bitwise_equal_reference():
    for seed in (0, 7, 123456789):
        jp = j_make_params(dict(objective="binary", seed=seed))
        tp = dt.Params(seed=seed)
        traced = jax.jit(lambda i, s=seed: _goss_uniform_dev(s, i, 3001))
        for it in (0, 1, 57, 4999):
            host = goss_uniform(jp, it, 3001)
            np.testing.assert_array_equal(
                host, np.asarray(traced(jnp.int32(it))))
            np.testing.assert_array_equal(
                loop_state.goss_uniform(tp, it, 3001), host)
            dev = goss.goss_uniform_dev(seed, it, 3001, "cpu")
            assert dev.dtype == torch.float32
            np.testing.assert_array_equal(dev.numpy(), host)
            assert host.min() >= 0.0 and host.max() < 1.0


@pytest.mark.parametrize("K", [1, 3])
def test_selection_bitwise_equal_reference(K):
    rng = np.random.default_rng(11 + K)
    N = 6000
    g = rng.normal(size=(N, K)).astype(np.float32)
    g[::7] = g[3]                         # a block of ties near the top
    h = rng.uniform(0.1, 1.0, size=(N, K)).astype(np.float32)
    kw = dict(boosting="goss", goss_top_rate=0.25, goss_other_rate=0.15)
    jp = j_make_params(dict(objective="binary", **kw))
    u = goss_uniform(jp, 3, N)
    mask_np, _ = goss_select_np(jp, g, u)
    valid = np.ones(N, bool)
    valid[-5:] = False                    # padded rows never compete
    jg, jh, jm = _goss_body(jp, N, jnp.asarray(g), jnp.asarray(h),
                            jnp.asarray(u), jnp.asarray(valid))
    tg, th, tm = goss.goss_select(
        dt.Params(**kw), N, torch.from_numpy(g), torch.from_numpy(h),
        torch.from_numpy(u), torch.from_numpy(valid))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    assert not tm.numpy()[-5:].any()
    # with every row valid, the host selection picks the same rows
    _, _, tm_all = goss.goss_select(
        dt.Params(**kw), N, torch.from_numpy(g), torch.from_numpy(h),
        torch.from_numpy(u), torch.ones(N, dtype=torch.bool))
    np.testing.assert_array_equal(tm_all.numpy(), mask_np)
    assert 0.3 * N < mask_np.sum() < 0.5 * N


def test_goss_trees_match_reference_trainers(tmp_path):
    X, y = higgs_like(4000, seed=79)
    jds = dryad_tpu.Dataset(X, y, max_bins=32)
    tds = dt.Dataset(X, y, max_bins=32)
    # the default depth 8 takes the wired arm, which grows the first two
    # trees here; the legacy arm (equal trees, a fraction of the plain
    # versions' cost) grows all eight
    wired = dt.train(dict(PARAMS, num_trees=2), tds, device="cpu")
    tb = dt.train(dict(PARAMS, deep_layout="legacy"), tds, device="cpu")
    assert tb.params.boosting == "goss" and tb.num_iterations == 8
    assert wired.params.max_depth == 8
    ta = tb.tree_arrays()
    for jb in (dryad_tpu.train(PARAMS, jds, backend="cpu"),
               dryad_tpu.train(dict(PARAMS, hist_backend="xla"), jds,
                               backend="tpu")):
        ja = jb.tree_arrays()
        for got, n in ((ta, None), (wired.tree_arrays(), 2)):
            for k in _INT:
                np.testing.assert_array_equal(got[k], ja[k][:n], err_msg=k)
            np.testing.assert_allclose(got["value"], ja["value"][:n],
                                       rtol=1e-5, atol=1e-6)
    # the port's model file predicts bitwise in the reference
    path = str(tmp_path / "goss.dryad")
    tb.save(path)
    jb = dryad_tpu.Booster.load(path)
    assert jb.params.boosting == "goss"
    np.testing.assert_array_equal(jb.predict(X, raw_score=True),
                                  tb.predict(X, raw_score=True, device="cpu"))


def test_goss_validation():
    for bad, match in (({"boosting": "goss", "subsample": 0.5},
                        "subsample"),
                       ({"boosting": "goss", "top_rate": 0.0}, "rates"),
                       ({"boosting": "goss", "other_rate": 1.0}, "rates"),
                       ({"boosting": "goss", "top_rate": 0.7,
                         "other_rate": 0.4}, "<= 1"),
                       ({"boosting": "bogus"}, "boosting")):
        with pytest.raises(ValueError, match=match):
            dt.Params.from_dict(bad)
    # the rates are only checked under goss, as in the reference
    assert dt.Params.from_dict({"top_rate": 0.0}).goss_top_rate == 0.0
