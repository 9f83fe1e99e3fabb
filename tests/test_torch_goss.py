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
* The gradient norm (F2): ``|g|`` is bitwise numpy's correctly rounded
  ``np.sqrt`` of the same sums of squares, on the iteration-0 rows of a
  7-class run (every row's sum is one of two adjacent floats) and on
  random g, and the K = 7 selection there equals the reference's.  The
  reproducer (``covertype_like(3000, seed=3)``, 7 classes, GOSS, 15
  leaves): at 64 bins the integer tree arrays equal the reference XLA
  arm's on all 21 trees; at 2048 bins, leaf-wise, its CPU trainer's on
  all 14; leaf values within rtol 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dryad_tpu
from dryad_tpu.config import make_params as j_make_params
from dryad_tpu.cpu.trainer import goss_select_np, goss_uniform
from dryad_tpu.datasets import covertype_like, higgs_like
from dryad_tpu.engine.train import _goss_body, _goss_uniform_dev

import dryad_tpu_torch as dt
from dryad_tpu_torch.engine import goss, loop_state
from dryad_tpu_torch.objectives import get_objective, row_sum

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


F2 = dict(objective="multiclass", num_class=7, boosting="goss",
          num_leaves=15)


def _iteration0_grads(n_rows: int = 3000):
    """The (N, 7) g and h of iteration 0 of the reproducer, as the port's
    loop computes them (equal initial scores in every row)."""
    X, y = covertype_like(n_rows, seed=3)
    p = dt.Params.from_dict(dict(F2, num_trees=3))
    obj = get_objective(p)
    init = np.asarray(obj.init_score(y, None), np.float32).reshape(-1)
    score = torch.from_numpy(np.tile(init, (y.shape[0], 1)))
    g, h = obj.grad_hess(score, torch.from_numpy(y.astype(np.float32)))
    return p, g, h


def test_gradient_norm_bitwise_numpy():
    _, g, _ = _iteration0_grads()
    sums = row_sum(g * g)[:, 0]
    assert np.unique(sums.numpy()).size == 2       # two adjacent floats
    rng = np.random.default_rng(17)
    rand = torch.from_numpy(
        rng.normal(size=(200_000, 3)).astype(np.float32) ** 2).sum(1)
    for x in (sums, rand, torch.from_numpy(
            rng.uniform(0, 4, 100_000).astype(np.float32))):
        got = goss.correct_sqrt(x)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.sqrt(x.numpy()))


def test_iteration0_selection_k7_matches_reference():
    p, g, h = _iteration0_grads()
    N = g.shape[0]
    jp = j_make_params(dict(F2, num_trees=3))
    u = goss_uniform(jp, 0, N)
    valid = np.ones(N, bool)
    _, _, jm = _goss_body(jp, N, jnp.asarray(g.numpy()),
                          jnp.asarray(h.numpy()), jnp.asarray(u),
                          jnp.asarray(valid))
    _, _, tm = goss.goss_select(p, N, g, h, torch.from_numpy(u),
                                torch.from_numpy(valid))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    mask_np, _ = goss_select_np(jp, g.numpy(), u)
    np.testing.assert_array_equal(tm.numpy(), mask_np)
    assert tm.numpy().sum() < N                    # not every row is "top"


@pytest.mark.parametrize("case", ["xla_64_bins", "cpu_2048_bins"])
def test_f2_reproducer_trees_match_reference(case):
    X, y = covertype_like(3000, seed=3)
    if case == "xla_64_bins":
        bins, params, ref_kw = 64, dict(F2, num_trees=3), dict(
            backend="tpu", hist_backend="xla")
    else:
        bins, params, ref_kw = 2048, dict(F2, num_trees=2), dict(
            backend="cpu")
    params = dict(params, max_bins=bins)
    tb = dt.train(params, dt.Dataset(X, y, max_bins=bins), device="cpu")
    hist = ref_kw.pop("hist_backend", None)
    jb = dryad_tpu.train(dict(params, **({"hist_backend": hist} if hist
                                         else {})),
                         dryad_tpu.Dataset(X, y, max_bins=bins), **ref_kw)
    ta, ja = tb.tree_arrays(), jb.tree_arrays()
    assert ta["feature"].shape[0] == params["num_trees"] * 7
    for k in _INT:
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    # amplified g/h summed in f32 in another order on leaves of a few
    # dozen rows: 1 of 609 values sits 3.7e-5 (relative) off the XLA arm
    np.testing.assert_allclose(ta["value"], ja["value"], rtol=1e-4,
                               atol=1e-6)
