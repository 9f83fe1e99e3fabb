"""The port's leaf-wise growth against the reference (dryad_tpu), on the CPU.

* The batched grower (``engine/leafwise_fast.py``) against the reference's
  ``grow_tree_leafwise_batched``: the wired arm with the reference on its
  Pallas arm in interpret mode; the legacy arm with K3 live (Pallas
  interpret) and with K3 gated off in both packages; ``learn_missing``.
  The remaining cases hold the port against the reference's XLA arm,
  which the reference holds equal to its Pallas arm.
* The port's batched grower against its own sequential ``grow_tree``
  (node ids and ``row_leaf`` included), the reference's contract.
* The port's ``grow_tree`` against the reference's, leaf-wise with
  unbounded depth and depthwise with ``max_depth=-1``.
* The growth-policy helpers over a grid, ``grow_any``'s routing and its
  fallback warning, and ``dryad_tpu_torch.train`` at the reference's
  defaults against the reference's ``train``.

Tolerances: integer tree arrays (feature, threshold, left, right,
default_left, row_leaf, max_depth) and covers are equal on fixtures whose
best gains are far apart; leaf values agree within 1e-4 and gains within
rtol/atol 1e-4 (the packages sum histograms in different orders).  The
port's two growers see bitwise-equal histograms (one fixed-point shift per
tree), so they agree exactly.
"""

import json
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import dryad_tpu
from dryad_tpu import datasets as jdatasets
from dryad_tpu import config as jconfig
from dryad_tpu.config import Params as JParams
from dryad_tpu.engine import grower as jgrower
from dryad_tpu.engine import leafwise_fast as jlf
from dryad_tpu.engine import pallas_hist as jph

import dryad_tpu_torch as dt
from dryad_tpu_torch import config as tconfig
from dryad_tpu_torch.config import Params as TParams
from dryad_tpu_torch.convert import booster_from_reference
from dryad_tpu_torch.engine import grower as tgrower
from dryad_tpu_torch.engine import hist, hist_nat
from dryad_tpu_torch.engine import leafwise_fast as tlf
from torch_layout import one_torch_thread  # noqa: F401 (autouse)

_INT_KEYS = ("feature", "threshold", "left", "right", "default_left",
             "row_leaf", "max_depth", "cover")


def _fixture(seed, N, F, B, nan=0.0):
    """Labels from two features with well-separated effects, logloss g/h at
    p = 0.5 plus a little noise: best gains far apart."""
    rng = np.random.default_rng(seed)
    Xb = rng.integers(0 if nan else 1, B, (N, F)).astype(np.uint8)
    if nan:
        Xb[rng.random((N, F)) < nan] = 0
    score = (Xb[:, 0] / B - 0.5 + 0.4 * np.cos(Xb[:, 1] / 5.0)
             + 0.2 * (Xb[:, 2] > B // 2))
    y = (rng.random(N) < 1 / (1 + np.exp(-3 * score))).astype(np.float32)
    noise = rng.normal(0, 0.01, N).astype(np.float32)
    g = (0.5 - y).astype(np.float32) + noise
    h = np.full(N, 0.25, np.float32)
    bag = rng.random(N) < 0.9
    return Xb, g, h, bag


def _port(fn, p, B, Xb, g, h, bag, lm=False):
    F = Xb.shape[1]
    return fn(p, B, torch.from_numpy(Xb), torch.from_numpy(g),
              torch.from_numpy(h), torch.from_numpy(bag),
              torch.ones(F, dtype=torch.bool), learn_missing=lm)


def _ref(fn, p, B, Xb, g, h, bag, lm=False):
    F = Xb.shape[1]
    return fn(p, B, jnp.asarray(Xb), jnp.asarray(g), jnp.asarray(h),
              jnp.asarray(bag), jnp.ones(F, bool), jnp.zeros(F, bool),
              platform="cpu", learn_missing=lm)


def _assert_trees(got, want, exact=False):
    def arr(t, k):
        v = t[k]
        return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

    for k in _INT_KEYS:
        np.testing.assert_array_equal(arr(got, k), arr(want, k), err_msg=k)
    if exact:
        np.testing.assert_array_equal(arr(got, "value"), arr(want, "value"))
        np.testing.assert_array_equal(arr(got, "gain"), arr(want, "gain"))
    else:
        np.testing.assert_allclose(arr(got, "value"), arr(want, "value"),
                                   atol=1e-4)
        np.testing.assert_allclose(arr(got, "gain"), arr(want, "gain"),
                                   rtol=1e-4, atol=1e-4)
    assert int((arr(got, "feature") >= 0).sum()) > 5      # a real tree


def _count_calls(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*a, **k):
        calls.append(a)
        return real(*a, **k)

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("case", ["wired", "legacy_nat", "legacy_no_nat",
                                  "missing"])
def test_batched_matches_reference(monkeypatch, case):
    """Wired and K3-live legacy against the reference's Pallas arm
    (interpret mode); K3 gated off and learn_missing against its XLA
    arm."""
    depth, leaves, N, F, B = {"wired": (5, 15, 3000, 6, 32),
                              "legacy_nat": (6, 20, 3000, 6, 32),
                              "legacy_no_nat": (6, 20, 3000, 6, 32),
                              "missing": (5, 15, 3000, 6, 32)}[case]
    nan = 0.05 if case == "missing" else 0.0
    layout = "legacy" if case.startswith("legacy") else "auto"
    backend = "pallas" if case in ("wired", "legacy_nat") else "xla"
    if case == "legacy_no_nat":
        # the whole-matrix gate of both packages set to 0 MB; edit no file
        monkeypatch.setattr(jph, "_NAT_GATE_MB", 0)
        monkeypatch.setattr(hist_nat, "NAT_GATE_MB", 0)
    nat = _count_calls(monkeypatch, hist_nat, "build_hist_nat")
    rows = _count_calls(monkeypatch, hist, "hist_rows")
    tiles = _count_calls(monkeypatch, hist, "hist_tiles")
    Xb, g, h, bag = _fixture(depth + leaves + N, N, F, B, nan)
    kw = dict(growth="leafwise", max_depth=depth, num_leaves=leaves,
              max_bins=B, min_data_in_leaf=20, deep_layout=layout)
    jp, tp = JParams(hist_backend=backend, **kw), TParams(**kw)
    wired = layout == "auto"
    assert tlf.leafwise_layout_supported(tp, F, B, 1) == wired
    assert jlf.leafwise_layout_supported(
        JParams(hist_backend="pallas", **kw), F, B, 1, "cpu") == wired
    ref = _ref(jlf.grow_tree_leafwise_batched, jp, B, Xb, g, h, bag, nan > 0)
    got = _port(tlf.grow_tree_leafwise_batched, tp, B, Xb, g, h, bag,
                nan > 0)
    _assert_trees(got, ref)
    # the kernels each arm runs: wired, K1 layout mode at the root and
    # every level; legacy, K1 row mode at the root, K3 (when live) at the
    # levels of at most 16 columns, K1 row mode at the others
    d_switch, p_narrow, p_full = tlf.phase_plan(depth)
    if wired:
        assert (len(tiles), len(rows), len(nat)) == (1 + depth, 0, 0)
    else:
        n_nat = 0 if case == "legacy_no_nat" else (
            d_switch + (depth - d_switch) * (p_full <= 16))
        assert (len(tiles), len(nat), len(rows)) == (0, n_nat,
                                                     1 + depth - n_nat)


@pytest.mark.parametrize("layout,depth,leaves,lm", [
    ("auto", 6, 31, False), ("legacy", 7, 40, False), ("auto", 5, 20, True)])
def test_batched_equals_sequential(layout, depth, leaves, lm):
    """The reference's own contract, in the port: the expansion plus
    selection equals the slot machine, node ids and row_leaf included,
    bitwise (both sum every histogram in the tree's fixed point)."""
    N, F, B = 4000, 6, 32
    Xb, g, h, bag = _fixture(depth * 7 + leaves, N, F, B, 0.05 if lm else 0)
    p = TParams(growth="leafwise", max_depth=depth, num_leaves=leaves,
                max_bins=B, min_data_in_leaf=20, deep_layout=layout)
    bat = _port(tlf.grow_tree_leafwise_batched, p, B, Xb, g, h, bag, lm)
    seq = _port(tgrower.grow_tree, p, B, Xb, g, h, bag, lm)
    _assert_trees(bat, seq, exact=True)


@pytest.mark.parametrize("growth,leaves", [("leafwise", 20),
                                           ("depthwise", 24)])
def test_sequential_matches_reference(growth, leaves):
    """Unbounded depth (max_depth=-1, unbounded_depth="exact" so the
    leaf-wise config stays sequential): the port's grow_tree against the
    reference's on its XLA arm; depthwise picks the shallowest level
    first."""
    N, F, B = 3000, 6, 32
    Xb, g, h, bag = _fixture(leaves, N, F, B)
    kw = dict(growth=growth, max_depth=-1, num_leaves=leaves, max_bins=B,
              min_data_in_leaf=20, unbounded_depth="exact")
    ref = _ref(jgrower.grow_tree, JParams(hist_backend="xla", **kw), B, Xb,
               g, h, bag)
    got = _port(tgrower.grow_tree, TParams(**kw), B, Xb, g, h, bag)
    _assert_trees(got, ref)


def test_policy_helpers_match_reference():
    for leaves in (2, 7, 31, 255, 1000, 5000, 20000):
        for F, B in ((28, 256), (6, 32), (2000, 256), (500, 1024)):
            for N in (None, 3000, 10_000_000, 100_000_000):
                for ud in ("auto", "exact"):
                    for depth in (-1, 5, 12, 15):
                        kw = dict(growth="leafwise", num_leaves=leaves,
                                  max_depth=depth, unbounded_depth=ud)
                        tp, jp = TParams(**kw), JParams(**kw)
                        assert tconfig.leafwise_fast_supported(
                            tp, F, B, N) == jconfig.leafwise_fast_supported(
                            jp, F, B, N), (kw, F, B, N)
                        assert tconfig.effective_depth_params(
                            tp, F, B, N).max_depth == \
                            jconfig.effective_depth_params(
                                jp, F, B, N).max_depth, (kw, F, B, N)
    for depth in range(1, 15):
        assert tlf.phase_plan(depth) == jlf.phase_plan(depth)
        for layout in ("auto", "legacy"):
            for F in (6, 28, 119, 120):
                kw = dict(growth="leafwise", max_depth=depth, num_leaves=31,
                          deep_layout=layout)
                assert tlf.leafwise_layout_supported(
                    TParams(**kw), F, 256, 1) == jlf.leafwise_layout_supported(
                    JParams(hist_backend="pallas", **kw), F, 256, 1, "cpu")
    # the reference's documented values (tests/test_leafwise_fast.py)
    p = TParams(num_leaves=255)
    assert tconfig.effective_depth_params(p, 28, 256).max_depth == 12
    assert tconfig.effective_depth_params(p, 28, 256, 10_000_000).max_depth \
        == 12
    assert tconfig.effective_depth_params(TParams(), 8, 32).max_depth == 9
    assert tconfig.effective_depth_params(p, 2000, 256) is p
    dw = TParams(growth="depthwise")
    assert tconfig.effective_depth_params(dw, 28, 256) is dw


def test_grow_any_routes_and_warns(monkeypatch):
    called = []
    for name in ("grow_tree_leafwise_batched",):
        monkeypatch.setattr(tlf, name, lambda *a, **k: called.append("bat"))
    monkeypatch.setattr(tgrower, "grow_tree",
                        lambda *a, **k: called.append("seq"))
    import dryad_tpu_torch.engine.levelwise as tlw
    monkeypatch.setattr(tlw, "grow_tree_levelwise",
                        lambda *a, **k: called.append("lvl"))
    Xb = torch.zeros((100, 28), dtype=torch.uint8)
    args = (256, Xb, torch.zeros(100), torch.ones(100),
            torch.ones(100, dtype=torch.bool),
            torch.ones(28, dtype=torch.bool))
    cases = [
        (dict(growth="depthwise", max_depth=6), "lvl", None),
        (dict(growth="depthwise", max_depth=-1), "seq", None),
        (dict(growth="leafwise", max_depth=12), "bat", None),
        (dict(growth="leafwise", max_depth=-1), "seq", None),
        (dict(growth="leafwise", max_depth=8, hist_subtraction=False),
         "seq", None),
        (dict(growth="leafwise", max_depth=15), "seq", "cap (14)"),
        (dict(growth="leafwise", max_depth=14), "seq",
         "peak-memory envelope"),
    ]
    for kw, want, warn in cases:
        called.clear()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            tgrower.grow_any(TParams(num_leaves=255, **kw), *args)
        assert called == [want], kw
        msgs = [str(w.message) for w in caught]
        if warn is None:
            assert not msgs, (kw, msgs)
        else:
            assert len(msgs) == 1 and warn in msgs[0], (kw, msgs)
            assert "falling back to the sequential grower" in msgs[0]
        # the reference routes the same config the same way
        jp = JParams(num_leaves=255, **kw)
        if jp.growth == "leafwise":
            assert jlf.supports(jp, 28, 256, 100) == (want == "bat")


def test_train_at_reference_defaults():
    """``{"objective": "binary"}``: leaf-wise, 31 leaves, max_depth=-1 ->
    effective depth 9 on the wired arm, in both packages."""
    X, y = jdatasets.higgs_like(3000, seed=11)
    X = X[:, :8]
    params = {"objective": "binary", "num_trees": 2, "max_bins": 32}
    jds = dryad_tpu.Dataset(X, y, max_bins=32)
    jb = dryad_tpu.train(params, jds, backend="tpu")
    tds = dt.Dataset(X, y, max_bins=32)
    tb = dt.train(params, tds, device="cpu")
    assert tb.params.max_depth == jb.params.max_depth == 9
    assert tb.params.growth == "leafwise"
    assert tlf.leafwise_layout_supported(tb.params, 8, 32, 1)
    ref, got = jb.tree_arrays(), tb.to_reference_arrays()
    for k in ("feature", "threshold", "left", "right", "default_left"):
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
    np.testing.assert_array_equal(got["cover"], ref["cover"])
    np.testing.assert_allclose(got["value"], ref["value"], atol=1e-4)
    assert tb.max_depth_seen == jb.max_depth_seen
    assert (got["feature"] >= 0).sum() == 2 * 30         # 31 leaves a tree
    # a carried reference model predicts bitwise equal on the port's CPU
    # predict; the port's own model tracks it
    carried = booster_from_reference(
        jb.tree_arrays(), json.loads(json.dumps(jb.mapper.to_json_dict())),
        jb.init_score, jb.params.to_dict(), jb.max_depth_seen)
    want = dryad_tpu.predict(jb, X, raw_score=True)
    np.testing.assert_array_equal(
        dt.predict(carried, X, raw_score=True, device="cpu"), want)
    np.testing.assert_allclose(dt.predict(tb, X, raw_score=True,
                                          device="cpu"), want, atol=1e-4)
