"""The port's split scan and depthwise wired grower against the reference
(dryad_tpu.engine.split / levelwise, Pallas in interpret mode).

Tolerances: split choices (feature, threshold, default_left) and every
integer tree array are equal, on fixtures without near-tie gains; gains
and child sums are fp32 expressions of the same inputs, held at rtol 1e-5;
leaf values within 1e-4 absolute, since the two packages sum histograms
in different orders (ulp-level, then divided by H + lambda).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dryad_tpu.config import Params as JParams
from dryad_tpu.engine import levelwise as jlw
from dryad_tpu.engine.split import find_best_split as j_find
from dryad_tpu_torch.config import Params as TParams
from dryad_tpu_torch.engine import levelwise as tlw
from dryad_tpu_torch.engine.split import find_best_split as t_find
from torch_layout import one_torch_thread  # noqa: F401 (autouse)


def _hists(rng, K, F, B, missing):
    c = rng.integers(0, 40, (K, F, B)).astype(np.float32)
    if not missing:
        c[:, :, 0] = 0
    g = (rng.normal(size=(K, F, B)) * c).astype(np.float32)
    h = (rng.uniform(0.1, 0.3, (K, F, B)) * c).astype(np.float32)
    hist = np.stack([g, h, c], 1)
    return hist, hist[:, 0, 0].sum(-1), hist[:, 1, 0].sum(-1), hist[:, 2, 0].sum(-1)


@pytest.mark.parametrize("learn_missing", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_find_best_split_matches_reference(learn_missing, seed):
    rng = np.random.default_rng(seed)
    K, F, B = 6, 5, 24
    hist, G, H, C = _hists(rng, K, F, B, missing=learn_missing)
    fmask = np.ones(F, bool)
    fmask[2] = False
    allow = np.array([True, True, False, True, True, True])
    kw = dict(lambda_l2=1.0, min_child_weight=1e-3, min_data_in_leaf=20,
              min_split_gain=0.0)
    got = t_find(torch.from_numpy(hist), torch.from_numpy(G),
                 torch.from_numpy(H), torch.from_numpy(C),
                 feat_mask=torch.from_numpy(fmask),
                 allow=torch.from_numpy(allow), learn_missing=learn_missing,
                 **kw)
    for k in range(K):
        ref = j_find(jnp.asarray(hist[k]), jnp.float32(G[k]), jnp.float32(H[k]),
                     jnp.float32(C[k]), feat_mask=jnp.asarray(fmask),
                     is_cat_feat=jnp.zeros(F, bool),
                     allow=jnp.asarray(allow[k]), has_cat=False,
                     learn_missing=learn_missing, **kw)
        assert int(got["feature"][k]) == int(ref.feature)
        assert int(got["threshold"][k]) == int(ref.threshold)
        assert bool(got["default_left"][k]) == bool(ref.default_left)
        for name, r in (("gain", ref.gain), ("g_left", ref.g_left),
                        ("h_left", ref.h_left), ("c_left", ref.c_left)):
            np.testing.assert_allclose(float(got[name][k]), float(r),
                                       rtol=1e-5, err_msg=name)


def _tree_inputs(seed, N, F, B, nan_frac=0.0):
    rng = np.random.default_rng(seed)
    Xb = rng.integers(0 if nan_frac else 1, B, (N, F)).astype(np.uint8)
    if nan_frac:
        Xb[rng.random((N, F)) < nan_frac] = 0
    score = (Xb[:, 0].astype(np.float32) / B - 0.5
             + 0.3 * np.sin(Xb[:, 1].astype(np.float32)))
    y = (rng.random(N) < 1 / (1 + np.exp(-3 * score))).astype(np.float32)
    p = np.float32(0.5)
    g = (p - y).astype(np.float32) + rng.normal(0, 0.01, N).astype(np.float32)
    h = np.full(N, p * (1 - p), np.float32)
    return Xb, g, h


@pytest.mark.parametrize("depth,leaves,N,B,nan,sub", [
    (4, 15, 5000, 64, 0.0, True),     # one narrow phase
    (6, 40, 8000, 32, 0.0, True),     # both phases, leaf budget pressure
    (5, 31, 6000, 48, 0.05, True),    # learn_missing (two-plane scan)
    (5, 31, 6000, 48, 0.0, False),    # hist_subtraction=False arm
])
def test_one_tree_matches_reference(depth, leaves, N, B, nan, sub):
    F = 6
    Xb, g, h = _tree_inputs(depth * 100 + leaves, N, F, B, nan)
    lm = nan > 0
    jp = JParams(growth="depthwise", max_depth=depth, num_leaves=leaves,
                 max_bins=B, hist_backend="pallas", hist_subtraction=sub,
                 min_data_in_leaf=20)
    tp = TParams(growth="depthwise", max_depth=depth, num_leaves=leaves,
                 max_bins=B, hist_subtraction=sub, min_data_in_leaf=20)
    assert jlw.deep_layout_supported(jp, F, B, 1, platform="cpu")
    ref = jlw.grow_tree_levelwise(
        jp, B, jnp.asarray(Xb), jnp.asarray(g), jnp.asarray(h),
        jnp.ones(N, bool), jnp.ones(F, bool), jnp.zeros(F, bool),
        platform="cpu", learn_missing=lm)
    got = tlw.grow_tree_levelwise(
        tp, B, torch.from_numpy(Xb), torch.from_numpy(g), torch.from_numpy(h),
        torch.ones(N, dtype=torch.bool), torch.ones(F, dtype=torch.bool),
        learn_missing=lm)
    for k in ("feature", "threshold", "left", "right", "default_left",
              "row_leaf", "max_depth"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(got["cover"].numpy(), np.asarray(ref["cover"]))
    np.testing.assert_allclose(got["value"].numpy(), np.asarray(ref["value"]),
                               atol=1e-4)
    np.testing.assert_allclose(got["gain"].numpy(), np.asarray(ref["gain"]),
                               rtol=1e-4, atol=1e-4)
    assert int((got["feature"] >= 0).sum()) > 3      # a real tree


@pytest.mark.parametrize("depth,leaves", [(8, 255), (6, 40), (4, 31), (1, 2),
                                          (10, 1000)])
def test_phase_plan_matches_reference(depth, leaves):
    L = min(leaves, 2 ** depth)
    for nat in (False, True):
        assert tlw.phase_plan(depth, L, nat) == jlw.phase_plan(depth, L, nat)


def test_gate_refuses_outside_the_wired_layout():
    """The wired gate's verdict equals the reference's (Pallas arm) over a
    grid of leaf budgets, widths, bin item sizes and ``deep_layout``; what
    it refuses, the legacy plan arm grows."""
    for leaves, depth in ((15, 4), (512, 9), (513, 10), (1000, 10)):
        for F, isz in ((4, 1), (119, 1), (120, 1), (59, 2), (60, 2),
                       (2000, 1)):
            for B in (64, 1024, 1025):
                for layout in ("auto", "legacy"):
                    kw = dict(growth="depthwise", max_depth=depth,
                              num_leaves=leaves, deep_layout=layout)
                    jp = JParams(hist_backend="pallas", **kw)
                    assert tlw.deep_layout_supported(
                        TParams(**kw), F, B, isz) == \
                        jlw.deep_layout_supported(jp, F, B, isz,
                                                  platform="cpu"), \
                        (leaves, F, isz, B, layout)
    tp = TParams(growth="depthwise", max_depth=10, num_leaves=1000)
    assert not tlw.deep_layout_supported(tp, 4, 64, 1)
    tree = tlw.grow_tree_levelwise(
        tp, 64, torch.zeros((600, 4), dtype=torch.uint8),
        torch.zeros(600), torch.ones(600),
        torch.ones(600, dtype=torch.bool), torch.ones(4, dtype=torch.bool))
    assert int(tree["max_depth"]) == 0            # constant g: no split
    # records wider than 128 bytes: 9 + 130 features
    ok = TParams(growth="depthwise", max_depth=4, num_leaves=15)
    assert not tlw.deep_layout_supported(ok, 130, 64, 1)
    assert tlw.deep_layout_supported(ok, 119, 64, 1)
