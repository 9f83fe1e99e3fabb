"""The port's legacy plan arm of the depthwise grower against the
reference's legacy arm (dryad_tpu.engine.levelwise, Pallas in interpret
mode), and against the port's own wired arm.

Tolerances, as in tests/test_torch_split_grower.py: integer tree arrays
and covers equal on fixtures without near-tie gains; leaf values within
1e-4 and gains within rtol/atol 1e-4 (the packages sum histograms in
different orders).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dryad_tpu.config import Params as JParams
from dryad_tpu.engine import levelwise as jlw
from dryad_tpu.engine import pallas_hist as jph
from dryad_tpu_torch.config import Params as TParams
from dryad_tpu_torch.engine import hist_nat
from dryad_tpu_torch.engine import levelwise as tlw
from dryad_tpu_torch.engine import tile_plan

from test_torch_split_grower import _tree_inputs
from torch_layout import one_torch_thread  # noqa: F401 (autouse)

_INT_KEYS = ("feature", "threshold", "left", "right", "default_left",
             "row_leaf", "max_depth", "cover")


def _grow_both(depth, leaves, N, F, B, nan, sub, layout):
    Xb, g, h = _tree_inputs(depth * 100 + leaves + F, N, F, B, nan)
    lm = nan > 0
    kw = dict(growth="depthwise", max_depth=depth, num_leaves=leaves,
              max_bins=B, hist_subtraction=sub, min_data_in_leaf=20,
              deep_layout=layout)
    jp = JParams(hist_backend="pallas", **kw)
    tp = TParams(**kw)
    isz = Xb.dtype.itemsize
    assert not jlw.deep_layout_supported(jp, F, B, isz, platform="cpu")
    assert not tlw.deep_layout_supported(tp, F, B, isz)
    ref = jlw.grow_tree_levelwise(
        jp, B, jnp.asarray(Xb), jnp.asarray(g), jnp.asarray(h),
        jnp.ones(N, bool), jnp.ones(F, bool), jnp.zeros(F, bool),
        platform="cpu", learn_missing=lm)
    got = tlw.grow_tree_levelwise(
        tp, B, torch.from_numpy(Xb), torch.from_numpy(g), torch.from_numpy(h),
        torch.ones(N, dtype=torch.bool), torch.ones(F, dtype=torch.bool),
        learn_missing=lm)
    return ref, got


@pytest.mark.parametrize("depth,leaves,N,F,B,nan,sub,layout,nat", [
    (6, 40, 8000, 6, 32, 0.0, True, "legacy", True),   # both phases, K3 live
    (6, 40, 8000, 6, 32, 0.0, True, "legacy", False),  # natural pass gated off
    (4, 12, 5000, 6, 64, 0.0, True, "legacy", True),   # leaf-budget pressure
    (5, 31, 6000, 6, 48, 0.05, True, "legacy", True),  # learn_missing
    (5, 31, 6000, 6, 48, 0.0, False, "legacy", True),  # hist_subtraction off
    (10, 600, 3000, 6, 16, 0.0, True, "auto", True),   # > 512 leaves (gate)
    (4, 15, 3000, 130, 16, 0.0, True, "auto", True),   # 139-byte records
])
def test_legacy_tree_matches_reference(monkeypatch, depth, leaves, N, F, B,
                                       nan, sub, layout, nat):
    if not nat:
        # the whole-matrix gate of both packages set to 0 MB; edit no file
        monkeypatch.setattr(jph, "_NAT_GATE_MB", 0)
        monkeypatch.setattr(hist_nat, "NAT_GATE_MB", 0)
    calls = {"nat": 0}
    real = hist_nat.build_hist_nat

    def spy(*a, **k):
        calls["nat"] += 1
        return real(*a, **k)

    monkeypatch.setattr(hist_nat, "build_hist_nat", spy)
    ref, got = _grow_both(depth, leaves, N, F, B, nan, sub, layout)
    for k in _INT_KEYS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    np.testing.assert_allclose(got["value"].numpy(), np.asarray(ref["value"]),
                               atol=1e-4)
    np.testing.assert_allclose(got["gain"].numpy(), np.asarray(ref["gain"]),
                               rtol=1e-4, atol=1e-4)
    assert int((got["feature"] >= 0).sum()) > 3      # a real tree
    d_switch, P_narrow, _ = tlw.phase_plan(depth, min(leaves, 2 ** depth),
                                           nat)
    want_nat = d_switch if nat and P_narrow <= hist_nat.NAT_SLOTS else 0
    assert calls["nat"] == want_nat


def test_wired_and_legacy_arms_grow_the_same_tree():
    """On a tie-free fixture the port's two arms give equal trees (their
    histograms are fp64 sums of the same rows, rounded once)."""
    N, F, B = 12000, 8, 64
    rng = np.random.default_rng(43)
    Xb = rng.integers(1, B, (N, F)).astype(np.uint8)
    score = Xb[:, 0] / B - 0.5 + 0.4 * np.cos(Xb[:, 3] / 7.0)
    y = (rng.random(N) < 1 / (1 + np.exp(-3 * score))).astype(np.float32)
    g = (0.5 - y).astype(np.float32) + rng.normal(0, 0.01, N).astype(np.float32)
    h = np.full(N, 0.25, np.float32)
    out = {}
    for layout in ("auto", "legacy"):
        p = TParams(growth="depthwise", max_depth=8, num_leaves=128,
                    max_bins=B, deep_layout=layout)
        assert tlw.deep_layout_supported(p, F, B, 1) == (layout == "auto")
        out[layout] = tlw.grow_tree_levelwise(
            p, B, torch.from_numpy(Xb), torch.from_numpy(g),
            torch.from_numpy(h), torch.ones(N, dtype=torch.bool),
            torch.ones(F, dtype=torch.bool))
    w, lg = out["auto"], out["legacy"]
    for k in _INT_KEYS:
        np.testing.assert_array_equal(w[k].numpy(), lg[k].numpy(), err_msg=k)
    np.testing.assert_allclose(w["value"].numpy(), lg["value"].numpy(),
                               atol=1e-5)
    assert int((w["feature"] >= 0).sum()) > 40


def test_legacy_root_reads_the_record_table(monkeypatch):
    """The legacy arm builds one record table per tree and its root pass
    reads it (K1 row mode), whatever the record width."""
    seen = []
    real = tile_plan.make_records

    def spy(*a, **k):
        seen.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(tile_plan, "make_records", spy)
    N, F, B = 1500, 200, 16
    Xb, g, h = _tree_inputs(5, N, F, B)
    p = TParams(growth="depthwise", max_depth=3, num_leaves=8, max_bins=B)
    tree = tlw.grow_tree_levelwise(
        p, B, torch.from_numpy(Xb), torch.from_numpy(g), torch.from_numpy(h),
        torch.ones(N, dtype=torch.bool), torch.ones(F, dtype=torch.bool))
    assert seen == [(N, F)]
    assert int(tree["max_depth"]) == 3


def test_bins_past_the_kernel_cap_raise(monkeypatch):
    """Past K1's bins cap the kernels' wrappers raise, and the grower does
    not call them: it takes arm A1 (no record table, no K1 pass) and
    grows the tree."""
    from dryad_tpu_torch.engine import hist

    B, F, N = 1500, 3, 600
    p = TParams(growth="depthwise", max_depth=3, num_leaves=8, max_bins=2000)
    rng = np.random.default_rng(3)
    Xb = torch.from_numpy(rng.integers(0, B, (N, F)).astype(np.int32))
    g = torch.from_numpy(rng.normal(size=N).astype(np.float32))
    h = torch.ones(N)
    recs = tile_plan.make_records(Xb, g, h)
    shift = hist.fixed_point_shift(g, h)
    with pytest.raises(ValueError, match="1024"):
        hist.hist_rows(recs, torch.arange(hist.TILE_ROWS * 2),
                       torch.zeros(2, dtype=torch.int64), 1, B, F, 2, shift)

    def refuse(*a, **k):
        raise AssertionError("a K1 pass past the bins cap")

    monkeypatch.setattr(tile_plan, "make_records", refuse)
    monkeypatch.setattr(hist, "hist_rows", refuse)
    tree = tlw.grow_tree_levelwise(
        p, B, Xb, g, h, torch.ones(N, dtype=torch.bool),
        torch.ones(F, dtype=torch.bool))
    assert int(tree["max_depth"]) == 3
