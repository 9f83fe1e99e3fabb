"""K1 (dryad_tpu_torch.engine.hist) against the reference's Pallas
histogram kernel, run in interpret mode on the CPU.

Tolerance: counts exact (sums of 0/1); g/h at rtol 1e-5 / atol 1e-4, the
contract of tests/test_pallas_hist.py — the two packages add the same
fp32 values differently (the port as exact fixed-point integer sums in
the tree's shift, rounded once; the reference on its three-limb fp32
path), so only ulp-level differences remain.  On late-tree hessians, far
below the largest, the h sums are held at rtol 1e-5 with no atol.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dryad_tpu.engine import leafperm as jlp
from dryad_tpu.engine.pallas_hist import build_hist_pallas
from dryad_tpu_torch.engine import hist as thist
from dryad_tpu_torch.engine import histogram as thg
from dryad_tpu_torch.engine import leafperm as tlp
from torch_layout import grouped_layout
from torch_layout import one_torch_thread  # noqa: F401 (autouse)

T = tlp.TILE_ROWS


def _to_torch_bins(Xb):
    return (torch.from_numpy(Xb) if Xb.dtype == np.uint8
            else torch.from_numpy(Xb.astype(np.int32)))


def _data(n, f, b, seed, dtype):
    rng = np.random.default_rng(seed)
    Xb = rng.integers(0, b, size=(n, f)).astype(dtype)
    g = rng.normal(size=n).astype(np.float32)
    h = rng.uniform(0.1, 1.0, n).astype(np.float32)
    return Xb, g, h


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., 2, :, :], want[..., 2, :, :])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n,f,b,dtype,p_mask", [
    (1000, 5, 16, np.uint8, 0.7),        # masked root
    (3000, 7, 300, np.uint16, 0.5),      # u16 bins at B=300
    (2000, 40, 128, np.uint8, 0.9),      # F=40 x B=128 wide blocking
    (1500, 28, 256, np.uint8, 1.0),      # the headline widths
    (700, 4, 32, np.uint8, 0.0),         # empty mask -> all zero
])
def test_root_hist_matches_pallas(n, f, b, dtype, p_mask):
    Xb, g, h = _data(n, f, b, seed=n + f, dtype=dtype)
    mask = np.random.default_rng(f).random(n) < p_mask
    want = build_hist_pallas(jnp.asarray(Xb), jnp.asarray(g), jnp.asarray(h),
                             jnp.asarray(mask), b)
    gt, ht = torch.from_numpy(g), torch.from_numpy(h)
    got = thg.build_hist(_to_torch_bins(Xb), gt, ht, torch.from_numpy(mask),
                         b, thist.fixed_point_shift(gt, ht))
    _close(got, want)
    if p_mask == 0.0:
        assert not got.any()


def test_root_hist_late_tree_hessians_match_pallas():
    """Late in training most rows are confident: their logloss hessians
    p(1-p) lie far below the largest (0.25).  Feature 0 bins rows by their
    margin, so its top bins hold only hessians near 1e-8.  Each still
    counts at its own precision: the h sums equal the reference's at
    rtol 1e-5 with no absolute slack (a fixed point whose step is near
    max|h| * 2^-24 rounds those rows to zero)."""
    n, F, B = 3000, 4, 16
    rng = np.random.default_rng(11)
    y = rng.random(n) < 0.5
    m = rng.uniform(0, 20, n)                 # |margin|, sign agreeing with y
    p = 1 / (1 + np.exp(-np.where(y, m, -m)))
    g = (p - y).astype(np.float32)
    h = (p * (1 - p)).astype(np.float32)
    Xb = rng.integers(0, B, (n, F)).astype(np.uint8)
    Xb[:, 0] = np.minimum(m / 20 * B, B - 1).astype(np.uint8)
    assert h[Xb[:, 0] == B - 1].max() < 1e-7 < h.max()
    mask = np.ones(n, bool)
    want = np.asarray(build_hist_pallas(jnp.asarray(Xb), jnp.asarray(g),
                                        jnp.asarray(h), jnp.asarray(mask), B))
    gt, ht = torch.from_numpy(g), torch.from_numpy(h)
    got = thg.build_hist(torch.from_numpy(Xb), gt, ht, torch.from_numpy(mask),
                         B, thist.fixed_point_shift(gt, ht)).numpy()
    _close(got, want)
    np.testing.assert_allclose(got[..., 1, :, :], want[..., 1, :, :],
                               rtol=1e-5, atol=0)


def _grouped_layout(Xb, g, h, seg_of, S):
    """Records grouped by segment in row order, tile-aligned (the layout
    the reference's test_hist_from_layout_bitwise_vs_plan builds)."""
    rec_nat = np.asarray(jlp.make_layout_records(
        jnp.asarray(Xb), jnp.asarray(g), jnp.asarray(h)))
    return grouped_layout(rec_nat, seg_of, S)


@pytest.mark.parametrize("f,b,dtype,sel", [
    (12, 64, np.uint8, [2, None, 0]),    # out of order + an empty selection
    (5, 300, np.uint16, [1, 3]),         # u16 bins
    (40, 128, np.uint8, [0, 1, 2, 3]),   # wide blocking
    (9, 32, np.uint8, [3]),              # single leaf
])
def test_hist_from_layout_matches_pallas(f, b, dtype, sel):
    rng = np.random.default_rng(f * 7 + b)
    N, S = 5000, 4
    Xb, g, h = _data(N, f, b, seed=f, dtype=dtype)
    seg_of = rng.integers(0, S, N).astype(np.int32)
    rec, lt, base = _grouped_layout(Xb, g, h, seg_of, S)
    seg_first = np.asarray([int(base[s]) if s is not None else 0
                            for s in sel], np.int32)
    seg_nt = np.asarray([int(lt[s]) if s is not None else 0 for s in sel],
                        np.int32)
    bound = int(np.maximum(seg_nt, 1).sum()) + 3      # spare dead slots
    want = jlp.hist_from_layout(jnp.asarray(rec), jnp.asarray(seg_first),
                                jnp.asarray(seg_nt), len(sel), b, f, dtype,
                                bound)
    got = tlp.hist_from_layout(torch.from_numpy(rec),
                               torch.from_numpy(seg_first),
                               torch.from_numpy(seg_nt), len(sel), b, f,
                               np.dtype(dtype).itemsize, bound,
                               thist.fixed_point_shift(torch.from_numpy(g),
                                                       torch.from_numpy(h)))
    _close(got, want)
    for i, s in enumerate(sel):
        if s is None:
            assert not got[i].any()          # empty selection zeroed


def test_hist_raises_past_bin_cap():
    rec = torch.zeros((T, tlp.REC_WB), dtype=torch.uint8)
    src = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="1024"):
        thist.hist_tiles(rec, src, src, 1, 1025, 4, 2,
                         torch.zeros(2, dtype=torch.int32))


def test_hist_from_layout_raises_on_short_plan():
    """The reference truncates silently when n_sel_tiles is below
    sum(max(seg_ntiles, 1)); the port raises."""
    rec = torch.zeros((4 * T, tlp.REC_WB), dtype=torch.uint8)
    seg_first = torch.tensor([0, 2])
    seg_nt = torch.tensor([2, 0])                 # needs 2 + 1 slots
    with pytest.raises(RuntimeError, match="n_sel_tiles"):
        tlp.hist_from_layout(rec, seg_first, seg_nt, 2, 16, 4, 1, 2,
                             torch.zeros(2, dtype=torch.int32))

