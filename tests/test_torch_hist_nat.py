"""K3 (dryad_tpu_torch.engine.hist_nat) and K1's row mode
(hist.hist_rows, the reference's hist_from_plan), in their plain versions, against the
reference's Pallas kernels run in interpret mode on the CPU.

Tolerance: counts exact (sums of 0/1); g/h at rtol 1e-5 / atol 1e-4, the
contract of tests/test_pallas_hist.py: the two packages add the same fp32
values differently (the port as exact fixed-point integer sums in the
tree's shift, rounded once; the reference on its three-limb fp32 path).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dryad_tpu.engine import pallas_hist as jph
from dryad_tpu_torch.engine import hist, hist_nat, tile_plan
from dryad_tpu_torch.engine.histogram import build_hist_segmented
from torch_layout import one_torch_thread  # noqa: F401 (autouse)

T = tile_plan.TILE_ROWS


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, 2], want[:, 2])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def _data(N, F, B, dtype, seed):
    rng = np.random.default_rng(seed)
    Xb = rng.integers(0, B, size=(N, F)).astype(dtype)
    g = rng.normal(size=N).astype(np.float32)
    h = rng.uniform(0.1, 1.0, N).astype(np.float32)
    return rng, Xb, g, h


def _torch_bins(Xb):
    return (torch.from_numpy(Xb) if Xb.dtype == np.uint8
            else torch.from_numpy(Xb.astype(np.int32)))


@pytest.mark.parametrize("N,F,B,dtype,P", [
    (1500, 7, 32, np.uint8, 6),
    (1100, 7, 300, np.uint16, 16),     # u16 bins, all 16 slots
    (1300, 130, 16, np.uint8, 1),      # wide, one slot
    (700, 130, 16, np.uint16, 6),
])
def test_natural_order_pass_matches_reference(N, F, B, dtype, P):
    """build_hist_small maps sel == P to the drop; build_hist_nat drops
    the sentinel and any slot past num_cols.  N is not a multiple of 512,
    so the padded tail is exercised; unused slots are zero."""
    rng, Xb, g, h = _data(N, F, B, dtype, seed=N + F + P)
    sel = rng.integers(0, P + 1, size=N).astype(np.int32)   # P = drop
    if P > 2:
        sel[sel == 2] = 0                                     # slot 2 empty
    nat_j = jph.natural_tiles(jnp.asarray(Xb), B)
    want = jph.build_hist_small(nat_j, jnp.asarray(g), jnp.asarray(h),
                                jnp.asarray(sel), P, B, F, platform="cpu")
    nat_t = hist_nat.natural_tiles(_torch_bins(Xb))
    assert nat_t.shape == (F, -(-N // T) * T)
    gt, ht = torch.from_numpy(g), torch.from_numpy(h)
    shift = hist.fixed_point_shift(gt, ht)
    got = hist_nat.build_hist_small(nat_t, gt, ht, torch.from_numpy(sel),
                                    P, B, F, shift)
    _close(got, want)
    if P > 2:
        assert not got[2].any()
    # the raw pass with the drop sentinel and slots past num_cols
    sel_raw = np.where(sel == P, hist_nat.NAT_DROP, sel).astype(np.int32)
    sel_raw[::7] = min(P + 1, hist_nat.NAT_SLOTS - 1)
    want = jph.build_hist_nat(nat_j, jnp.asarray(g), jnp.asarray(h),
                              jnp.asarray(sel_raw), total_bins=B,
                              num_features=F, num_cols=P, platform="cpu")
    got = hist_nat.build_hist_nat(nat_t, gt, ht, torch.from_numpy(sel_raw),
                                  shift, total_bins=B, num_features=F,
                                  num_cols=P)
    _close(got, want)


def test_nat_gate_matches_reference():
    for n, f, isz in ((10_000_000, 28, 1), (400_000, 2000, 1),
                      (1 << 20, 512, 1), ((1 << 20) + 1, 512, 1),
                      (1 << 20, 256, 2)):
        assert hist_nat.nat_gate_admits(n, f, isz) == jph.nat_gate_admits(
            n, f, isz), (n, f, isz)


@pytest.mark.parametrize("N,F,B,dtype,P,aligned", [
    (2500, 6, 32, np.uint8, 5, True),
    (2500, 6, 32, np.uint8, 5, False),
    (1800, 130, 16, np.uint8, 3, True),    # records past 128 B
    (1200, 300, 16, np.uint8, 2, False),
    (2200, 9, 300, np.uint16, 4, True),    # u16 bins
    (1600, 130, 64, np.uint16, 3, False),
])
def test_row_mode_matches_reference(N, F, B, dtype, P, aligned):
    """K1 row mode on the reference's own plans (generic and aligned, with
    an empty slot) and record table."""
    rng, Xb, g, h = _data(N, F, B, dtype, seed=N + F)
    sel = rng.integers(0, P + 1, size=N).astype(np.int32)
    sel[sel == 1] = 0                                         # slot 1 empty
    counts = np.bincount(sel[sel < P], minlength=P)[:P].astype(np.int32)
    Xj, gj, hj, sj = (jnp.asarray(a) for a in (Xb, g, h, sel))
    if aligned:
        buf, tl, tf = jph.tile_plan_aligned(sj, jnp.asarray(counts), N, P, T)
    else:
        buf, tl, tf = jph.tile_plan(sj, N, P, T)
    rec_j = jph.make_records(Xj, gj, hj)
    want = jph.hist_from_plan(Xj, gj, hj, buf, tl, tf, P, B, records=rec_j,
                              platform="cpu")
    rec_t = tile_plan.make_records(_torch_bins(Xb), torch.from_numpy(g),
                                   torch.from_numpy(h))
    shift = hist.fixed_point_shift(torch.from_numpy(g), torch.from_numpy(h))
    got = hist.hist_rows(
        rec_t, torch.from_numpy(np.array(buf)),
        torch.from_numpy(np.array(tl)), P, B, F, np.dtype(dtype).itemsize,
        shift)
    _close(got, want)
    assert not got[1].any()                                   # empty slot
    # the port's own plan through build_hist_segmented gives the same
    got2 = build_hist_segmented(
        _torch_bins(Xb), torch.from_numpy(g), torch.from_numpy(h),
        torch.from_numpy(sel), P, B, shift, records=rec_t,
        sel_counts=torch.from_numpy(counts) if aligned else None)
    assert torch.equal(got, got2)


def test_nat_pass_refuses_more_than_16_slots():
    nat = torch.zeros((3, T), dtype=torch.uint8)
    z = torch.zeros(10)
    with pytest.raises(ValueError, match="16"):
        hist_nat.build_hist_small(nat, z, z, torch.zeros(10, dtype=torch.int32),
                                  17, 16, 3, hist.fixed_point_shift(z, z))
