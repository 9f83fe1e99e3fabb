"""The fixed-point arithmetic shared by the port's histogram kernels (K1's
two modes and K3) and their plain versions, on the CPU.

The sums are integers, so the checks here are exact: no cell can overflow
(integer bounds), any order of the rows gives the same bits, K1's two modes
and K3 give the same bits on the same rows, and the quantisation error
stays within its stated bound, count * 2^-(s+1) per cell, plus the one
rounding of the result to fp32 (half an ulp).
"""

import math

import numpy as np
import pytest
import torch

from dryad_tpu_torch.config import Params
from dryad_tpu_torch.engine import hist, hist_nat, leafperm, tile_plan
from dryad_tpu_torch.engine.histogram import build_hist_segmented
from dryad_tpu_torch.engine.levelwise import grow_tree_levelwise
from torch_layout import grouped_layout
from torch_layout import one_torch_thread  # noqa: F401 (autouse)

T = hist.TILE_ROWS


def _shift_bound_holds(n, x, s):
    """n rows each at the largest |rint(x * 2^s)| stay within 2^62 (in
    Python integers, which cannot wrap)."""
    q = round(math.ldexp(float(np.abs(x).max()), int(s)))
    return n * q <= 2 ** hist.FIXED_POINT_BITS


@pytest.mark.parametrize("n", [2 ** 10 - 1, 2 ** 10, 2 ** 10 + 1,
                               2 ** 20 - 1, 2 ** 20 + 1, 1, 2])
@pytest.mark.parametrize("top", [1.0, 2.0 ** -7, 2.0 ** 20, 3.0, 0.7])
def test_shift_never_lets_a_cell_overflow(n, top):
    """At N = 2^k +- 1 and max|g| exactly a power of two (the edges of the
    bound), n rows of the largest weight stay within 2^62, and one shift
    more would not."""
    m = 64
    g = torch.full((m,), top, dtype=torch.float32)
    g[::2] = -top
    h = torch.full((m,), top / 4, dtype=torch.float32)
    s = hist.fixed_point_shift(g, h, n)
    assert s.dtype == torch.int32 and tuple(s.shape) == (2,)
    for x, si in ((g, s[0]), (h, s[1])):
        assert _shift_bound_holds(n, x.numpy(), si)
        # and the shift is no smaller than it must be: one more bit at 4x
        # the rows breaks the cell bound
        assert not _shift_bound_holds(4 * n, x.numpy(), si + 1) or \
            int(si) == hist.SHIFT_MAX
        # the quantised value is what the kernels add: exact in int64
        q = hist.quantize(x, si)
        assert int(q.abs().max()) == round(
            math.ldexp(float(x.abs().max()), int(si)))


def test_shift_all_zero_and_empty():
    z = torch.zeros(100)
    s = hist.fixed_point_shift(z, torch.ones(100), 100)
    assert int(s[0]) == hist.SHIFT_MAX
    # 100 <= 2^7 rows, max 1 < 2^1
    assert int(s[1]) == hist.FIXED_POINT_BITS - 7 - 1
    e = hist.fixed_point_shift(torch.zeros(0), torch.zeros(0))
    assert e.tolist() == [hist.SHIFT_MAX, hist.SHIFT_MAX]


def test_one_bin_of_largest_weights_is_exact():
    """Every row in one bin at max|g| (the worst cell): the cell holds
    exactly N * max, no wrap."""
    n, B = 3 * T + 5, 8
    g = torch.full((n,), 2.0 ** 6, dtype=torch.float32)
    h = torch.full((n,), 0.25, dtype=torch.float32)
    Xb = torch.zeros((n, 2), dtype=torch.uint8)
    rec = tile_plan.make_records(Xb, g, h)
    buf = torch.nn.functional.pad(torch.arange(n), (0, (-n) % T), value=n)
    tl = torch.zeros(buf.numel() // T, dtype=torch.int64)
    out = hist.hist_rows(rec, buf, tl, 1, B, 2, 1,
                         hist.fixed_point_shift(g, h))
    assert out[0, 0, :, 0].tolist() == [n * 64.0] * 2
    assert out[0, 1, :, 0].tolist() == [n * 0.25] * 2
    assert out[0, 2, :, 0].tolist() == [float(n)] * 2


def test_non_finite_weight_is_refused():
    g = torch.tensor([0.5, float("nan"), 1.0])
    with pytest.raises(RuntimeError, match="not finite"):
        hist.fixed_point_shift(g, torch.ones(3))
    with pytest.raises(RuntimeError, match="not finite"):
        hist.fixed_point_shift(torch.ones(3), torch.tensor([1.0, float("inf"),
                                                            0.0]))
    # and through the grower, before any histogram
    rng = np.random.default_rng(3)
    Xb = torch.from_numpy(rng.integers(0, 16, (600, 3)).astype(np.uint8))
    g = torch.from_numpy(rng.normal(size=600).astype(np.float32))
    g[17] = float("inf")
    with pytest.raises(RuntimeError, match="not finite"):
        grow_tree_levelwise(Params(growth="depthwise", max_depth=3,
                                   num_leaves=8, max_bins=16), 16, Xb, g,
                            torch.ones(600), torch.ones(600, dtype=torch.bool),
                            torch.ones(3, dtype=torch.bool))


def _rows(seed, n, F, B):
    rng = np.random.default_rng(seed)
    Xb = rng.integers(0, B, (n, F)).astype(np.uint8)
    # weights over many magnitudes, so fp32 sums would depend on order
    g = (rng.normal(size=n) * 10.0 ** rng.integers(-6, 3, n)).astype(
        np.float32)
    h = rng.uniform(0, 1, n).astype(np.float32)
    return rng, torch.from_numpy(Xb), torch.from_numpy(g), torch.from_numpy(h)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_row_permutation_gives_bitwise_equal_histogram(seed):
    n, F, B, P = 3000, 5, 32, 4
    rng, Xb, g, h = _rows(seed, n, F, B)
    sel = torch.from_numpy(rng.integers(0, P + 1, n))
    shift = hist.fixed_point_shift(g, h)
    want = build_hist_segmented(Xb, g, h, sel, P, B, shift)
    perm = torch.from_numpy(rng.permutation(n))
    got = build_hist_segmented(Xb[perm], g[perm], h[perm], sel[perm], P, B,
                               shift)
    assert torch.equal(got, want)
    # and in the plain sums' own order, rows reversed
    leaf = torch.where(sel < P, sel, 0)
    w = sel < P

    def sums(idx):
        return hist.plain_sums(leaf[idx], w[idx], g[idx], h[idx],
                               lambda f0, f1: Xb[idx, f0:f1].to(torch.int64),
                               P, F, B, shift)

    assert torch.equal(sums(torch.arange(n - 1, -1, -1)), want)


@pytest.mark.parametrize("F,B,P", [(6, 32, 5), (28, 256, 16), (3, 64, 1)])
def test_k1_modes_and_k3_bitwise_equal(F, B, P):
    """K1 row mode, K1 layout mode and K3 (plain versions) on the same rows
    and slots give the same bits."""
    n = 2500
    rng, Xb, g, h = _rows(F + P, n, F, B)
    sel = torch.from_numpy(rng.integers(0, P + 1, n))       # P = drop
    shift = hist.fixed_point_shift(g, h)
    rows = hist_nat.build_hist_small(hist_nat.natural_tiles(Xb), g, h, sel,
                                     P, B, F, shift)
    plan = build_hist_segmented(Xb, g, h, sel, P, B, shift)
    # the layout: each slot's rows as a contiguous tile run
    rec, lt, base = grouped_layout(
        leafperm.make_layout_records(Xb, g, h).numpy(), sel.numpy(), P)
    lay = leafperm.hist_from_layout(torch.from_numpy(rec),
                                    torch.from_numpy(base[:-1]),
                                    torch.from_numpy(lt), P, B, F, 1,
                                    int(lt.sum()) + 2, shift)
    assert torch.equal(rows, plan)
    assert torch.equal(lay, plan)


@pytest.mark.parametrize("scale", [1e-30, 1e-9])
def test_tiny_weights_stay_within_the_error_bound(scale):
    """Only tiny g values, then tiny values beside one large one (which
    sets the shift, so the tiny ones fall below 2^-s): each cell is within
    count * 2^-(s+1) of the exact sum, plus half an ulp of the result."""
    n, F, B, P = 4000, 3, 16, 2
    rng = np.random.default_rng(7)
    Xb = torch.from_numpy(rng.integers(0, B, (n, F)).astype(np.uint8))
    sel = torch.from_numpy(rng.integers(0, P, n))
    for big in (False, True):
        g64 = rng.normal(size=n) * scale
        if big:
            g64[0] = 1.0
        g = torch.from_numpy(g64.astype(np.float32))
        h = torch.from_numpy(rng.uniform(0, scale, n).astype(np.float32))
        shift = hist.fixed_point_shift(g, h)
        got = build_hist_segmented(Xb, g, h, sel, P, B, shift).double()
        xb, sl = Xb.numpy(), sel.numpy()
        for plane, x, s in ((0, g, shift[0]), (1, h, shift[1])):
            xs = x.double().numpy()
            # correctly rounded fp64 sums (math.fsum), far below the bound
            exact = np.zeros((P, F, B))
            for p in range(P):
                for f in range(F):
                    for b in range(B):
                        exact[p, f, b] = math.fsum(
                            xs[(sl == p) & (xb[:, f] == b)])
            exact = torch.from_numpy(exact)
            quant = got[:, 2] * 2.0 ** (-int(s) - 1)
            bound = quant + (exact.abs() + quant) * 2.0 ** -24
            err = (got[:, plane] - exact).abs()
            assert bool((err <= bound).all()), (big, plane,
                                                float((err - bound).max()))
