"""K1 (both modes) and K3 at the edge shapes of their card kernels, in the
plain versions the CPU runs, against the reference's Pallas kernels in
interpret mode: every row in one bin (a feature's adds all on one cell),
row counts that fill no 512-row tile and no 16 bytes of g, every row
dropped or dead, one and sixteen slots at 1024 bins (where the card splits
the slots into groups), u16 bins.  The card kernels are held bitwise
against these plain versions at the same kinds of shapes
(tests/test_torch_cuda.py).

Tolerance: counts exact (sums of 0/1); g/h at rtol 1e-5 / atol 1e-4, the
contract of tests/test_torch_hist.py: the port sums in exact fixed point in
the tree's shift, rounded once, the reference on its three-limb fp32 path.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dryad_tpu.engine import leafperm as jlp
from dryad_tpu.engine import pallas_hist as jph
from dryad_tpu_torch.engine import hist, hist_nat, leafperm, tile_plan
from torch_layout import grouped_layout
from torch_layout import one_torch_thread  # noqa: F401 (autouse)

T = tile_plan.TILE_ROWS


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, 2], want[:, 2])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def _data(N, F, B, dtype, case, seed):
    rng = np.random.default_rng(seed)
    Xb = (np.full((N, F), B - 1) if case == "one_bin"
          else rng.integers(0, B, (N, F))).astype(dtype)
    g = rng.normal(size=N).astype(np.float32)
    h = rng.uniform(0.1, 1.0, N).astype(np.float32)
    return rng, Xb, g, h


def _torch_bins(Xb):
    return (torch.from_numpy(Xb) if Xb.dtype == np.uint8
            else torch.from_numpy(Xb.astype(np.int32)))


def _shift(g, h):
    return hist.fixed_point_shift(torch.from_numpy(g), torch.from_numpy(h))


@pytest.mark.parametrize("N,F,B,dtype,P,case", [
    (1037, 5, 32, np.uint8, 8, "one_bin"),
    (3, 4, 16, np.uint8, 4, "random"),        # under 16 bytes of g
    (777, 4, 16, np.uint8, 6, "dropped"),     # every row dropped
    (700, 3, 1024, np.uint16, 1, "random"),   # u16, one slot
    (700, 3, 1024, np.uint16, 16, "random"),  # u16, slot groups on the card
])
def test_nat_pass_edge_shapes_match_reference(N, F, B, dtype, P, case):
    rng, Xb, g, h = _data(N, F, B, dtype, case, seed=N + P)
    sel = rng.integers(0, P, N).astype(np.int32)
    sel[::5] = hist_nat.NAT_DROP
    if case == "dropped":
        sel[:] = hist_nat.NAT_DROP
    want = jph.build_hist_nat(jph.natural_tiles(jnp.asarray(Xb), B),
                              jnp.asarray(g), jnp.asarray(h),
                              jnp.asarray(sel), total_bins=B,
                              num_features=F, num_cols=P, platform="cpu")
    got = hist_nat.build_hist_nat(
        hist_nat.natural_tiles(_torch_bins(Xb)), torch.from_numpy(g),
        torch.from_numpy(h), torch.from_numpy(sel), _shift(g, h),
        total_bins=B, num_features=F, num_cols=P)
    _close(got, want)
    assert bool(got.any()) == (case != "dropped")


@pytest.mark.parametrize("N,F,B,dtype,P,case", [
    (1300, 6, 32, np.uint8, 3, "one_bin"),
    (1300, 6, 32, np.uint8, 3, "empty"),      # every plan slot empty
    (900, 3, 1024, np.uint16, 16, "random"),  # u16 at 1024 bins
])
def test_row_mode_edge_shapes_match_reference(N, F, B, dtype, P, case):
    rng, Xb, g, h = _data(N, F, B, dtype, case, seed=N + F + P)
    sel = rng.integers(0, P + 1, N).astype(np.int32)
    if case == "empty":
        sel[:] = P
    Xj, gj, hj, sj = (jnp.asarray(a) for a in (Xb, g, h, sel))
    buf, tl, tf = jph.tile_plan(sj, N, P, T)
    want = jph.hist_from_plan(Xj, gj, hj, buf, tl, tf, P, B,
                              records=jph.make_records(Xj, gj, hj),
                              platform="cpu")
    rec = tile_plan.make_records(_torch_bins(Xb), torch.from_numpy(g),
                                 torch.from_numpy(h))
    got = hist.hist_rows(rec, torch.from_numpy(np.array(buf)),
                         torch.from_numpy(np.array(tl)), P, B, F,
                         np.dtype(dtype).itemsize, _shift(g, h))
    _close(got, want)
    assert bool(got.any()) == (case != "empty")


@pytest.mark.parametrize("N,F,B,dtype,case", [
    (2100, 7, 64, np.uint8, "one_bin"),
    (2100, 7, 64, np.uint8, "dead"),          # every row's valid flag 0
    (1500, 4, 1024, np.uint16, "random"),     # u16 records at 1024 bins
])
def test_layout_mode_edge_shapes_match_reference(N, F, B, dtype, case):
    rng, Xb, g, h = _data(N, F, B, dtype, case, seed=N + F)
    S = 3
    valid = np.full(N, case != "dead")
    rec_nat = np.asarray(jlp.make_layout_records(
        jnp.asarray(Xb), jnp.asarray(g), jnp.asarray(h), jnp.asarray(valid)))
    rec, lt, base = grouped_layout(rec_nat, rng.integers(0, S, N), S)
    seg_first = np.asarray(base[:S], np.int32)
    seg_nt = np.asarray(lt, np.int32)
    bound = int(seg_nt.sum()) + 2
    want = jlp.hist_from_layout(jnp.asarray(rec), jnp.asarray(seg_first),
                                jnp.asarray(seg_nt), S, B, F, dtype, bound)
    got = leafperm.hist_from_layout(
        torch.from_numpy(rec), torch.from_numpy(seg_first),
        torch.from_numpy(seg_nt), S, B, F, np.dtype(dtype).itemsize, bound,
        _shift(g, h))
    _close(got, want)
    assert bool(got.any()) == (case != "dead")
