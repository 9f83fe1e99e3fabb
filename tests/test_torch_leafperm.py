"""The port's wired layout (dryad_tpu_torch.engine.leafperm) and K2's plain
version against the reference: the numpy oracle ``permute_records_np`` and
the Pallas ``permute_records`` in interpret mode.

Tolerance: none.  Records, moves and the run bookkeeping are integers and
bytes, so every comparison is bitwise.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dryad_tpu.engine import leafperm as jlp
from dryad_tpu_torch.engine import leafperm as tlp
from torch_layout import one_torch_thread  # noqa: F401 (autouse)

T = tlp.TILE_ROWS


def _mk_layout(rng, seg_counts, WB=128):
    """Tile-aligned layout with contiguous-prefix segments, distinctive
    record bytes and zero sentinels (the reference test's fixture)."""
    lt = np.maximum(-(-np.asarray(seg_counts) // T), 1)
    n_tiles = int(lt.sum())
    rec = np.zeros((n_tiles * T, WB), np.uint8)
    tile_slot = np.repeat(np.arange(len(seg_counts)), lt).astype(np.int32)
    row_seg = np.full(n_tiles * T, -1, np.int32)
    base = np.concatenate([[0], np.cumsum(lt)])
    for s, cnt in enumerate(seg_counts):
        r0 = base[s] * T
        rec[r0:r0 + cnt] = rng.integers(1, 255, (cnt, WB), dtype=np.uint8)
        row_seg[r0:r0 + cnt] = s
    return rec, tile_slot, row_seg


def _sides(rng, row_seg, p_right):
    return np.where(row_seg >= 0,
                    (rng.random(row_seg.size) < p_right).astype(np.int32),
                    2).astype(np.int32)


def _moves_equal(tile_slot, side, n_seg):
    """level_moves of both packages, compared field by field."""
    want = jlp.level_moves(jnp.asarray(tile_slot), jnp.asarray(side), n_seg)
    got = tlp.level_moves(torch.from_numpy(tile_slot),
                          torch.from_numpy(side), n_seg)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    return got


@pytest.mark.parametrize("seg_counts,p_right", [
    ([700, 3, 1200, 0, 513], 0.5),      # ragged, with an empty segment
    ([2048], 0.0),                      # pass-through (all left)
    ([100, 100, 100], 1.0),             # all right
    ([1, 1, 1, 1], 0.5),                # tiny segments, all mandatory pads
])
def test_permute_matches_oracle_and_pallas(seg_counts, p_right):
    rng = np.random.default_rng(len(seg_counts) * 13 + int(p_right * 10))
    rec, tile_slot, row_seg = _mk_layout(rng, seg_counts)
    side = _sides(rng, row_seg, p_right)
    n_seg = len(seg_counts)
    pos, dstl, dstr, _, _, n_out = _moves_equal(tile_slot, side, n_seg)
    bound = tlp.tiles_bound(rec.shape[0], n_seg)
    assert bound == jlp.tiles_bound(rec.shape[0], n_seg)
    assert int(n_out) <= bound
    got = tlp.permute_records(torch.from_numpy(rec), pos, dstl, dstr,
                              bound).numpy()
    oracle, _, _ = tlp.permute_records_np(rec, tile_slot, side, n_seg, bound)
    ref_oracle, _, _ = jlp.permute_records_np(rec, tile_slot, side, n_seg,
                                              bound)
    np.testing.assert_array_equal(oracle, ref_oracle)
    np.testing.assert_array_equal(got, oracle)
    want = np.asarray(jlp.permute_records(
        jnp.asarray(rec), jnp.asarray(pos.numpy()),
        jnp.asarray(dstl.numpy().astype(np.int32)),
        jnp.asarray(dstr.numpy().astype(np.int32)), bound))
    np.testing.assert_array_equal(got, want)


def test_multi_level_wired_chain():
    """Three wired levels from a root layout, driven exactly as the grower
    drives them (run -> slot tables, advance_runs): layout records, moves,
    tile->run maps and run->slot tables bitwise equal to the reference's at
    every level."""
    rng = np.random.default_rng(11)
    N, L, F = 9000, 8, 6
    Xb = rng.integers(0, 40, (N, F)).astype(np.uint8)
    g = rng.normal(size=N).astype(np.float32)
    h = rng.uniform(0.1, 1, N).astype(np.float32)
    bag = rng.random(N) < 0.9
    n_buf = tlp.wired_tiles_bound(-(-N // T), L)
    assert n_buf == jlp.wired_tiles_bound(-(-N // T), L)

    j_nat = jlp.make_layout_records(jnp.asarray(Xb), jnp.asarray(g),
                                    jnp.asarray(h), valid=jnp.asarray(bag))
    t_nat = tlp.make_layout_records(torch.from_numpy(Xb), torch.from_numpy(g),
                                    torch.from_numpy(h),
                                    valid=torch.from_numpy(bag))
    np.testing.assert_array_equal(t_nat.numpy(), np.asarray(j_nat))
    j_rec, j_tr, j_rs = jlp.natural_root_layout(j_nat, L, n_buf)
    t_rec, t_tr, t_rs = tlp.natural_root_layout(t_nat, L, n_buf)
    n_slots = 1
    for level in range(3):
        # every live slot splits with probability 0.7 at a random cut
        rs_np = np.asarray(j_rs)
        run_do = np.zeros(L, bool)
        run_right = np.zeros(L, np.int32)
        live = np.nonzero(rs_np < L)[0]
        for r in live:
            if n_slots < L and rng.random() < 0.7:
                run_do[r] = True
                run_right[r] = n_slots
                n_slots += 1
        row_run = np.repeat(np.asarray(j_tr), T)
        valid = np.asarray(j_rec)[:, 8] == 1
        go_right = rng.random(row_run.size) < 0.4
        side = np.where(valid, np.where(run_do[row_run] & go_right, 1, 0),
                        2).astype(np.int32)
        j_mv = jlp.level_moves(j_tr, jnp.asarray(side), L)
        t_mv = _moves_equal(np.asarray(t_tr.numpy(), np.int32), side, L)
        j_rec = jlp.permute_records(j_rec, j_mv[0], j_mv[1], j_mv[2], n_buf)
        t_rec = tlp.permute_records(t_rec, *t_mv[:3], n_buf)
        np.testing.assert_array_equal(t_rec.numpy(), np.asarray(j_rec),
                                      err_msg=f"level {level} records")
        j_tr, j_rs = jlp.advance_runs(j_rs, jnp.asarray(run_do),
                                      jnp.asarray(run_right), j_mv[3],
                                      j_mv[4], n_buf)
        t_tr, t_rs = tlp.advance_runs(t_rs, torch.from_numpy(run_do),
                                      torch.from_numpy(run_right), t_mv[3],
                                      t_mv[4], n_buf)
        np.testing.assert_array_equal(t_tr.numpy(), np.asarray(j_tr))
        np.testing.assert_array_equal(t_rs.numpy(), np.asarray(j_rs))
    # every in-bag record still present exactly once
    assert int((t_rec[:, 8] == 1).sum()) == int(bag.sum())


@pytest.mark.parametrize("dtype,b", [(np.uint8, 200), (np.uint16, 900)])
def test_layout_records_bitwise(dtype, b):
    rng = np.random.default_rng(b)
    N, F = 1000, 9
    Xb = rng.integers(0, b, (N, F)).astype(dtype)
    g = rng.normal(size=N).astype(np.float32)
    h = rng.uniform(0, 1, N).astype(np.float32)
    want = np.asarray(jlp.make_layout_records(
        jnp.asarray(Xb), jnp.asarray(g), jnp.asarray(h)))
    xt = (torch.from_numpy(Xb) if dtype == np.uint8
          else torch.from_numpy(Xb.astype(np.int32)))
    got = tlp.make_layout_records(xt, torch.from_numpy(g), torch.from_numpy(h))
    np.testing.assert_array_equal(got.numpy(), want)
    gg, hh, valid, bins = tlp.unpack_layout_records(got, F,
                                                    np.dtype(dtype).itemsize)
    np.testing.assert_array_equal(gg.numpy(), g)
    np.testing.assert_array_equal(hh.numpy(), h)
    assert valid.all()
    np.testing.assert_array_equal(bins.numpy(), Xb.astype(np.int64))
    # per-tile feature selection, broadcast over each tile's rows
    n_t = -(-N // T)
    rec3 = torch.nn.functional.pad(got, (0, 0, 0, n_t * T - N)).view(
        n_t, T, tlp.REC_WB)
    feat = torch.from_numpy(rng.integers(0, F, (n_t, 1)))
    bins = tlp.tile_bins(rec3, feat, np.dtype(dtype).itemsize).reshape(-1)
    want_bins = Xb[np.arange(N), np.repeat(feat.numpy()[:, 0], T)[:N]]
    np.testing.assert_array_equal(bins[:N].numpy(), want_bins.astype(np.int64))


@pytest.mark.parametrize("rows,slots,cols,half", [
    (10_000_000, 255, 128, True), (4000, 16, 8, True), (700, 4, 4, False)])
def test_wired_bounds_match_reference(rows, slots, cols, half):
    nt = -(-rows // T)
    nb = tlp.wired_tiles_bound(nt, slots)
    assert nb == jlp.wired_tiles_bound(nt, slots)
    assert (tlp.wired_sel_tiles_bound(nt, nb, cols, half)
            == jlp.wired_sel_tiles_bound(nt, nb, cols, half))


def test_permute_raises_on_ragged_rows():
    """The reference truncates a row count that is not a tile multiple;
    the port raises."""
    rec = torch.zeros((T + 3, tlp.REC_WB), dtype=torch.uint8)
    pos = torch.full((1, 2, T), T, dtype=torch.int32)
    d = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="multiple"):
        tlp.permute_records(rec, pos, d, d, 4)

