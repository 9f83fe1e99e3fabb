"""The pieces of the port's data-parallel training (M12a) against the
reference, on the CPU:

* ``keyed_uniform`` and ``sketch_distributed``'s mapper, bit for bit, with
  one fake all-gather over 3 parts passed to both packages;
* ``hist_reduce_resolved`` on a grid of (F, B, ranks);
* the sliced scan, its packed words and the combine on the reference's
  five grids (``tests/test_hist_reduce.py``, rounded to dyadic values so
  that both packages' prefix sums are exact): random grids, feature-major
  ties, plane-major ties under ``learn_missing``, a categorical winner's
  set and all-invalid defaults.  The combine must give the fused scan's
  record field for field, and the packed words must be the reference's;
* the histogram kernels' ``reduce=`` hook (plain versions): an identity
  reduce gives the bits of the fused conversion, and the feature slice
  of a 1-rank group is the slice of the full histogram;
* a 1-rank ``train_distributed`` (a gloo group of one process) against
  the reference's ``train_device`` on its tie-free ``higgs_like(4096)``,
  64-bin fixture: trees equal, leaf values within 1e-5 relative or 1e-6
  absolute (the reference sums fp32 histograms, the port fixed-point
  ones; the same port without a group is matched bit for bit).

Many-rank groups are in ``test_torch_distributed.py``.
"""

import numpy as np
import pytest
import torch
import torch.distributed as tdist

import jax
import jax.numpy as jnp

from dryad_tpu.config import hist_reduce_resolved as ref_resolved
from dryad_tpu.config import make_params as ref_params
from dryad_tpu.data.streaming import _keyed_uniform
from dryad_tpu.distributed import sketch_distributed as ref_sketch
from dryad_tpu.engine import split as ref_split

import dryad_tpu_torch as dt
from dryad_tpu_torch import distributed as dd
from dryad_tpu_torch.config import Params, hist_reduce_resolved
from dryad_tpu_torch.engine import distributed as ed
from dryad_tpu_torch.engine import hist, hist_nat, split
from dryad_tpu_torch.engine.histogram import build_hist_segmented
from dryad_tpu_torch.engine.loop_state import sample_masks
from torch_layout import grouped_layout, one_torch_thread  # noqa: F401


@pytest.mark.parametrize("offset,n,seed", [(0, 1000, 0), (12345, 777, 3),
                                           (2 ** 33, 64, 11)])
def test_keyed_uniform_bitwise(offset, n, seed):
    np.testing.assert_array_equal(dd.keyed_uniform(offset, n, seed),
                                  _keyed_uniform(offset, n, seed))


def test_sketch_distributed_mapper_bitwise():
    """Rank 1 of 3 sketches through a fake all-gather that hands back all
    three parts' samples; both packages freeze the same mapper, and it is
    the mapper of the same call over the unsplit rows."""
    rng = np.random.default_rng(4)
    n, F = 6000, 5
    X = rng.normal(size=(n, F)).astype(np.float32)
    X[:, 3] = rng.integers(0, 7, n)
    X[rng.random((n, F)) < 0.02] = np.nan
    bounds = [(0, 1900), (1900, 4100), (4100, n)]
    kw = {"max_bins": 32, "categorical_features": (3,), "sample_rows": 2500,
          "seed": 9}
    samples = [X[a:b][_keyed_uniform(a, b - a, 9) < 2500 / n]
               for a, b in bounds]

    def gather(arr):
        return [samples[0], arr, samples[2]]

    a, b = bounds[1]
    got = dd.sketch_distributed(X[a:b], n, a, allgather=gather, **kw)
    want = ref_sketch(X[a:b], n, a, allgather=gather, **kw)
    assert got.to_bytes() == want.to_bytes()
    whole = dd.sketch_distributed(X, n, 0, allgather=lambda s: [s], **kw)
    assert whole.to_bytes() == got.to_bytes()


@pytest.mark.parametrize("arm", ["auto", "fused", "feature"])
def test_hist_reduce_resolved_matches_reference(arm):
    p = Params(hist_reduce=arm)
    rp = ref_params({"hist_reduce": arm})
    for F in (1, 28, 1000, 1024, 2000):
        for B in (16, 256, 257, 1024):
            for n in (1, 2, 4, 8):
                assert (hist_reduce_resolved(p, F, B, n)
                        == ref_resolved(rp, F, B, n)), (F, B, n)


# ---- the sliced scan and the combine, on the reference's grids ---------

def _rand_hist(rng, F, B, scale=100.0):
    """The reference's random grids, rounded to multiples of 1/8 so that
    every prefix sum is exact in fp32 in both packages: the gains are then
    the same fp32 expressions of the same numbers (as in
    ``test_torch_categorical.py``)."""
    h = np.stack([rng.normal(size=(F, B)), rng.uniform(0.1, 1.0, size=(F, B)),
                  rng.uniform(0.5, 2.0, size=(F, B))]) * scale
    return (np.round(h * 8) / 8).astype(np.float32)


def _port_sliced_combine(hist, n, *, is_cat, learn_missing, allow):
    """The feature arm on one candidate, its ranks simulated: the reduced
    histogram cut into n zero-padded slices, each scanned, the packed
    records stacked as the all-gather stacks them, then combined.  Returns
    (combined result, stacked words)."""
    F = hist.shape[1]
    Fs = ed.feature_slice_width(F, n)
    h = torch.from_numpy(hist)[None]
    G, H, C = (torch.tensor([t]) for t in _totals(hist))
    words, cats = [], []
    for r in range(n):
        lo = r * Fs
        sl = torch.zeros((1, 3, Fs, hist.shape[2]))
        sl[:, :, :max(0, min(F, lo + Fs) - lo)] = h[:, :, lo:lo + Fs]
        fmask = torch.arange(lo, lo + Fs) < F
        cat = None
        if is_cat is not None:
            cat = torch.zeros(Fs, dtype=torch.bool)
            cat[:max(0, min(F, lo + Fs) - lo)] = torch.from_numpy(
                is_cat[lo:lo + Fs])
        rec = split.find_best_split_sliced(
            sl, G, H, C, feat_offset=lo, num_features_total=F,
            lambda_l2=1.0, min_child_weight=1e-3, min_data_in_leaf=1,
            feat_mask=fmask, learn_missing=learn_missing, is_cat_feat=cat)
        words.append(split.pack_local_split(rec))
        cats.append(rec["cat_mask"])
    words = torch.stack(words)
    res = split.combine_local_splits(
        words, None if is_cat is None else torch.stack(cats),
        allow=torch.tensor([allow]), min_split_gain=0.0)
    return res, words


def _totals(hist):
    """G, H, C as f32 scalars, one summation for both packages."""
    return tuple(np.float32(hist[k].astype(np.float64).sum())
                 for k in range(3))


_SCAN_STATIC = ("lambda_l2", "min_child_weight", "min_data_in_leaf",
                "has_cat", "learn_missing")
# jitted, as the reference runs them: one compile per shape instead of
# hundreds of eager dispatches
_ref_find = jax.jit(ref_split.find_best_split,
                    static_argnames=_SCAN_STATIC + ("min_split_gain",))
_ref_sliced = jax.jit(
    lambda *a, **k: ref_split.pack_local_split(
        ref_split.find_best_split_sliced(*a, **k)),
    static_argnames=_SCAN_STATIC + ("num_features_total",))


def _ref_fused(hist, *, is_cat, learn_missing, allow):
    hj = jnp.asarray(hist)
    F = hist.shape[1]
    return _ref_find(
        hj, *map(jnp.float32, _totals(hist)), lambda_l2=1.0,
        min_child_weight=1e-3, min_data_in_leaf=1, min_split_gain=0.0,
        feat_mask=jnp.ones((F,), bool),
        is_cat_feat=(jnp.zeros((F,), bool) if is_cat is None
                     else jnp.asarray(is_cat)),
        allow=jnp.bool_(allow), has_cat=is_cat is not None,
        learn_missing=learn_missing)


def _ref_words(hist, n, *, is_cat, learn_missing):
    """The reference's packed records of the same n slices."""
    F = hist.shape[1]
    Fs = -(-F // n)
    pad = Fs * n - F
    hp = jnp.pad(jnp.asarray(hist), ((0, 0), (0, pad), (0, 0)))
    fm = jnp.pad(jnp.ones((F,), bool), (0, pad))
    ic = jnp.pad(jnp.zeros((F,), bool) if is_cat is None
                 else jnp.asarray(is_cat), (0, pad))
    G, H, C = map(jnp.float32, _totals(hist))
    out = []
    for r in range(n):
        lo, hi = r * Fs, (r + 1) * Fs
        out.append(np.asarray(_ref_sliced(
            hp[:, lo:hi], G, H, C, feat_offset=jnp.int32(lo),
            num_features_total=F, lambda_l2=1.0, min_child_weight=1e-3,
            min_data_in_leaf=1, feat_mask=fm[lo:hi], is_cat_feat=ic[lo:hi],
            has_cat=is_cat is not None, learn_missing=learn_missing)))
    return np.stack(out)


def _check(hist, n, *, is_cat=None, learn_missing=False, allow=True):
    got, words = _port_sliced_combine(hist, n, is_cat=is_cat,
                                      learn_missing=learn_missing,
                                      allow=allow)
    want = _ref_fused(hist, is_cat=is_cat, learn_missing=learn_missing,
                      allow=allow)
    for k in ("gain", "feature", "threshold", "g_left", "h_left", "c_left",
              "default_left"):
        np.testing.assert_array_equal(got[k][0].numpy(),
                                      np.asarray(getattr(want, k)),
                                      err_msg=f"{k} n={n}")
    if is_cat is not None:
        np.testing.assert_array_equal(got["cat_mask"][0].numpy(),
                                      np.asarray(want.cat_mask))
    else:
        assert not got["cat_mask"].any()
    np.testing.assert_array_equal(
        words[:, 0].numpy().view(np.uint32),
        _ref_words(hist, n, is_cat=is_cat, learn_missing=learn_missing))
    # and the port's own fused scan picks the same record
    h = torch.from_numpy(hist)[None]
    fused = split.find_best_split(
        h, *(torch.tensor([t]) for t in _totals(hist)), lambda_l2=1.0,
        min_child_weight=1e-3, min_data_in_leaf=1, min_split_gain=0.0,
        feat_mask=torch.ones(hist.shape[1], dtype=torch.bool),
        allow=torch.tensor([allow]), learn_missing=learn_missing,
        is_cat_feat=None if is_cat is None else torch.from_numpy(is_cat))
    for k in fused:
        assert torch.equal(fused[k], got[k]), k


@pytest.mark.parametrize("F,B", [(28, 32), (10, 16), (5, 8)])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_combine_matches_fused_on_random_grids(F, B, n):
    _check(_rand_hist(np.random.default_rng(5 + F), F, B), n)


@pytest.mark.parametrize("f_lo,f_hi", [(1, 9), (0, 15), (3, 12), (7, 8)])
def test_combine_tie_breaks_feature_major(f_lo, f_hi):
    """Two bitwise-equal feature rows in different slices: the fused
    first-max takes the lower feature, and so must the combine."""
    F, B = 16, 8
    h = _rand_hist(np.random.default_rng(7), F, B)
    h[:, f_hi] = h[:, f_lo]
    h[0, f_lo] *= 50.0
    h[0, f_hi] = h[0, f_lo]
    assert int(_ref_fused(h, is_cat=None, learn_missing=False,
                          allow=True).feature) == f_lo
    for n in (2, 4, 8):
        _check(h, n)


def test_combine_tie_breaks_plane_major_with_learn_missing():
    """No missing stats: both planes tie, and a missing-right candidate in
    a low slice must lose to a missing-left one in a high slice."""
    h = _rand_hist(np.random.default_rng(11), 12, 8)
    h[:, :, 0] = 0.0
    assert bool(_ref_fused(h, is_cat=None, learn_missing=True,
                           allow=True).default_left)
    for n in (1, 2, 4):
        _check(h, n, learn_missing=True)


def test_combine_categorical_winner_carries_its_set():
    h = _rand_hist(np.random.default_rng(13), 8, 16)
    is_cat = np.arange(8) % 2 == 1
    for n in (1, 2, 4):
        _check(h, n, is_cat=is_cat)


@pytest.mark.parametrize("allow", [True, False])
def test_combine_all_invalid_gives_fused_defaults(allow):
    h = np.zeros((3, 8, 8), np.float32)
    for n in (1, 4):
        _check(h, n, allow=allow)


# ---- the reduce= hook of the kernels' plain versions -------------------

def _rows(n=2500, F=6, B=32, P=5, seed=1):
    rng = np.random.default_rng(seed)
    Xb = torch.from_numpy(rng.integers(0, B, (n, F)).astype(np.uint8))
    g = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    h = torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32))
    sel = torch.from_numpy(rng.integers(0, P + 1, n))
    return Xb, g, h, sel


def test_reduce_hook_identity_is_the_fused_conversion():
    """K1 row mode (directly and through ``build_hist_segmented``), K1
    layout mode and K3 through an identity ``reduce`` give the bits of
    their own conversion."""
    Xb, g, h, sel = _rows()
    F, B, P = Xb.shape[1], 32, 5
    shift = hist.fixed_point_shift(g, h)
    seen = []

    def ident(acc):
        assert acc.dtype == torch.int64 and acc.shape == (P, 3, F, B)
        seen.append(1)
        return acc

    from dryad_tpu_torch.engine import leafperm
    want = build_hist_segmented(Xb, g, h, sel, P, B, shift)
    assert torch.equal(build_hist_segmented(
        Xb, g, h, sel, P, B, shift, reduce=ident), want)
    got_rows = hist.hist_rows_plain(*_rows_plan(Xb, g, h, sel, P), P, B, F,
                                    1, shift, ident)
    assert torch.equal(got_rows, want)
    xt = hist_nat.natural_tiles(Xb)
    assert torch.equal(hist_nat.build_hist_small(xt, g, h, sel, P, B, F,
                                                 shift, reduce=ident), want)
    rec_nat = leafperm.make_layout_records(Xb, g, h).numpy()
    rec, lt, base = grouped_layout(rec_nat, sel.numpy(), P)
    got_lay = leafperm.hist_from_layout(
        torch.from_numpy(rec), torch.from_numpy(base[:-1]),
        torch.from_numpy(lt), P, B, F, 1, int(lt.sum()), shift)
    assert torch.equal(got_lay, want)
    src = torch.arange(rec.shape[0] // 512)
    tl = torch.from_numpy(np.repeat(np.arange(P), lt))
    assert torch.equal(hist.hist_tiles(torch.from_numpy(rec), src, tl, P, B,
                                       F, 1, shift, reduce=ident), want)
    assert len(seen) == 4


def _rows_plan(Xb, g, h, sel, P):
    from dryad_tpu_torch.engine import tile_plan
    recs = tile_plan.make_records(Xb, g, h)
    buf, tile_leaf, _ = tile_plan.tile_plan(sel, Xb.shape[0], P)
    return recs, buf, tile_leaf


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A gloo process group of this process alone."""
    store = tmp_path_factory.mktemp("pg") / "store"
    dd.initialize(backend="gloo", init_method=f"file://{store}", rank=0,
                  world_size=1, timeout_s=60)
    yield
    tdist.destroy_process_group()


def test_feature_slice_of_one_rank_is_the_whole(one_rank):
    grp = ed.RowGroup.build(100, device=torch.device("cpu"))
    assert (grp.rank, grp.world, grp.row_offset, grp.global_rows) == \
        (0, 1, 0, 100)
    acc = torch.arange(2 * 3 * 5 * 4, dtype=torch.int64).view(2, 3, 5, 4)
    assert torch.equal(ed.reduce_hist(acc.clone(), grp, "feature"), acc)
    assert torch.equal(ed.reduce_hist(acc.clone(), grp, "fused"), acc)
    assert grp.stats["hist"] == {"calls": 2,
                                 "reduce_scatter_bytes": acc.numel() * 8,
                                 "all_reduce_bytes": acc.numel() * 8}


def test_feature_shard_slice_pads_the_tail():
    class G:
        world, rank = 3, 2
    a = torch.arange(7)
    assert ed.feature_slice_width(7, 3) == 3
    assert ed.feature_shard_slice(a, G).tolist() == [6, 0, 0]
    G.rank = 1
    assert ed.feature_shard_slice(a, G).tolist() == [3, 4, 5]
    assert ed.feature_shard_offset(G, 7) == 3


def test_group_bag_is_the_slice_of_the_whole_bag():
    p = Params(subsample=0.6, colsample=0.5, seed=3)
    full, fm = sample_masks(p, 4, 1000, 12)
    part, fm2 = sample_masks(p, 4, 1000, 12, (300, 650))
    np.testing.assert_array_equal(part, full[300:650])
    np.testing.assert_array_equal(fm, fm2)


def test_host_row_range_partitions_in_rank_order():
    for n, w in ((10, 3), (4099, 2), (5, 8), (0, 2)):
        spans = [dd.host_row_range(n, r, w) for r in range(w)]
        assert spans[0][0] == 0 and spans[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        assert max(b - a for a, b in spans) - min(b - a for a, b in spans) \
            <= 1


def test_one_rank_train_distributed_matches_reference(one_rank):
    """The reference's tie-free fixture (tests/test_hist_reduce.py): the
    port's 1-rank group against ``dryad_tpu``'s ``train_device``."""
    import dryad_tpu
    from dryad_tpu.datasets import higgs_like
    from dryad_tpu.engine.train import train_device

    X, y = higgs_like(4096)
    base = dict(objective="binary", num_trees=3, num_leaves=15, max_depth=4,
                growth="depthwise", max_bins=64, learning_rate=0.2)
    want = train_device(ref_params(base), dryad_tpu.Dataset(X, y,
                                                            max_bins=64))
    ds = dt.Dataset(X, y, max_bins=64)
    for arm in ("fused", "feature"):
        got = dd.train_distributed(dict(base, hist_reduce=arm), ds,
                                   device="cpu")
        ra, ga = want.tree_arrays(), got.to_reference_arrays()
        for k in ("feature", "threshold", "left", "right", "default_left"):
            np.testing.assert_array_equal(ga[k], np.asarray(ra[k]),
                                          err_msg=f"{arm}: {k}")
        np.testing.assert_allclose(ga["value"], np.asarray(ra["value"]),
                                   rtol=1e-5, atol=1e-6)
        # and bit for bit the same port without a group
        plain = dt.train(base, ds, device="cpu")
        for k, v in plain.tree_arrays().items():
            np.testing.assert_array_equal(got.tree_arrays()[k], v)


def test_entry_points_refuse_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dd.initialize()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dd.train_distributed({}, None)
