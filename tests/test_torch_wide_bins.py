"""The grower's full reach in the port: arm A1 (the plain torch histogram
arm past K1's bins cap and under ``hist_backend="xla"``), the unpacked
routing past the packed word (bins above 8192, leaf budgets of 65536 and
more), and the four reference params the port once refused.

Held against:
* K1's plain version (``hist.hist_rows_plain`` / ``hist_tiles_plain``
  through the histogram entry points), bit for bit: both sum the tree's
  fixed point, and integer sums do not depend on the order or the chunks;
* the reference's XLA ``build_hist`` at 2048 bins: counts exact, g/h
  within rtol 1e-5 / atol 1e-4 (its f32 one-hot products against the
  port's fixed point);
* the reference's CPU trainer (``backend="cpu"``) on tie-free fixtures:
  integer tree arrays and covers equal, leaf values within 1e-4 (f64 sums
  against the port's fixed point);
* the port's own packed route, bit for bit, where the unpacked route is
  forced at a small budget.
"""

import numpy as np
import pytest
import torch

import dryad_tpu
from dryad_tpu.engine.histogram import build_hist as j_build_hist

import dryad_tpu_torch as dt
from dryad_tpu_torch import datasets as tdatasets
from dryad_tpu_torch.config import Params as TParams
from dryad_tpu_torch.engine import hist, hist_nat, histogram, leafperm
from dryad_tpu_torch.engine import leafwise_fast as tlf
from dryad_tpu_torch.engine import levelwise as tlw
from torch_layout import one_torch_thread  # noqa: F401 (autouse)

INT_KEYS = ("feature", "threshold", "left", "right", "default_left")


def _inputs(seed, N, F, B):
    rng = np.random.default_rng(seed)
    dtype = np.uint8 if B <= 256 else np.int32
    Xb = torch.from_numpy(rng.integers(0, B, (N, F)).astype(dtype))
    g = torch.from_numpy(rng.normal(size=N).astype(np.float32))
    h = torch.from_numpy(rng.uniform(0.05, 0.25, N).astype(np.float32))
    return rng, Xb, g, h


# ---- arm A1 -----------------------------------------------------------------

@pytest.mark.parametrize("B", [64, 256, 1024])
def test_a1_is_k1_plain_bitwise(B):
    N, F, P = 1500, 8, 5
    rng, Xb, g, h = _inputs(B, N, F, B)
    shift = hist.fixed_point_shift(g, h)
    mask = torch.from_numpy(rng.random(N) < 0.7)
    sel = torch.from_numpy(rng.integers(0, P + 1, N))     # P drops the row
    isz = leafperm.bin_itemsize(Xb)
    lay = leafperm.make_layout_records(Xb, g, h, valid=mask)
    root_k1 = histogram.build_hist(Xb, g, h, mask, B, shift)
    assert torch.equal(root_k1, histogram.build_hist(
        Xb, g, h, mask, B, shift, layout=lay))
    seg_k1 = histogram.build_hist_segmented(Xb, g, h, sel, P, B, shift)
    multi_k1 = histogram.build_hist_multi(Xb, g, h, sel, P, B, shift)
    assert isz in (1, 2)
    for rows in (1, 97, 512, 65536):
        assert torch.equal(histogram.build_hist(
            Xb, g, h, mask, B, shift, a1_rows=rows), root_k1)
        assert torch.equal(histogram.build_hist_segmented(
            Xb, g, h, sel, P, B, shift, a1_rows=rows), seg_k1)
        assert torch.equal(histogram.build_hist_multi(
            Xb, g, h, sel, P, B, shift, a1_rows=rows), multi_k1)
    # every leaf in [0, P) is written, an empty one zero
    assert torch.equal(histogram.build_hist_segmented(
        Xb, g, h, torch.full((N,), P), P, B, shift, a1_rows=100),
        torch.zeros((P, 3, F, B)))


def test_a1_reduce_hook_and_empty_rows():
    N, F, B = 700, 5, 2000
    _, Xb, g, h = _inputs(7, N, F, B)
    shift = hist.fixed_point_shift(g, h)
    sel = torch.zeros(N, dtype=torch.int64)
    seen = []

    def reduce(acc):
        seen.append((acc.dtype, tuple(acc.shape)))
        return acc * 2

    two = histogram.build_hist_a1(Xb, g, h, sel, 1, B, shift,
                                  rows_per_chunk=256, reduce=reduce)
    one = histogram.build_hist_a1(Xb, g, h, sel, 1, B, shift,
                                  rows_per_chunk=256)
    assert seen == [(torch.int64, (1, 3, F, B))]
    assert torch.equal(two[:, 2], 2 * one[:, 2])
    empty = histogram.build_hist_a1(Xb[:0], g[:0], h[:0], sel[:0], 3, B,
                                    shift, rows_per_chunk=256)
    assert torch.equal(empty, torch.zeros((3, 3, F, B)))


def test_a1_matches_reference_xla_at_2048_bins():
    N, F, B = 4000, 6, 2048
    rng, Xb, g, h = _inputs(11, N, F, B)
    mask = rng.random(N) < 0.8
    got = histogram.build_hist(Xb, g, h, torch.from_numpy(mask), B,
                               hist.fixed_point_shift(g, h),
                               a1_rows=1000).numpy()
    ref = np.asarray(j_build_hist(Xb.numpy(), g.numpy(), h.numpy(), mask, B,
                                  rows_per_chunk=1000, backend="xla"))
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_allclose(got[:2], ref[:2], rtol=1e-5, atol=1e-4)


def test_natural_tiles_gate_past_the_cap():
    Xb = torch.zeros((600, 3), dtype=torch.int32)
    assert hist_nat.maybe_natural_tiles(Xb, 2048) is None
    assert hist_nat.maybe_natural_tiles(Xb, 1024) is not None


def test_a1_rows_policy():
    assert histogram.a1_rows(TParams(), 256) is None
    assert histogram.a1_rows(TParams(hist_backend="pallas"), 1024) is None
    assert histogram.a1_rows(TParams(), 1025) == 65536
    assert histogram.a1_rows(TParams(hist_backend="xla"), 64) == 65536
    assert histogram.a1_rows(TParams(hist_backend="xla",
                                     rows_per_chunk=-3), 64) == 1


# ---- wide bins against the reference's CPU trainer --------------------------

def _train_both(X, y, params, n_train=None):
    n = n_train or X.shape[0]
    tds = dt.Dataset(X[:n], y[:n], max_bins=params["max_bins"])
    jds = dryad_tpu.Dataset(X[:n], y[:n], max_bins=params["max_bins"])
    np.testing.assert_array_equal(tds.X_binned, jds.X_binned)
    tb = dt.train(params, tds, device="cpu")
    jb = dryad_tpu.train(params, jds, backend="cpu")
    got, want = tb.to_reference_arrays(), jb.tree_arrays()
    for k in INT_KEYS:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    np.testing.assert_array_equal(got["cover"], want["cover"])
    np.testing.assert_allclose(got["value"], want["value"], atol=1e-4)
    return tb, tds


@pytest.mark.parametrize("max_bins,rows,seed,params", [
    # tests/test_wide_bins.py's two fixtures
    (512, 4000, 97, dict(num_trees=5, num_leaves=15, growth="depthwise",
                         max_depth=4)),
    (2048, 2000, 93, dict(num_trees=3, num_leaves=7, growth="depthwise",
                          max_depth=3)),
    # the batched leaf-wise grower past the cap
    (2048, 2000, 93, dict(num_trees=3, num_leaves=7, growth="leafwise",
                          max_depth=3)),
])
def test_wide_bins_match_reference_cpu_trainer(max_bins, rows, seed,
                                               params):
    X, y = tdatasets.higgs_like(rows, seed=seed)
    p = dict(objective="binary", max_bins=max_bins, **params)
    tb, tds = _train_both(X, y, p)
    assert tds.X_binned.dtype == np.uint16
    assert tds.mapper.total_bins > hist.MAX_BINS or max_bins == 512
    # card-free bitwise predict on the binned rows (CPU traversal)
    raw = tb.predict_binned(tds.X_binned, raw_score=True, device="cpu")
    assert np.isfinite(raw).all()


@pytest.mark.parametrize("growth", ["depthwise", "leafwise"])
def test_bins_past_the_packed_word(growth, monkeypatch):
    """Past 8192 bins: the unpacked route on both growers."""
    seen = []
    real = tlw.gather_left

    def spy(*a, **k):
        seen.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tlw, "gather_left", spy)
    monkeypatch.setattr(tlf, "gather_left", spy)
    X, y = tdatasets.higgs_like(20000, seed=5)
    X = X[:, :4]
    p = dict(objective="binary", max_bins=16384, num_trees=2, num_leaves=7,
             growth=growth, max_depth=3, min_data_in_leaf=50)
    _, tds = _train_both(X, y, p)
    assert tds.mapper.total_bins > tlw.MAX_PACKED_BINS
    assert seen


def test_leaf_budget_65536_matches_reference_cpu_trainer(monkeypatch):
    """Depth 16, 65536 leaves: the levelwise grower's unpacked route, its
    passes on arm A1 (K1's plain version reads a 512-row tile a slot, 16M
    rows a level at P = 32768, too slow on the CPU; the routing is the
    same on either arm, and the chip runs it through K1)."""
    seen = []
    real = tlw.gather_left
    monkeypatch.setattr(tlw, "gather_left",
                        lambda *a, **k: seen.append(1) or real(*a, **k))
    rng = np.random.default_rng(17)
    X = rng.normal(size=(3000, 4)).astype(np.float32)
    y = (X[:, 0] + 0.6 * X[:, 1] * X[:, 2] + 0.4 * rng.normal(size=3000)
         > 0).astype(np.float32)
    p = dict(objective="binary", max_bins=16, num_trees=2,
             num_leaves=65536, growth="depthwise", max_depth=16,
             min_data_in_leaf=100, learning_rate=0.3, hist_backend="xla")
    tb, _ = _train_both(X, y, p)
    assert tb.params.effective_num_leaves == 65536 and seen


def _grow_pair(monkeypatch, forced: dict, grow, p, B, Xb, g, h, **kw):
    """One tree on the packed route, then with ``forced`` patched into
    ``levelwise`` (the unpacked route): bitwise equal."""
    N, F = Xb.shape
    args = (p, B, Xb, g, h, torch.ones(N, dtype=torch.bool),
            torch.ones(F, dtype=torch.bool))
    packed = grow(*args, **kw)
    for name, value in forced.items():
        monkeypatch.setattr(tlw, name, value)
    unpacked = grow(*args, **kw)
    monkeypatch.undo()
    for k in ("feature", "threshold", "left", "right", "default_left",
              "value", "gain", "cover", "row_leaf"):
        assert torch.equal(packed[k], unpacked[k]), k
    return packed


@pytest.mark.parametrize("learn_missing", [False, True])
def test_unpacked_route_equals_packed_levelwise(monkeypatch, learn_missing):
    N, F, B = 3000, 6, 32
    _, Xb, g, h = _inputs(23, N, F, B)
    p = TParams(growth="depthwise", max_depth=5, num_leaves=24, max_bins=B,
                deep_layout="legacy", min_data_in_leaf=10)
    seen = []
    real = tlw.gather_left
    tree = _grow_pair(
        monkeypatch, {"MAX_PACKED_LEAVES": 8,
                      "gather_left": lambda *a, **k: seen.append(1)
                      or real(*a, **k)},
        tlw.grow_tree_levelwise, p, B, Xb, g, h,
        learn_missing=learn_missing)
    assert seen and int((tree["feature"] >= 0).sum()) > 10


def test_unpacked_route_equals_packed_categorical(monkeypatch):
    N, F, B = 3000, 5, 16
    rng, Xb, g, h = _inputs(29, N, F, B)
    g = g + torch.from_numpy(np.where(Xb[:, 0].numpy() % 3 == 0, 1.0,
                                      -0.5).astype(np.float32))
    is_cat = torch.tensor([True, False, False, True, False])
    p = TParams(growth="depthwise", max_depth=4, num_leaves=16, max_bins=B,
                deep_layout="legacy", min_data_in_leaf=10)
    tree = _grow_pair(monkeypatch, {"MAX_PACKED_LEAVES": 8},
                      tlw.grow_tree_levelwise, p, B, Xb, g, h,
                      is_cat_feat=is_cat)
    assert bool(tree["is_cat"].any())


def test_unpacked_route_equals_packed_leafwise(monkeypatch):
    N, F, B = 3000, 6, 32
    _, Xb, g, h = _inputs(31, N, F, B)
    p = TParams(growth="leafwise", max_depth=5, num_leaves=20, max_bins=B,
                min_data_in_leaf=10, deep_layout="legacy")
    _grow_pair(monkeypatch, {"MAX_PACKED_BINS": 8},
               tlf.grow_tree_leafwise_batched, p, B, Xb, g, h,
               learn_missing=True)


# ---- the four params --------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    X, y = tdatasets.higgs_like(1200, seed=41)
    return dt.Dataset(X, y, max_bins=32)


BASE = dict(objective="binary", num_trees=2, num_leaves=7,
            growth="depthwise", max_depth=3, max_bins=32, seed=3)


def _same(a, b):
    ta, tb = a.tree_arrays(), b.tree_arrays()
    for k in ("feature", "threshold", "left", "right", "default_left",
              "value", "cover", "gain"):
        np.testing.assert_array_equal(ta[k], tb[k], err_msg=k)


@pytest.mark.parametrize("key,values", [
    ("hist_backend", ("auto", "xla", "pallas")),
    ("hist_precision", ("exact", "fast")),
    ("rows_per_chunk", (65536, 97, 1, 0)),
    ("deterministic", (True, False)),
])
def test_the_four_params_accept_every_legal_value(small, key, values):
    """Every legal value trains, each to the default's trees bit for bit:
    arm A1 (xla) sums the kernels' fixed point, "fast" is a no-op, the
    row chunk changes no bit, ``deterministic`` is never read."""
    ref = dt.train(BASE, small, device="cpu")
    for v in values:
        p = dt.Params.from_dict(dict(BASE, **{key: v}))
        assert getattr(p, key) == v
        _same(ref, dt.train(dict(BASE, **{key: v}), small, device="cpu"))


def test_hist_backend_xla_takes_arm_a1(small, monkeypatch):
    calls = []
    real = histogram.build_hist_a1
    monkeypatch.setattr(histogram, "build_hist_a1",
                        lambda *a, **k: calls.append(k["rows_per_chunk"])
                        or real(*a, **k))
    p = TParams(**{k: v for k, v in BASE.items() if k != "num_trees"},
                hist_backend="xla", rows_per_chunk=500)
    assert not tlw.deep_layout_supported(p, 28, 32, 1)
    dt.train(dict(BASE, hist_backend="xla", rows_per_chunk=500), small,
             device="cpu")
    assert calls and set(calls) == {500}


@pytest.mark.parametrize("key,bad,match", [
    ("hist_backend", "cuda", "hist_backend must be auto|xla|pallas"),
    ("hist_precision", "half", "hist_precision must be exact|fast"),
])
def test_illegal_values_raise(key, bad, match):
    """The reference's checks and messages; ``ch_max`` stays left out."""
    for params in (dt.Params, dryad_tpu.Params):
        with pytest.raises(ValueError, match=match):
            params.from_dict(dict(BASE, **{key: bad}))
    with pytest.raises(ValueError, match="outside this slice"):
        dt.Params.from_dict(dict(BASE, ch_max=2))


def test_reference_params_dict_loads():
    """A params dict the reference writes (every field) loads in the port,
    the four params included."""
    ref = dryad_tpu.Params.from_dict(dict(BASE, hist_backend="xla",
                                          hist_precision="fast",
                                          rows_per_chunk=1000,
                                          deterministic=False))
    p = dt.Params.from_reference_dict(ref.to_dict())
    assert (p.hist_backend, p.hist_precision, p.rows_per_chunk,
            p.deterministic) == ("xla", "fast", 1000, False)
    assert dryad_tpu.Params.from_dict(
        {k: v for k, v in p.to_dict().items()}).hist_backend == "xla"
