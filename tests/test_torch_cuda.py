"""The port's CUDA kernels on the card against their plain versions.

Marked ``cuda``: each test needs an NVIDIA GPU and skips without one (a
CUDA kernel has no CPU mode).  This file imports neither jax nor
dryad_tpu, so it also runs on a machine that has only the port installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: K1 (both modes) and K3 equal their plain versions bitwise,
counts and g/h (both are exact fixed-point integer sums in one shift,
rounded once); each kernel twice and K2 against the numpy oracle bitwise;
K1's two modes and K3 bitwise equal on the same rows; a tree grown on the
card vs on the CPU, depthwise or leaf-wise, on either arm: integer arrays
(row_leaf included) equal and leaf values within 1e-4 (the split scan's
fp32 prefix sums may round differently on the two devices); categorical
trees on the card bitwise run to run, their routing equal to predict's,
and the scan's stable order equal to the CPU's; categorical training on
the reference's tie-free fixtures, and bagged and multiclass training, on
the card vs the CPU as each test states; GOSS's uniforms and selection on
the card bitwise equal to the CPU's, and GOSS, monotone, DART and rf
training on the card vs the CPU as their test states; the model API
(pred_leaf, the SoA traversal, TreeSHAP, refit, cv) on the card vs the
CPU as its test states; the serving stack (CUDA graphs per bucket) bitwise
equal to the direct card and CPU predicts, no capture after warmup, and
evictions and unloads lowering ``torch.cuda.memory_allocated``; K1 (both
modes) and K3 through the accumulate-only launch (``reduce=``, what a
process group's reduction runs between launch and conversion) bitwise
the full launch; two gloo ranks sharing the card grow bitwise the trees
of one process, on both reduction arms, and so do GOSS and the l1
renewal; predict split over two blocks on the card, and the serving
cache's sharded family, bitwise the single-device answer; a streamed set's chunk by chunk
device assembly and its trees bitwise the resident set's; arm A1 on the
card bitwise the CPU and K1; the unpacked routing on the card as the
other card-vs-CPU tree tests.
"""

import numpy as np
import pytest
import torch

from dryad_tpu_torch import datasets
from dryad_tpu_torch.config import Params
from dryad_tpu_torch.dataset import Dataset
from dryad_tpu_torch.engine import hist, hist_nat, leafperm, tile_plan
from dryad_tpu_torch.engine.leafwise_fast import (
    grow_tree_leafwise_batched,
    leafwise_layout_supported,
)
from dryad_tpu_torch.engine.levelwise import grow_tree_levelwise
from dryad_tpu_torch.objectives import Binary
from torch_layout import grouped_layout
from torch_layout import one_torch_thread  # noqa: F401 (autouse)

T = leafperm.TILE_ROWS


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _grouped_layout(rng, N, F, B, S):
    Xb = rng.integers(0, B, (N, F)).astype(np.uint8)
    g = rng.normal(size=N).astype(np.float32)
    h = rng.uniform(0.1, 1, N).astype(np.float32)
    rec_nat = leafperm.make_layout_records(
        torch.from_numpy(Xb), torch.from_numpy(g), torch.from_numpy(h)).numpy()
    rec, lt, base = grouped_layout(rec_nat, rng.integers(0, S, N), S)
    return rec, lt, base, hist.fixed_point_shift(torch.from_numpy(g),
                                                 torch.from_numpy(h))


@pytest.mark.cuda
@pytest.mark.parametrize("F,B", [(28, 256), (5, 1024)])
def test_hist_kernel_matches_plain(cuda_device, F, B):
    rng = np.random.default_rng(F)
    rec, lt, base, shift = _grouped_layout(rng, 20000, F, B, 6)
    seg_first = torch.tensor([int(base[5]), 0, int(base[2])])
    seg_nt = torch.tensor([int(lt[5]), 0, int(lt[2])])
    n_sel = int(lt[5] + lt[2]) + 1
    rec_t = torch.from_numpy(rec)
    args = (3, B, F, 1, n_sel)
    a = leafperm.hist_from_layout(rec_t.to(cuda_device),
                                  seg_first.to(cuda_device),
                                  seg_nt.to(cuda_device), *args,
                                  shift.to(cuda_device))
    b = leafperm.hist_from_layout(rec_t.to(cuda_device),
                                  seg_first.to(cuda_device),
                                  seg_nt.to(cuda_device), *args,
                                  shift.to(cuda_device))
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    plain = leafperm.hist_from_layout(rec_t, seg_first, seg_nt, *args, shift)
    got = a.cpu()
    assert torch.equal(got, plain)
    assert not got[1].any()                     # empty selection zeroed


@pytest.mark.cuda
def test_perm_kernel_matches_oracle(cuda_device):
    rng = np.random.default_rng(5)
    counts = [3000, 17, 2500, 0]
    lt = np.maximum(-(-np.asarray(counts) // T), 1)
    tile_slot = np.repeat(np.arange(len(counts)), lt).astype(np.int64)
    rec = np.zeros((lt.sum() * T, leafperm.REC_WB), np.uint8)
    side = np.full(lt.sum() * T, 2, np.int64)
    base = np.concatenate([[0], np.cumsum(lt)])
    for s, c in enumerate(counts):
        rec[base[s] * T: base[s] * T + c] = rng.integers(1, 255, (c, 128))
        side[base[s] * T: base[s] * T + c] = rng.random(c) < 0.45
    pos, dstl, dstr, _, _, _ = leafperm.level_moves(
        torch.from_numpy(tile_slot).to(cuda_device),
        torch.from_numpy(side).to(cuda_device), len(counts))
    bound = leafperm.tiles_bound(rec.shape[0], len(counts))
    got = leafperm.permute_records(torch.from_numpy(rec).to(cuda_device),
                                   pos, dstl, dstr, bound)
    oracle, _, _ = leafperm.permute_records_np(rec, tile_slot, side,
                                               len(counts), bound)
    np.testing.assert_array_equal(got.cpu().numpy(), oracle)


def _twice_and_plain(fn, args_card, args_cpu):
    a = fn(*args_card)
    b = fn(*args_card)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    plain = fn(*args_cpu)
    got = a.cpu()
    assert torch.equal(got, plain)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("F,B,P,isz", [(28, 256, 16, 1), (28, 256, 5, 1),
                                       (6, 1024, 16, 2), (300, 64, 3, 1)])
def test_nat_kernel_matches_plain(cuda_device, F, B, P, isz):
    rng = np.random.default_rng(F + P)
    N = 40_000 + 77                                # a padded tail
    Xb = rng.integers(0, B, (N, F)).astype(np.int32 if isz == 2 else np.uint8)
    g = torch.from_numpy(rng.normal(size=N).astype(np.float32))
    h = torch.from_numpy(rng.uniform(0.1, 1, N).astype(np.float32))
    sel = rng.integers(0, P + 1, N).astype(np.int32)
    sel[sel == 1] = 0                              # slot 1 empty
    sel[::11] = hist_nat.NAT_DROP
    nat = hist_nat.natural_tiles(torch.from_numpy(Xb))
    sel = torch.from_numpy(sel)
    shift = hist.fixed_point_shift(g, h)

    def run(nt, gg, hh, ss, sh):
        return hist_nat.build_hist_nat(nt, gg, hh, ss, sh, total_bins=B,
                                       num_features=F, num_cols=P)

    got = _twice_and_plain(
        run, [t.to(cuda_device) for t in (nat, g, h, sel, shift)],
        (nat, g, h, sel, shift))
    if P > 1:
        assert not got[1].any()


@pytest.mark.cuda
@pytest.mark.parametrize("F,B,isz,aligned", [(2000, 256, 1, True),
                                             (28, 256, 1, False),
                                             (130, 300, 2, True)])
def test_hist_rows_kernel_matches_plain(cuda_device, F, B, isz, aligned):
    rng = np.random.default_rng(F)
    N, P = 20_000, 5
    Xb = torch.from_numpy(rng.integers(0, B, (N, F)).astype(
        np.int32 if isz == 2 else np.uint8))
    g = torch.from_numpy(rng.normal(size=N).astype(np.float32))
    h = torch.from_numpy(rng.uniform(0.1, 1, N).astype(np.float32))
    sel_np = rng.integers(0, P + 1, N)
    sel_np[sel_np == 2] = 0                        # slot 2 empty
    sel = torch.from_numpy(sel_np)
    counts = torch.bincount(sel[sel < P], minlength=P)[:P]
    if aligned:
        buf, tl, _ = tile_plan.tile_plan_aligned(sel, counts, N, P)
    else:
        buf, tl, _ = tile_plan.tile_plan(sel, N, P)
    rec = tile_plan.make_records(Xb, g, h)
    shift = hist.fixed_point_shift(g, h)

    def run(r, b, t, s):
        return hist.hist_rows(r, b, t, P, B, F, isz, s)

    got = _twice_and_plain(
        run, [t.to(cuda_device) for t in (rec, buf, tl, shift)],
        (rec, buf, tl, shift))
    assert not got[2].any()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["auto", "legacy"])
def test_tree_on_card_matches_cpu(cuda_device, layout):
    rng = np.random.default_rng(9)
    N, F, B = 30000, 8, 64
    Xb = rng.integers(1, B, (N, F)).astype(np.uint8)
    y = (rng.random(N) < 1 / (1 + np.exp(-(Xb[:, 0] / B - 0.5) * 4)))
    g = (0.5 - y).astype(np.float32) + rng.normal(0, 0.01, N).astype(np.float32)
    h = np.full(N, 0.25, np.float32)
    p = Params(growth="depthwise", max_depth=6, num_leaves=40, max_bins=B,
               deep_layout=layout)
    out = {}
    for dev in ("cpu", cuda_device):
        out[str(dev)] = grow_tree_levelwise(
            p, B, torch.from_numpy(Xb).to(dev), torch.from_numpy(g).to(dev),
            torch.from_numpy(h).to(dev), torch.ones(N, dtype=torch.bool,
                                                    device=dev),
            torch.ones(F, dtype=torch.bool, device=dev))
    cpu, card = out["cpu"], out[str(cuda_device)]
    for k in ("feature", "threshold", "left", "right", "default_left",
              "row_leaf", "cover"):
        np.testing.assert_array_equal(card[k].cpu().numpy(), cpu[k].numpy(),
                                      err_msg=k)
    np.testing.assert_allclose(card["value"].cpu().numpy(),
                               cpu["value"].numpy(), atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["auto", "legacy"])
def test_leafwise_tree_on_card_matches_cpu(cuda_device, layout):
    """The leaf-wise fixture (50k Higgs-like rows, 64 bins, 128 leaves,
    depth 8): the batched grower's first tree on the card equals the CPU
    tree, on the wired arm (K1 layout mode, K2 under heap-node runs) and
    the legacy arm (K3, K1 row mode)."""
    X, y = datasets.higgs_like(50_000, seed=43)
    ds = Dataset(X, y, max_bins=64)
    B, F = ds.mapper.total_bins, ds.num_features
    p = Params(growth="leafwise", max_depth=8, num_leaves=128, max_bins=64,
               deep_layout=layout)
    assert leafwise_layout_supported(p, F, B, 1) == (layout == "auto")
    yt = torch.from_numpy(ds.y)
    score = torch.full_like(yt, float(Binary().init_score(ds.y)))
    g, h = Binary().grad_hess(score, yt)
    out = {}
    for dev in ("cpu", cuda_device):
        out[str(dev)] = grow_tree_leafwise_batched(
            p, B, torch.from_numpy(ds.X_binned).to(dev), g.to(dev),
            h.to(dev), torch.ones(ds.num_rows, dtype=torch.bool, device=dev),
            torch.ones(F, dtype=torch.bool, device=dev))
    cpu, card = out["cpu"], out[str(cuda_device)]
    for k in ("feature", "threshold", "left", "right", "default_left",
              "row_leaf", "cover", "max_depth"):
        np.testing.assert_array_equal(card[k].cpu().numpy(), cpu[k].numpy(),
                                      err_msg=k)
    np.testing.assert_allclose(card["value"].cpu().numpy(),
                               cpu["value"].numpy(), atol=1e-4)
    assert int((cpu["feature"] >= 0).sum()) == 127


@pytest.mark.cuda
def test_categorical_order_on_card_matches_cpu(cuda_device):
    """The sorted-subset scan's order: a stable argsort along the bins of
    (K, F, B) fp32 ratios with exact ties and ``+inf`` (empty bins) gives
    the CPU's order on the card, the lower bin first in a tie."""
    rng = np.random.default_rng(8)
    ratio = rng.integers(-6, 7, (64, 39, 256)).astype(np.float32) / 4
    ratio[rng.random(ratio.shape) < 0.3] = np.inf
    r = torch.from_numpy(ratio)
    cpu = torch.argsort(r, dim=2, stable=True)
    for _ in range(2):
        card = torch.argsort(r.to(cuda_device), dim=2, stable=True)
        assert torch.equal(card.cpu(), cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("growth,layout", [
    ("depthwise", "auto"), ("depthwise", "legacy"), ("leafwise", "auto")])
def test_categorical_tree_on_card_routes_as_predict(cuda_device, growth,
                                                   layout):
    """One tree of CSR-ingested Criteo-shaped rows (30k rows, 26
    categorical features, 64 bins) on the card, on each arm: two runs
    bitwise equal, categorical splits present, and every row's leaf from
    the grower's routing (bit 29 and the membership gathers) equal to the
    leaf predict's bitset traversal reaches.  (Against the CPU's tree the
    split scan's fp32 prefix sums round differently on the two devices,
    which flips near-ties on this tie-heavy data.)"""
    from dryad_tpu_torch.engine.grower import grow_any
    from dryad_tpu_torch.engine.predict import pack_words, tree_leaves
    from dryad_tpu_torch.engine.train import feature_kinds

    csr, y, cat = datasets.criteo_like(30_000, seed=43)
    ds = Dataset(None, y, csr=csr, categorical_features=cat, max_bins=64)
    B, F = ds.mapper.total_bins, ds.num_features
    p = Params(growth=growth, max_depth=6, num_leaves=63, max_bins=64,
               deep_layout=layout, categorical_features=cat)
    yt = torch.from_numpy(ds.y).to(cuda_device)
    g, h = Binary().grad_hess(
        torch.full_like(yt, float(Binary().init_score(ds.y))), yt)
    Xb = torch.from_numpy(ds.X_binned).to(cuda_device)
    is_cat_feat, _ = feature_kinds(ds.mapper, False, cuda_device)
    args = (p, B, Xb, g, h,
            torch.ones(ds.num_rows, dtype=torch.bool, device=cuda_device),
            torch.ones(F, dtype=torch.bool, device=cuda_device))
    t1 = grow_any(*args, is_cat_feat=is_cat_feat)
    t2 = grow_any(*args, is_cat_feat=is_cat_feat)
    for k in t1:
        assert torch.equal(t1[k], t2[k]), k
    assert t1["is_cat"].any()
    words = pack_words(t1["feature"], t1["threshold"], t1["left"],
                       t1["right"], t1["default_left"], t1["is_cat"])
    leaves = tree_leaves(words, Xb, 6, t1["cat_bitset"])
    assert torch.equal(leaves, t1["row_leaf"])


def _cat_fixture_leafwise_bagged():
    rng = np.random.Generator(np.random.Philox(5))
    n = 2000
    cat = rng.integers(0, 12, size=n).astype(np.float32)
    Xnum = rng.normal(size=(n, 5)).astype(np.float32)
    X = np.column_stack([cat, Xnum])
    y = ((cat % 3 == 0).astype(np.float32) * 1.5 + Xnum[:, 0]
         + rng.normal(size=n) * 0.3 > 0.5).astype(np.float32)
    return X, y, dict(objective="binary", num_trees=6, num_leaves=8,
                      max_bins=32, categorical_features=[0], subsample=0.8,
                      colsample=0.8, seed=9)


def _cat_fixture_depthwise_bagged():
    rng = np.random.Generator(np.random.Philox(11))
    n = 2500
    cat = rng.integers(0, 9, size=n).astype(np.float32)
    Xnum = rng.normal(size=(n, 4)).astype(np.float32)
    X = np.column_stack([cat, Xnum])
    y = ((cat % 2 == 0) * 1.2 + Xnum[:, 0] + rng.normal(size=n) * 0.3
         > 0.6).astype(np.float32)
    return X, y, dict(objective="binary", num_trees=5, num_leaves=16,
                      max_depth=4, growth="depthwise", max_bins=32,
                      categorical_features=[0], subsample=0.8, seed=3)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["auto", "legacy"])
@pytest.mark.parametrize("make", [_cat_fixture_leafwise_bagged,
                                  _cat_fixture_depthwise_bagged])
def test_categorical_training_on_card_matches_cpu(cuda_device, make, layout):
    """The reference's two bagged categorical fixtures (no near-ties; the
    same data as tests/test_engine_parity.py's) trained on the card and on
    the CPU, on either arm: integer arrays, ``is_cat`` and ``cat_bitset``
    equal, leaf values within 1e-4, covers within 1e-5 relative; the
    card's raw predict of its model equals the CPU's bit for bit."""
    import dryad_tpu_torch as dt

    X, y, params = make()
    ds = Dataset(X, y, categorical_features=[0], max_bins=32)
    params = dict(params, deep_layout=layout)
    cpu = dt.train(params, ds, device="cpu")
    card = dt.train(params, ds, device=cuda_device)
    assert cpu.arrays["is_cat"].any()
    for k in ("feature", "threshold", "left", "right", "default_left",
              "is_cat", "cat_bitset"):
        np.testing.assert_array_equal(card.arrays[k], cpu.arrays[k],
                                      err_msg=k)
    np.testing.assert_allclose(card.arrays["value"], cpu.arrays["value"],
                               atol=1e-4)
    np.testing.assert_allclose(card.arrays["cover"], cpu.arrays["cover"],
                               rtol=1e-5)
    np.testing.assert_array_equal(
        dt.predict(card, X, raw_score=True, device=cuda_device),
        dt.predict(card, X, raw_score=True, device="cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("growth", ["depthwise", "leafwise"])
def test_bagged_validated_training_on_card_matches_cpu(cuda_device, growth):
    """Two bagged, column-sampled trees with a valid set scored on the
    device (50k Higgs-like rows, 64 bins, depth 6): the card's trees equal
    the CPU's (integer arrays and covers; values within 1e-4), the evals
    agree within 1e-6, and the card's eval of its last tree equals the
    host AUC of its own predict within 1e-5."""
    import dryad_tpu_torch as dt
    from dryad_tpu_torch.metrics import auc

    X, y = datasets.higgs_like(60_000, seed=43)
    ds = Dataset(X[:50_000], y[:50_000], max_bins=64)
    dv = ds.bind(X[50_000:], y[50_000:])
    params = dict(objective="binary", growth=growth, max_depth=6,
                  num_leaves=40, max_bins=64, num_trees=2, subsample=0.8,
                  colsample=0.8, seed=3)
    out = {}
    for dev in ("cpu", cuda_device):
        out[str(dev)] = dt.train(params, ds, [dv], device=dev)
    cpu, card = out["cpu"], out[str(cuda_device)]
    for k in ("feature", "threshold", "left", "right", "default_left",
              "cover"):
        np.testing.assert_array_equal(card.arrays[k], cpu.arrays[k],
                                      err_msg=k)
    np.testing.assert_allclose(card.arrays["value"], cpu.arrays["value"],
                               atol=1e-4)
    assert (card.arrays["cover"][:, 0] < 0.85 * 50_000).all()
    hc = card.train_state["eval_history"]["valid_auc"]
    hp = cpu.train_state["eval_history"]["valid_auc"]
    np.testing.assert_allclose([v for _, v in hc], [v for _, v in hp],
                               rtol=0, atol=1e-6)
    host = auc(y[50_000:], dt.predict(card, X[50_000:], raw_score=True,
                                      device=cuda_device))
    assert abs(hc[-1][1] - host) < 1e-5


@pytest.mark.cuda
def test_multiclass_training_on_card_matches_cpu(cuda_device):
    """Two iterations of K=3 class trees (50k Covertype-like rows, 64
    bins, depth 6, bagged and column-sampled, a valid set scored with
    multi_logloss): the card's trees equal the CPU's (integer arrays; leaf
    values within 1e-4; covers within 1e-5 relative, since the card's exp
    may round g/h differently), the evals agree within 1e-6, and the
    card's (N, 3) raw predict equals the CPU's predict of the same model
    bit for bit."""
    import dryad_tpu_torch as dt

    X, y = datasets.covertype_like(60_000, 54, 3, seed=43)
    ds = Dataset(X[:50_000], y[:50_000], max_bins=64)
    dv = ds.bind(X[50_000:], y[50_000:])
    params = dict(objective="multiclass", num_class=3, growth="depthwise",
                  max_depth=6, num_leaves=40, max_bins=64, num_trees=2,
                  subsample=0.8, colsample=0.8, seed=3)
    cpu = dt.train(params, ds, [dv], device="cpu")
    card = dt.train(params, ds, [dv], device=cuda_device)
    assert card.num_total_trees == 6
    for k in ("feature", "threshold", "left", "right", "default_left"):
        np.testing.assert_array_equal(card.arrays[k], cpu.arrays[k],
                                      err_msg=k)
    np.testing.assert_allclose(card.arrays["value"], cpu.arrays["value"],
                               atol=1e-4)
    np.testing.assert_allclose(card.arrays["cover"], cpu.arrays["cover"],
                               rtol=1e-5)
    hc = card.train_state["eval_history"]["valid_multi_logloss"]
    hp = cpu.train_state["eval_history"]["valid_multi_logloss"]
    np.testing.assert_allclose([v for _, v in hc], [v for _, v in hp],
                               rtol=0, atol=1e-6)
    raw = dt.predict(card, X[50_000:], raw_score=True, device=cuda_device)
    assert raw.shape == (10_000, 3)
    np.testing.assert_array_equal(
        raw, dt.predict(card, X[50_000:], raw_score=True, device="cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 3])
def test_goss_selection_on_card_matches_cpu(cuda_device, K):
    """GOSS at 1M rows: the card's uniforms equal the numpy copy, and the
    card's selection (mask, amplified g and h) equals the CPU's, bit for
    bit."""
    from dryad_tpu_torch.engine import goss, loop_state

    p = Params(boosting="goss", goss_top_rate=0.2, goss_other_rate=0.1,
               seed=7)
    N = 1_000_000
    rng = np.random.default_rng(5)
    g = torch.from_numpy(rng.normal(size=(N, K)).astype(np.float32))
    h = torch.from_numpy(rng.uniform(0.1, 1, (N, K)).astype(np.float32))
    u = goss.goss_uniform_dev(p.seed, 3, N, cuda_device)
    np.testing.assert_array_equal(u.cpu().numpy(),
                                  loop_state.goss_uniform(p, 3, N))
    ones = torch.ones(N, dtype=torch.bool)
    card = goss.goss_select(p, N, g.to(cuda_device), h.to(cuda_device), u,
                            ones.to(cuda_device))
    cpu = goss.goss_select(p, N, g, h, u.cpu(), ones)
    for a, b in zip(card, cpu):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["goss", "monotone_depthwise",
                                  "monotone_leafwise", "dart", "rf"])
def test_boosting_modes_on_card_match_cpu(cuda_device, mode):
    """GOSS, monotone constraints (depthwise and leaf-wise), DART and rf
    trained on the card and on the CPU (20k Higgs-like rows, 64 bins,
    depth 6, 6 trees): integer arrays equal, leaf values within 1e-4; the
    card's raw predict of its model equals the CPU's bit for bit."""
    import dryad_tpu_torch as dt

    X, y = datasets.higgs_like(20_000, seed=43)
    ds = Dataset(X, y, max_bins=64)
    base = dict(objective="binary", growth="depthwise", max_depth=6,
                num_leaves=40, max_bins=64, num_trees=6, seed=3)
    params = {"goss": dict(base, boosting="goss"),
              "monotone_depthwise": dict(
                  base, monotone_constraints=(0,) * 6 + (1, -1, 1, -1)),
              "monotone_leafwise": dict(
                  base, growth="leafwise",
                  monotone_constraints=(0,) * 6 + (1, -1, 1, -1)),
              "dart": dict(base, boosting="dart", drop_rate=0.5,
                           skip_drop=0.2),
              "rf": dict(base, boosting="rf", subsample=0.7,
                         colsample=0.8)}[mode]
    cpu = dt.train(params, ds, device="cpu")
    card = dt.train(params, ds, device=cuda_device)
    for k in ("feature", "threshold", "left", "right", "default_left"):
        np.testing.assert_array_equal(card.arrays[k], cpu.arrays[k],
                                      err_msg=k)
    np.testing.assert_allclose(card.arrays["value"], cpu.arrays["value"],
                               atol=1e-4)
    np.testing.assert_array_equal(
        dt.predict(card, X, raw_score=True, device=cuda_device),
        dt.predict(card, X, raw_score=True, device="cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["binary", "multiclass_categorical"])
def test_model_api_on_card_matches_cpu(cuda_device, kind):
    """pred_leaf, the SoA traversal (features re-indexed past 4096),
    TreeSHAP, refit and cv on the card against the CPU: leaf ids and
    predicts bitwise, SHAP within 1e-9, refit values within rtol 1e-5 /
    atol 1e-6 and two card refits bitwise, cv trees equal and curves
    within 1e-6."""
    import dryad_tpu_torch as dt

    if kind == "binary":
        X, y = datasets.higgs_like(20_000, seed=5)
        ds = Dataset(X, y, max_bins=64)
        params = dict(objective="binary", growth="depthwise", max_depth=6,
                      num_leaves=40, max_bins=64, num_trees=5)
    else:
        X, y = datasets.covertype_like(20_000, 12, 3, seed=5)
        X[:, 0] = np.floor(np.abs(X[:, 0]) * 4)
        ds = Dataset(X, y, max_bins=64, categorical_features=[0])
        params = dict(objective="multiclass", num_class=3, num_trees=3,
                      num_leaves=15, max_bins=64, categorical_features=[0])
    b = dt.train(params, ds, device="cpu")
    Xb = ds.X_binned[:2000]
    leaves = b.predict_binned(Xb, pred_leaf=True, device=cuda_device)
    np.testing.assert_array_equal(
        leaves, b.predict_binned(Xb, pred_leaf=True, device="cpu"))
    ta = b.tree_arrays()
    ta["feature"] = np.where(ta["feature"] >= 0, ta["feature"] + 4096, -1)
    Xw = np.zeros((Xb.shape[0], 4096 + Xb.shape[1]), Xb.dtype)
    Xw[:, 4096:] = Xb
    wide = dt.Booster(b.params, b.mapper, ta, b.init_score,
                      b.max_depth_seen)
    np.testing.assert_array_equal(
        wide.predict_binned(Xw, raw_score=True, device=cuda_device),
        b.predict_binned(Xb, raw_score=True, device=cuda_device))
    phi = b.predict_binned(Xb[:300], pred_contrib=True, device=cuda_device)
    np.testing.assert_allclose(
        phi, b.predict_binned(Xb[:300], pred_contrib=True, device="cpu"),
        rtol=0, atol=1e-9)
    r1 = b.refit(X, y, decay_rate=0.8, device=cuda_device)
    r2 = b.refit(X, y, decay_rate=0.8, device=cuda_device)
    rc = b.refit(X, y, decay_rate=0.8, device="cpu")
    np.testing.assert_array_equal(r1.arrays["value"], r2.arrays["value"])
    np.testing.assert_allclose(r1.arrays["value"], rc.arrays["value"],
                               rtol=1e-5, atol=1e-6)
    if kind == "binary":
        kw = dict(nfold=3, seed=1, return_boosters=True)
        card = dt.cv(params, ds, device=cuda_device, **kw)
        cpu = dt.cv(params, ds, device="cpu", **kw)
        for bc, bp in zip(card["boosters"], cpu["boosters"]):
            for k in ("feature", "threshold", "left", "right"):
                np.testing.assert_array_equal(bc.arrays[k], bp.arrays[k])
        np.testing.assert_allclose(card["valid_auc-mean"],
                                   cpu["valid_auc-mean"], rtol=0, atol=1e-6)


def _serve_models():
    """(raw rows, a binary depth-6 model, a 3-class categorical model, its
    rows), trained on the CPU."""
    import dryad_tpu_torch as dt

    X, y = datasets.higgs_like(20_000, seed=9)
    b = dt.train(dict(objective="binary", growth="depthwise", max_depth=6,
                      num_leaves=63, max_bins=64, num_trees=40),
                 Dataset(X, y, max_bins=64), device="cpu")
    Xc, yc = datasets.covertype_like(20_000, 12, 3, seed=5)
    Xc[:, 0] = np.floor(np.abs(Xc[:, 0]) * 4)
    bc = dt.train(dict(objective="multiclass", num_class=3, num_trees=4,
                       num_leaves=15, max_bins=64, categorical_features=[0]),
                  Dataset(Xc, yc, max_bins=64, categorical_features=[0]),
                  device="cpu")
    return X, b, bc, Xc


@pytest.mark.cuda
def test_serving_on_card_equals_direct_and_captures_only_in_warmup(
        cuda_device):
    """The serving stack on the card: served = direct card predict and =
    CPU predict bitwise at every shape (chunked past 512 rows), raw and
    transformed, for a packed binary model and a categorical 3-class
    model (the bitset arm); warmup captures one graph per (version,
    bucket) and traffic after it captures none; /healthz stays 200."""
    from dryad_tpu_torch.obs.health import healthz_payload
    from dryad_tpu_torch.serve import PredictServer

    X, b, bc, Xc = _serve_models()
    server = PredictServer(device=cuda_device, max_batch_rows=512,
                           max_wait_ms=0.5)
    v1 = server.registry.add(b)
    v2 = server.registry.add(bc, activate=False, name="cat")
    assert server.warmup() == 2 * len(server.cache.buckets())
    compiles = server.stats()["cache_compiles"]
    assert compiles == 2 * len(server.cache.buckets())
    assert all(s > 0 for s in server.cache.capture_s.values())
    with server:
        for n in (0, 1, 7, 8, 9, 100, 512, 513, 1500):
            for raw in (True, False):
                got = server.predict(X[:n], raw_score=raw, timeout=60)
                np.testing.assert_array_equal(
                    got, b.predict(X[:n], raw_score=raw, device=cuda_device))
                np.testing.assert_array_equal(
                    got, b.predict(X[:n], raw_score=raw, device="cpu"))
                got = server.predict(Xc[:n], model="cat", raw_score=raw,
                                     timeout=60)
                np.testing.assert_array_equal(
                    got, bc.predict(Xc[:n], raw_score=raw, device="cpu"))
        assert server.stats()["cache_compiles"] == compiles
        assert healthz_payload()[0] == 200
        assert server.registry.memory()["staged_versions"] == [v1, v2]


@pytest.mark.cuda
def test_serving_eviction_and_unload_free_card_memory(cuda_device):
    """A budget eviction drops the model's device tables and graphs
    (``torch.cuda.memory_allocated`` falls), the model re-stages and
    answers bitwise; unloading a version frees its graphs as well."""
    from dryad_tpu_torch.serve import PredictServer

    X, b, bc, Xc = _serve_models()
    server = PredictServer(device=cuda_device, max_batch_rows=512,
                           max_wait_ms=0.5)
    v1 = server.registry.add(b)
    v2 = server.registry.add(bc, activate=False)
    server.warmup()
    want = b.predict(X[:300], raw_score=True, device="cpu")
    with server:
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated()
        server.activate(v2)
        server.registry.budget_bytes = 1
        v3 = server.registry.add(bc, activate=False)
        server.registry.get(v3).staged()          # evicts v1
        torch.cuda.synchronize()
        m1 = torch.cuda.memory_allocated()
        assert not server.registry.get(v1).is_staged
        assert not any(k[0] == v1 for k in server.cache._graphs)
        assert m1 < m0
        np.testing.assert_array_equal(
            server.predict(X[:300], version=v1, raw_score=True, timeout=60),
            want)
        assert server.stats()["restages"] >= 1
        server.registry.budget_bytes = None
        server.activate(v1)
        assert any(k[0] == v2 for k in server.cache._graphs)
        torch.cuda.synchronize()
        m2 = torch.cuda.memory_allocated()
        server.unload(v2)
        torch.cuda.synchronize()
        assert not any(k[0] == v2 for k in server.cache._graphs)
        assert torch.cuda.memory_allocated() < m2
        np.testing.assert_array_equal(
            server.predict(X[:300], raw_score=True, timeout=60), want)


def _identity(acc):
    return acc


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["layout", "rows", "nat"])
def test_accumulate_only_launch_equals_full_launch(cuda_device, kind):
    """The launch that skips its conversion, plus ``sums_to_float``, gives
    the full launch's bits, and each counts as one launch."""
    from dryad_tpu_torch.engine import cuda_build

    rng = np.random.default_rng(7)
    N, F, B, P = 30000, 28, 256, 5
    Xb = torch.from_numpy(rng.integers(0, B, (N, F)).astype(np.uint8))
    g = torch.from_numpy(rng.normal(size=N).astype(np.float32))
    h = torch.from_numpy(rng.uniform(0.1, 1, N).astype(np.float32))
    sel = torch.from_numpy(rng.integers(0, P + 1, N))
    shift = hist.fixed_point_shift(g, h).to(cuda_device)
    if kind == "layout":
        rec, lt, base, sh = _grouped_layout(rng, N, F, B, P)
        src = torch.arange(rec.shape[0] // T, device=cuda_device)
        tl = torch.from_numpy(np.repeat(np.arange(P), lt)).to(cuda_device)
        args = (torch.from_numpy(rec).to(cuda_device), src, tl, P, B, F, 1,
                sh.to(cuda_device))
        key = "hist"

        def run(**kw):
            return hist.hist_tiles(*args, **kw)
    elif kind == "rows":
        recs = tile_plan.make_records(Xb, g, h).to(cuda_device)
        buf, tl, _ = tile_plan.tile_plan(sel.to(cuda_device), N, P)
        key = "hist_rows"

        def run(**kw):
            return hist.hist_rows(recs, buf, tl, P, B, F, 1, shift, **kw)
    else:
        xt = hist_nat.natural_tiles(Xb).to(cuda_device)
        gd, hd = g.to(cuda_device), h.to(cuda_device)
        sd = torch.where(sel < P, sel, hist_nat.NAT_DROP).to(cuda_device)
        key = "nat"

        def run(**kw):
            return hist_nat.build_hist_nat(xt, gd, hd, sd, shift,
                                           total_bins=B, num_features=F,
                                           num_cols=P, **kw)
    full = run()
    before = cuda_build.counts[key]
    acc = run(reduce=_identity)
    assert cuda_build.counts[key] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(acc, full)


@pytest.mark.cuda
def test_two_gloo_ranks_on_the_card_equal_one_process(cuda_device,
                                                      tmp_path):
    """Two rank processes share the card through a gloo group
    (``tests/torch_dist_worker.py``) and grow, on both reduction arms,
    the trees one process grows on all 50k rows, bit for bit."""
    import os
    import pickle
    import subprocess
    import sys

    import torch_dist_worker as W

    tests = os.path.dirname(os.path.abspath(__file__))
    spec = {"world": 2, "store": str(tmp_path / "store"), "timeout_s": 120,
            "configs": list(W.CARD_CONFIGS), "device": "cuda:0"}
    path = str(tmp_path / "spec.pkl")
    with open(path, "wb") as f:
        pickle.dump(spec, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(tests), tests, os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable,
                               os.path.join(tests, "torch_dist_worker.py"),
                               path, str(r)], env=env)
             for r in range(2)]
    try:
        for p in procs:
            p.wait(timeout=240)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs)
    data = W.make_data(card=True)
    for name in W.CARD_CONFIGS:
        want = W.run_config(name, data, group=False, device="cuda")
        for r in range(2):
            with open(f"{path}.{r}.out", "rb") as f:
                out = pickle.load(f)
            assert "error" not in out, out.get("error")
            for k, v in want.items():
                if isinstance(v, np.ndarray):
                    np.testing.assert_array_equal(out[name][k], v,
                                                  err_msg=f"{name} {k}")


@pytest.mark.cuda
def test_goss_and_renewal_over_gloo_ranks_on_the_card(cuda_device,
                                                      tmp_path):
    """Two rank processes share the card through a gloo group and run
    GOSS (the group's radix-select threshold and top count on card
    tensors) and the l1 renewal on the feature arm (the gathered in-bag
    residuals): the trees one process grows on all 50k rows, bit for
    bit."""
    import os
    import pickle
    import subprocess
    import sys

    import torch_dist_worker as W

    tests = os.path.dirname(os.path.abspath(__file__))
    spec = {"world": 2, "store": str(tmp_path / "store"), "timeout_s": 120,
            "configs": list(W.CARD_MODE_CONFIGS), "device": "cuda:0"}
    path = str(tmp_path / "spec.pkl")
    with open(path, "wb") as f:
        pickle.dump(spec, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(tests), tests, os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable,
                               os.path.join(tests, "torch_dist_worker.py"),
                               path, str(r)], env=env)
             for r in range(2)]
    try:
        for p in procs:
            p.wait(timeout=240)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs)
    data = W.make_data(card=True)
    for name in W.CARD_MODE_CONFIGS:
        want = W.run_config(name, data, group=False, device="cuda")
        for r in range(2):
            with open(f"{path}.{r}.out", "rb") as f:
                out = pickle.load(f)
            assert "error" not in out, out.get("error")
            for k, v in want.items():
                if isinstance(v, np.ndarray):
                    np.testing.assert_array_equal(out[name][k], v,
                                                  err_msg=f"{name} {k}")


@pytest.mark.cuda
def test_sharded_predict_and_cache_on_card(cuda_device):
    """Predict split over ``[cuda:0, cuda:0]`` (each block its own launch
    on the card) is bitwise the single-device card predict and the CPU's
    at uneven row counts; a cache whose sharded family holds two blocks a
    bucket (two CUDA graphs on the card) serves bitwise the unsharded
    cache, stages one copy of the tables on the card for both families,
    and warm traffic captures nothing."""
    from dryad_tpu_torch.engine.predict import predict_binned_sharded
    from dryad_tpu_torch.serve.cache import CompiledPredictCache
    from dryad_tpu_torch.serve.registry import ModelRegistry

    X, b, bc, Xc = _serve_models()
    two = [torch.device("cuda", 0)] * 2
    for model, rows in ((b, X), (bc, Xc)):
        Xb = model.mapper.transform(rows[:5001])
        for n in (1, 7, 1000, 5001):
            got = predict_binned_sharded(model, Xb[:n], devices=two)
            np.testing.assert_array_equal(
                got, model.predict_binned(Xb[:n], raw_score=True,
                                          device=cuda_device).reshape(
                                              got.shape))
            np.testing.assert_array_equal(
                got, model.predict_binned(Xb[:n], raw_score=True,
                                          device="cpu").reshape(got.shape))
        reg = ModelRegistry()
        entry = reg.get(reg.add(model))
        sharded = CompiledPredictCache(cuda_device, max_bucket=512,
                                       devices=two, sharded_threshold=0)
        plain = CompiledPredictCache(cuda_device, max_bucket=512)
        for n in (1, 8, 100, 512, 1300):
            np.testing.assert_array_equal(sharded.predict_raw(entry, Xb[:n]),
                                          plain.predict_raw(entry, Xb[:n]))
        assert any(k[2] == 2 for k in sharded._graphs)
        assert all(len(g) == k[2] for k, g in sharded._graphs.items())
        # both families and both caches stage one copy on the one card
        assert list(entry._device) == [torch.device("cuda", 0)]
        assert entry.staged_bytes == 2 * entry._staged_bytes
        n_graphs = len(sharded._graphs)
        for n in (5, 120, 1000):     # buckets 8, 128 and 512, all warm
            sharded.predict_raw(entry, Xb[:n])
        assert len(sharded._graphs) == n_graphs


@pytest.mark.cuda
def test_streamed_training_on_card_equals_resident(cuda_device, tmp_path):
    """A spilled 60k-row set at two ragged chunkings: its device matrix,
    assembled chunk by chunk through pinned buffers on a side stream, is
    the resident upload bit for bit, and its trees equal a resident run's
    on the card bit for bit (every array); the upload is memoized."""
    import dryad_tpu_torch as dt
    from dryad_tpu_torch.data.stream_dataset import StreamedDataset

    X, y = datasets.higgs_like(60_000, seed=7)
    ds = Dataset(X, y, max_bins=64)
    params = dict(objective="binary", growth="depthwise", max_depth=6,
                  num_leaves=40, max_bins=64, num_trees=3)
    ref = dt.train(params, ds, device=cuda_device).tree_arrays()
    want = ds.device_arrays(cuda_device)[0]
    for chunk_rows in (7_001, 25_000):
        sds = StreamedDataset.from_dataset(
            ds, str(tmp_path / f"{chunk_rows}.bins"), chunk_rows=chunk_rows)
        got = sds.device_arrays(cuda_device)[0]
        assert got.is_cuda and torch.equal(got.cpu(), want.cpu())
        assert sds.device_arrays(cuda_device)[0] is got
        out = dt.train(params, sds, device=cuda_device).tree_arrays()
        for k, v in ref.items():
            np.testing.assert_array_equal(out[k], v, err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [256, 2048])
def test_arm_a1_on_card_matches_cpu(cuda_device, B):
    """Arm A1 (plain torch int64 scatter-adds) on the card equals the CPU
    bit for bit, root and segmented passes, and equals K1 on the card at
    256 bins (the same fixed-point sums)."""
    from dryad_tpu_torch.engine import histogram

    rng = np.random.default_rng(B)
    N, F, P = 50_000, 7, 6
    Xb = torch.from_numpy(rng.integers(0, B, (N, F)).astype(
        np.uint8 if B <= 256 else np.int32))
    g = torch.from_numpy(rng.normal(size=N).astype(np.float32))
    h = torch.from_numpy(rng.uniform(0.05, 0.25, N).astype(np.float32))
    sel = torch.from_numpy(rng.integers(0, P + 1, N))
    shift = hist.fixed_point_shift(g, h)
    cpu = histogram.build_hist_a1(Xb, g, h, sel, P, B, shift,
                                  rows_per_chunk=4096)
    dev = [t.to(cuda_device) for t in (Xb, g, h, sel, shift)]
    card = histogram.build_hist_a1(*dev[:4], P, B, dev[4],
                                   rows_per_chunk=4096)
    torch.cuda.synchronize()
    assert torch.equal(card.cpu(), cpu)
    if B <= hist.MAX_BINS:
        k1 = histogram.build_hist_segmented(*dev[:4], P, B, dev[4])
        assert torch.equal(k1.cpu(), cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("forced", [{"MAX_PACKED_LEAVES": 8},
                                    {"MAX_PACKED_BINS": 16}])
def test_unpacked_route_on_card_matches_cpu(cuda_device, forced,
                                            monkeypatch):
    """The unpacked routing, forced at a small leaf budget or bin count
    (either forces the legacy arm: K3 and K1 row mode on the card): card
    trees equal the CPU's, integer arrays and row_leaf equal, values
    within 1e-4."""
    from dryad_tpu_torch.engine import levelwise

    for name, value in forced.items():
        monkeypatch.setattr(levelwise, name, value)
    rng = np.random.default_rng(11)
    N, F, B = 40_000, 6, 32
    Xb = torch.from_numpy(rng.integers(0, B, (N, F)).astype(np.uint8))
    g = torch.from_numpy(rng.normal(size=N).astype(np.float32))
    h = torch.from_numpy(rng.uniform(0.05, 0.25, N).astype(np.float32))
    p = Params(growth="depthwise", max_depth=5, num_leaves=24, max_bins=B,
               min_data_in_leaf=10)
    seen = []
    real = levelwise.gather_left
    monkeypatch.setattr(levelwise, "gather_left",
                        lambda *a, **k: seen.append(1) or real(*a, **k))
    args = (torch.ones(N, dtype=torch.bool), torch.ones(F, dtype=torch.bool))
    cpu = grow_tree_levelwise(p, B, Xb, g, h, *args)
    card = grow_tree_levelwise(
        p, B, *(t.to(cuda_device) for t in (Xb, g, h)),
        *(t.to(cuda_device) for t in args))
    assert seen
    for k in ("feature", "threshold", "left", "right", "default_left",
              "row_leaf"):
        assert torch.equal(card[k].cpu(), cpu[k]), k
    np.testing.assert_allclose(card["value"].cpu().numpy(),
                               cpu["value"].numpy(), atol=1e-4)
