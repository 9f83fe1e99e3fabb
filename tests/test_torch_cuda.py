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
fp32 prefix sums may round differently on the two devices).
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
