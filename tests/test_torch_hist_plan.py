"""The launch plans of the histogram kernels (engine/hist.py::tiles_plan,
rows_plan, k1_spans; engine/hist_nat.py::nat_plan, nat_blocks), pure
functions of the shapes and a card's limits, checked on the CPU for an
H100 (232,448 bytes of shared memory a block, 132 SMs) at every shape of
PERF.md's kernel table and at the edge shapes of tests/test_torch_cuda.py:
each plan fits the card, and covers each feature, slot and row exactly
once.
"""

import numpy as np
import pytest

from dryad_tpu_torch.engine import hist, hist_nat
from torch_layout import one_torch_thread  # noqa: F401 (autouse)

OPTIN, N_SM = 232_448, 132

# (rows, features, bins, slots, itemsize): K3 at PERF.md's shapes, then
# the edges
NAT_SHAPES = [
    (10_000_000, 28, 256, 16, 1),      # Higgs level 4
    (10_000_000, 28, 256, 8, 1),       # leaf-wise level 3, under the bag
    (50_000, 54, 256, 16, 1),          # Covertype's K=3 fixture
    (2_270_000, 136, 256, 8, 1),       # MSLR level 3
    (50_000, 39, 256, 16, 1),          # Criteo fixture
    (50_000, 28, 256, 16, 1),          # the modes' fixture
    (50_000, 54, 64, 16, 1),           # the fixtures at their 64 bins
    (50_000, 39, 64, 16, 1),
    (50_000, 28, 64, 16, 1),
    (40_077, 28, 256, 8, 1),
    (3, 28, 256, 8, 1),
    (20_011, 6, 1024, 1, 2),
    (20_011, 6, 1024, 16, 2),          # slot groups
    (70_001, 3, 256, 16, 2),
    (40_077, 300, 64, 3, 1),
    (1, 1, 2, 1, 1),
]

# (features, bins, itemsize): K1 layout mode (records of 128 bytes)
TILE_SHAPES = [(28, 256, 1), (54, 256, 1), (39, 256, 1), (28, 1024, 2),
               (5, 1024, 2), (119, 256, 1), (59, 1024, 2), (1, 2, 1)]

# (features, bins, itemsize): K1 row mode
ROW_SHAPES = [(28, 256, 1), (2000, 256, 1), (54, 256, 1), (136, 256, 1),
              (39, 256, 1), (54, 64, 1), (39, 64, 1), (28, 64, 1),
              (8, 256, 1), (6, 1024, 2), (130, 300, 2), (28, 1024, 2),
              (1, 2, 1)]


@pytest.mark.parametrize("N,F,B,P,isz", NAT_SHAPES)
def test_nat_plan_fits_and_covers_once(N, F, B, P, isz):
    plan = hist_nat.nat_plan(N, F, B, P, isz, OPTIN, N_SM)
    R = plan["stage_rows"]
    assert plan["smem"] <= OPTIN
    assert plan["smem"] == hist_nat.nat_smem(plan["f_chunk"],
                                             plan["s_chunk"], B, R, isz)
    assert R % 32 == 0 and 512 <= R <= hist_nat.NAT_MAX_STAGE_ROWS
    assert plan["stages"] >= 3
    assert plan["grid"] <= max(N_SM, plan["n_groups"])
    # the groups cover each (feature, slot) once; each group's blocks
    # cover its rows once
    rows = {}
    for f0, nf, s0, ns, r0, r1 in hist_nat.nat_blocks(plan, N, F, P):
        assert nf >= 1 and ns >= 1 and 0 <= r0 <= r1 <= N
        assert r0 % R == 0
        rows.setdefault((f0, nf, s0, ns), []).append((r0, r1))
    cover = np.zeros((F, P), np.int64)
    for f0, nf, s0, ns in rows:
        cover[f0:f0 + nf, s0:s0 + ns] += 1
    assert (cover == 1).all()
    for spans in rows.values():
        spans.sort()
        assert spans[0][0] == 0 and spans[-1][1] == N
        for (_, a1), (b0, _) in zip(spans, spans[1:]):
            assert a1 == b0


def _chunks(F, f_chunk):
    return [(f0, min(f_chunk, F - f0)) for f0 in range(0, F, f_chunk)]


def _check_k1(plan, F, B):
    assert plan["smem"] <= OPTIN
    assert plan["stages"] >= 2
    assert 1 <= plan["grid"] <= N_SM
    f_chunk, fp = plan["f_chunk"], plan["fp"]
    assert fp >= f_chunk and (fp % 32 == 0 or fp == f_chunk)
    chunks = _chunks(F, f_chunk)
    assert len(chunks) == plan["n_chunks"]
    seen = np.zeros(F, np.int64)
    for f0, nf in chunks:
        seen[f0:f0 + nf] += 1
    assert (seen == 1).all()
    # the blocks' work items cover each (chunk, plan tile) once, at any
    # count of tiles in use; a block takes one chunk where the grid is a
    # multiple of the chunks
    C = plan["n_chunks"]
    if 1 < C <= N_SM and N_SM % C <= N_SM // 50:
        assert plan["grid"] % C == 0
    for n_used in (1, 7, 4434, 19_532):
        cover = np.zeros((C, n_used), np.int64)
        for runs in hist.k1_spans(plan, n_used):
            if plan["grid"] % C == 0:
                assert len({c for c, _, _ in runs}) <= 1
            for c, t0, t1 in runs:
                cover[c, t0:t1] += 1
        assert (cover == 1).all()
    return chunks


@pytest.mark.parametrize("F,B,isz", TILE_SHAPES)
def test_tiles_plan_fits_and_covers_once(F, B, isz):
    plan = hist.tiles_plan(F, B, isz, 19_532, OPTIN, N_SM)
    _check_k1(plan, F, B)
    # the TMA box: every used byte of a record, 16-byte rows, in 128 bytes
    assert 9 + F * isz <= plan["pitch"] <= hist.REC_WB
    assert plan["pitch"] % 16 == 0
    assert plan["stage_bytes"] == hist.TILE_ROWS * plan["pitch"]
    assert plan["smem"] == hist.k1_smem(plan["fp"], B, plan["stages"],
                                        plan["stage_bytes"], plan["q"])


@pytest.mark.parametrize("F,B,isz", ROW_SHAPES)
def test_rows_plan_fits_and_covers_once(F, B, isz):
    W = hist.record_words(F, isz)
    plan = hist.rows_plan(F, B, isz, W, 19_532, OPTIN, N_SM)
    chunks = _check_k1(plan, F, B)
    pitch = plan["pitch"]
    assert pitch % 16 == 0
    if len(chunks) == 1:     # the whole record's span, at any alignment
        assert 4 * W + 12 <= pitch
        assert plan["stage_bytes"] == hist.TILE_ROWS * pitch
    else:                    # each chunk's bins' span; (g, h) beside
        for f0, nf in chunks:
            assert 15 + nf * isz <= pitch
        assert plan["stage_bytes"] == hist.TILE_ROWS * (pitch + 8)
    assert plan["smem"] == hist.k1_smem(plan["fp"], B, plan["stages"],
                                        plan["stage_bytes"], plan["q"])


def test_plans_keep_whole_warps_at_the_headline_shapes():
    """The bank-conflict-free layouts: Higgs, Epsilon, MSLR and Covertype
    keep whole warps of features; Higgs' K3 holds 4 features of 8 slots
    and 2 of 16."""
    assert hist.tiles_plan(28, 256, 1, 19_532, OPTIN, N_SM)["fp"] == 32
    assert hist.tiles_plan(54, 256, 1, 1_135, OPTIN, N_SM)["fp"] == 32
    for F, n_sel in ((28, 19_532), (2000, 586), (136, 4_434), (54, 225)):
        W = hist.record_words(F, 1)
        assert hist.rows_plan(F, 256, 1, W, n_sel, OPTIN,
                              N_SM)["fp"] % 32 == 0
    assert hist_nat.nat_plan(10_000_000, 28, 256, 8, 1, OPTIN,
                             N_SM)["f_chunk"] == 4
    assert hist_nat.nat_plan(10_000_000, 28, 256, 16, 1, OPTIN,
                             N_SM)["f_chunk"] == 2


@pytest.mark.parametrize("F,B,n_sel,packed", [
    (39, 65, 81, True),      # the Criteo fixture's 81 plan tiles
    (54, 65, 225, True),     # the multiclass fixture's
    (28, 65, 225, False),    # the modes fixture's: 4 features of padding
    (54, 65, 40, True),
    (20, 256, 1, True),
])
def test_small_passes_pack_their_features(F, B, n_sel, packed):
    """A pass of at most ``K1_PACK_ITEMS`` work items a block packs its
    features where whole warps would pad ``K1_PACK_PAD`` or more; a larger
    pass, or a smaller padding, keeps whole warps."""
    W = hist.record_words(F, 1)
    for plan in (hist.rows_plan(F, B, 1, W, n_sel, OPTIN, N_SM),
                 hist.tiles_plan(F, B, 1, n_sel, OPTIN, N_SM)):
        assert (plan["fp"] == plan["f_chunk"]) == packed
        assert n_sel * plan["n_chunks"] <= hist.K1_PACK_ITEMS * N_SM
        _check_k1(plan, F, B)
    big = (hist.K1_PACK_ITEMS + 1) * N_SM
    assert hist.rows_plan(54, 65, 1, hist.record_words(54, 1), big, OPTIN,
                          N_SM)["fp"] == 64


def test_plans_refuse_what_cannot_fit():
    with pytest.raises(ValueError, match="shared memory"):
        hist.tiles_plan(28, 256, 1, 1, 100_000 // 20, N_SM)
    with pytest.raises(ValueError, match="shared memory"):
        hist_nat.nat_plan(1000, 28, 1024, 16, 2, 20_000, N_SM)
