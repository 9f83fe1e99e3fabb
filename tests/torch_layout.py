"""A layout builder shared by the port's histogram tests (imports no jax,
so the card tests can use it on a machine without it)."""

import numpy as np

TILE_ROWS = 512


def grouped_layout(rec_nat, seg_of, S):
    """Natural-order records ``rec_nat`` (n, width) uint8 grouped by segment
    in row order, each segment from a tile boundary: (rec, lt, base), where
    segment s holds tiles [base[s], base[s] + lt[s]), at least one.  Rows
    whose ``seg_of`` is S or more are left out."""
    rec_nat, seg_of = np.asarray(rec_nat), np.asarray(seg_of)
    T = TILE_ROWS
    counts = np.bincount(seg_of[seg_of < S], minlength=S)
    lt = np.maximum(-(-counts // T), 1)
    base = np.concatenate([[0], np.cumsum(lt)])
    rec = np.zeros((base[-1] * T, rec_nat.shape[1]), np.uint8)
    for s in range(S):
        rows = rec_nat[seg_of == s]
        rec[base[s] * T: base[s] * T + len(rows)] = rows
    return rec, lt, base
