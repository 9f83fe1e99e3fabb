"""Helpers shared by the port's tests (imports no jax, so the card tests
can use it on a machine without it): a histogram layout builder, and the
module-scoped autouse fixture that runs a test module on one torch
intra-op thread (``from torch_layout import one_torch_thread``)."""

import numpy as np
import pytest
import torch

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


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module (its module-scoped fixtures
    included), restored after it: the port's CPU fixtures are small, and
    under the suite's parallel workers torch's thread pools would
    oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_of(ref_booster):
    """The port's Booster for a reference booster, carried across as plain
    arrays and dicts (``convert.booster_from_reference``)."""
    from dryad_tpu_torch.convert import booster_from_reference

    b = ref_booster
    return booster_from_reference(
        b.tree_arrays(), b.mapper.to_json_dict(), b.init_score,
        b.params.to_dict(), b.max_depth_seen, b.best_iteration,
        b.train_state)
