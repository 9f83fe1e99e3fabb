"""The port's tile plans and per-tree record table against the reference
(dryad_tpu.engine.pallas_hist).  Plans are integer arrays and the record
table is bit patterns, so every comparison is exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dryad_tpu.engine import pallas_hist as jph
from dryad_tpu_torch.engine import tile_plan as ttp
from torch_layout import one_torch_thread  # noqa: F401 (autouse)

T = ttp.TILE_ROWS


def _sel(rng, N, P, bound=None, hold_bound=True):
    """Slots in [0, P] (P = dropped) with slot 1 empty; under ``bound``
    unless the test means to violate it."""
    sel = rng.integers(0, P + 2, size=N).astype(np.int32)
    sel = np.where(sel <= P, sel, P)
    if P > 1:
        sel[sel == 1] = 0
    if bound is not None and hold_bound:
        keep = np.cumsum(sel < P) <= bound
        sel = np.where(keep, sel, P)
    return sel


@pytest.mark.parametrize("N,P,bound,hold", [
    (3000, 6, None, True),
    (5000, 4, 2501, True),          # a tighter static grid
    (T + 3, 3, None, True),         # a padded tail tile
    (4000, 16, None, True),
    (2000, 1, 1001, True),
    (5000, 4, 1000, False),         # violated bound: the safety squeeze
])
def test_tile_plans_match_reference(N, P, bound, hold):
    rng = np.random.default_rng(N + P)
    sel = _sel(rng, N, P, bound, hold)
    counts = np.bincount(sel[sel < P], minlength=P)[:P].astype(np.int32)
    want = jph.tile_plan(jnp.asarray(sel), N, P, T, rows_bound=bound)
    got = ttp.tile_plan(torch.from_numpy(sel), N, P, rows_bound=bound)
    for name, w, g in zip(("buf", "tile_leaf", "tile_first"), want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    if not hold:
        return                     # the aligned plan needs a kept bound
    want = jph.tile_plan_aligned(jnp.asarray(sel), jnp.asarray(counts), N, P,
                                 T, rows_bound=bound)
    got = ttp.tile_plan_aligned(torch.from_numpy(sel),
                                torch.from_numpy(counts), N, P,
                                rows_bound=bound)
    for name, w, g in zip(("buf", "tile_leaf", "tile_first"), want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg="aligned " + name)


@pytest.mark.parametrize("F,dtype", [(7, np.uint8), (6, np.uint16),
                                     (130, np.uint8), (5, np.uint16)])
def test_make_records_bitwise(F, dtype):
    rng = np.random.default_rng(F)
    N = 777
    Xb = rng.integers(0, 300 if dtype == np.uint16 else 256,
                      size=(N, F)).astype(dtype)
    g = rng.normal(size=N).astype(np.float32)
    h = rng.uniform(0.1, 1, N).astype(np.float32)
    want = np.asarray(jph.make_records(jnp.asarray(Xb), jnp.asarray(g),
                                       jnp.asarray(h)))
    xb_t = (torch.from_numpy(Xb) if dtype == np.uint8
            else torch.from_numpy(Xb.astype(np.int32)))
    got = ttp.make_records(xb_t, torch.from_numpy(g), torch.from_numpy(h))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
