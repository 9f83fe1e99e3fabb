"""The port's categorical split scan, node bitsets and bitset predict
against the reference (``dryad_tpu.engine.split.find_best_split`` vmapped
over candidates, ``grower.pack_cat_bitset``, the reference's CPU predict).

The scan is held bitwise: the histograms are small dyadic values, so every
prefix sum is exact in fp32 on both sides and the gains are the same fp32
expressions of the same numbers.  Predict of a carried model is bitwise,
since traversal compares integers and adds leaf values in fp32 in the same
order.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dryad_tpu
from dryad_tpu.engine.grower import pack_cat_bitset as j_pack_bitset
from dryad_tpu.engine.split import find_best_split as j_find

from dryad_tpu_torch.convert import booster_from_reference
from dryad_tpu_torch.engine.grower import pack_cat_bitset
from dryad_tpu_torch.engine.predict import predict_binned
from dryad_tpu_torch.engine.split import find_best_split as t_find
from torch_layout import one_torch_thread  # noqa: F401 (autouse)

_KW = dict(lambda_l2=1.0, min_child_weight=1e-3, min_data_in_leaf=5,
           min_split_gain=0.0)


def _cat_hists(rng, K, F, B, missing):
    """Dyadic g/h histograms with empty bins (count 0, sums 0)."""
    c = rng.integers(0, 12, (K, F, B)).astype(np.float32)
    c[rng.random((K, F, B)) < 0.25] = 0
    if not missing:
        c[:, :, 0] = 0
    g = (rng.integers(-16, 17, (K, F, B)) / 8.0 * c).astype(np.float32)
    h = (rng.integers(1, 5, (K, F, B)) / 16.0 * c).astype(np.float32)
    hist = np.stack([g, h, c], 1)
    return hist, hist[:, 0, 0].sum(-1), hist[:, 1, 0].sum(-1), \
        hist[:, 2, 0].sum(-1)


@pytest.mark.parametrize("learn_missing,bundled", [
    (False, False), (True, False), (True, True)])
@pytest.mark.parametrize("seed", [0, 1])
def test_categorical_scan_matches_reference(learn_missing, bundled, seed):
    rng = np.random.default_rng(seed)
    K, F, B = 8, 6, 32
    hist, G, H, C = _cat_hists(rng, K, F, B, missing=learn_missing)
    is_cat = np.array([True, False, True, False, True, False])
    bmask = np.array([False, True, False, False, True, False])
    fmask = np.ones(F, bool)
    fmask[4] = False
    allow = np.ones(K, bool)
    allow[3] = False
    got = t_find(torch.from_numpy(hist), torch.from_numpy(G),
                 torch.from_numpy(H), torch.from_numpy(C),
                 feat_mask=torch.from_numpy(fmask),
                 allow=torch.from_numpy(allow), learn_missing=learn_missing,
                 is_cat_feat=torch.from_numpy(is_cat),
                 bundled_mask=torch.from_numpy(bmask) if bundled else None,
                 **_KW)

    def one(hk, g_, h_, c_, a_):
        return j_find(hk, g_, h_, c_, feat_mask=jnp.asarray(fmask),
                      is_cat_feat=jnp.asarray(is_cat), allow=a_,
                      has_cat=True, learn_missing=learn_missing,
                      bundled_mask=jnp.asarray(bmask) if bundled else None,
                      **_KW)

    ref = jax.vmap(one)(jnp.asarray(hist), jnp.asarray(G), jnp.asarray(H),
                        jnp.asarray(C), jnp.asarray(allow))
    for name, r in (("gain", ref.gain), ("feature", ref.feature),
                    ("threshold", ref.threshold),
                    ("default_left", ref.default_left),
                    ("cat_mask", ref.cat_mask), ("g_left", ref.g_left),
                    ("h_left", ref.h_left), ("c_left", ref.c_left)):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(r),
                                      err_msg=name)
    # the fixture reaches categorical splits, numeric ones and a refusal
    won = got["feature"].numpy()
    assert is_cat[won[won >= 0]].any() and (~is_cat[won[won >= 0]]).any()
    assert got["cat_mask"].any()


def test_numeric_scan_without_categoricals_is_unchanged():
    rng = np.random.default_rng(3)
    hist, G, H, C = _cat_hists(rng, 6, 4, 16, missing=True)
    args = [torch.from_numpy(a) for a in (hist, G, H, C)]
    kw = dict(_KW, feat_mask=torch.ones(4, dtype=torch.bool),
              allow=torch.ones(6, dtype=torch.bool), learn_missing=True)
    plain = t_find(*args, **kw)
    none_cat = t_find(*args, **kw, is_cat_feat=torch.zeros(4,
                                                          dtype=torch.bool))
    for k in ("gain", "feature", "threshold", "default_left"):
        assert torch.equal(plain[k], none_cat[k]), k
    assert plain["cat_mask"].shape == (6, 1) and not plain["cat_mask"].any()


@pytest.mark.parametrize("B", [16, 256, 300])
def test_pack_cat_bitset_matches_reference(B):
    rng = np.random.default_rng(B)
    M = 9
    masks = rng.random((M, B)) < 0.4
    masks[0, min(B, 32) - 1] = True   # bit 31 of a word: int32's sign
    got = pack_cat_bitset(torch.from_numpy(masks)).numpy()
    ref = np.asarray(j_pack_bitset(jnp.asarray(masks), M))
    assert got.dtype == np.int64 and ref.dtype == np.uint32
    np.testing.assert_array_equal(got.astype(np.uint32), ref)
    assert (got >= 0).all() and (got < 1 << 32).all()


@pytest.fixture(scope="module")
def cat_model():
    """A reference CPU-trained model with categorical splits (the
    reference's depthwise categorical parity fixture, unbagged), with
    unseen and missing categories in the rows it predicts."""
    rng = np.random.Generator(np.random.Philox(11))
    n = 2500
    cat = rng.integers(0, 9, size=n).astype(np.float32)
    Xnum = rng.normal(size=(n, 4)).astype(np.float32)
    X = np.column_stack([cat, Xnum])
    y = ((cat % 2 == 0) * 1.2 + Xnum[:, 0] + rng.normal(size=n) * 0.3
         > 0.6).astype(np.float32)
    ds = dryad_tpu.Dataset(X, y, categorical_features=[0], max_bins=32)
    params = dict(objective="binary", num_trees=5, num_leaves=16,
                  max_depth=4, growth="depthwise", max_bins=32,
                  categorical_features=[0])
    jb = dryad_tpu.train(params, ds, backend="cpu")
    Xt = X.copy()
    Xt[::11, 0] = 42.0                # unseen category: the overflow bin
    Xt[::13, 0] = np.nan              # missing: bin 0
    return jb, Xt


@pytest.mark.parametrize("raw_score", [True, False])
def test_carried_categorical_model_predicts_bitwise(cat_model, raw_score):
    jb, Xt = cat_model
    assert jb.is_cat.any()
    tb = booster_from_reference(
        jb.tree_arrays(), json.loads(json.dumps(jb.mapper.to_json_dict())),
        jb.init_score, jb.params.to_dict(), jb.max_depth_seen)
    np.testing.assert_array_equal(
        tb.mapper.transform(Xt), jb.mapper.transform(Xt))
    got = tb.predict(Xt, raw_score=raw_score, device="cpu")
    np.testing.assert_array_equal(got, jb.predict(Xt, raw_score=raw_score))
    # predict of binned rows agrees too
    np.testing.assert_array_equal(
        predict_binned(tb, jb.mapper.transform(Xt),
                       device=torch.device("cpu"))[:, 0],
        jb.predict(Xt, raw_score=True))
