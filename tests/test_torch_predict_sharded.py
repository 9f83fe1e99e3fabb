"""Predict and serving split over several devices (M12b), on the CPU.

* ``engine.predict.predict_binned_sharded`` over ``["cpu"] * n`` for n in
  2, 3 and 8, at 1, 7, 8, 9, 13 and 600 rows (one row, fewer rows than
  devices, uneven blocks), on the binary and K=3 multiclass models of
  ``tests/test_serve_sharded.py`` (trained by the reference's CPU trainer,
  crossed with ``torch_layout.port_of``): bitwise the port's
  single-device predict and the reference's CPU predict.  It is not held
  to the reference's own ``predict_binned_sharded``, which does not run
  on these CPU devices.
* ``Booster.predict(..., sharded=True)`` passes through, link transform
  included, and refuses ``pred_leaf``/``pred_contrib``.
* The serving cache's ``(version, bucket, n_shards)`` family: the
  reference's routing at the threshold, ``sharded=True`` (threshold 0),
  bitwise the unsharded cache, and no new entry on warm traffic.
"""

import numpy as np
import pytest

import dryad_tpu
from dryad_tpu.datasets import higgs_like
from dryad_tpu.serve.cache import CompiledPredictCache as JCache

from dryad_tpu_torch.engine import predict as P
from dryad_tpu_torch.serve import PredictServer
from dryad_tpu_torch.serve.cache import CompiledPredictCache
from dryad_tpu_torch.serve.metrics import ServeMetrics
from dryad_tpu_torch.serve.registry import ModelRegistry
from torch_layout import one_torch_thread, port_of  # noqa: F401 (autouse)

ROWS = (1, 7, 8, 9, 13, 600)
SHARDS = (2, 3, 8)


@pytest.fixture(scope="module")
def models():
    """tests/test_serve_sharded.py's binary and K=3 models: (reference
    booster, port booster, raw rows)."""
    X, y = higgs_like(600, seed=7)
    ds = dryad_tpu.Dataset(X, y, max_bins=32)
    b2 = dryad_tpu.train(dict(objective="binary", num_trees=8, num_leaves=7,
                              max_bins=32), ds, backend="cpu")
    rng = np.random.default_rng(3)
    Xm = rng.standard_normal((500, 8)).astype(np.float32)
    ym = (Xm[:, 0] + Xm[:, 1] > 0).astype(np.float32) + (Xm[:, 2] > 0.5)
    dsm = dryad_tpu.Dataset(Xm, ym, max_bins=32)
    b3 = dryad_tpu.train(dict(objective="multiclass", num_class=3,
                              num_trees=4, num_leaves=7, max_bins=32),
                         dsm, backend="cpu")
    return {"binary": (b2, port_of(b2), X), "multiclass": (b3, port_of(b3),
                                                           Xm)}


@pytest.mark.parametrize("kind", ["binary", "multiclass"])
@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("n", ROWS)
def test_sharded_predict_bitwise(models, kind, shards, n):
    ref, port, X = models[kind]
    X = np.concatenate([X, X])[:n]          # the 3-class set has 500 rows
    Xb = port.mapper.transform(X)
    got = P.predict_binned_sharded(port, Xb, devices=["cpu"] * shards)
    single = P.predict_binned(port, Xb, device="cpu")
    want = ref.predict_binned(ref.mapper.transform(X), raw_score=True)
    assert got.shape == (n, port.num_outputs) and got.dtype == np.float32
    assert np.array_equal(got, single)
    assert np.array_equal(got.reshape(want.shape), want)


def test_booster_predict_sharded_passthrough(models):
    ref, port, X = models["multiclass"]
    for n in (1, 9, 13, 500):
        got = port.predict(X[:n], sharded=True, devices=["cpu"] * 3)
        assert got.shape == (n, 3)
        assert np.array_equal(got, port.predict(X[:n], device="cpu"))
        assert np.array_equal(got, ref.predict(X[:n]))
    for kw in ({"pred_leaf": True}, {"pred_contrib": True}):
        with pytest.raises(ValueError, match="pred_leaf/pred_contrib"):
            port.predict(X[:4], sharded=True, devices=["cpu"] * 2, **kw)


def test_sharded_predict_without_a_card_raises(models, monkeypatch):
    """No devices and no card: it raises instead of falling back."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, port, X = models["binary"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.predict(X[:4], sharded=True)


def _cache(threshold, shards=2, max_bucket=64):
    return CompiledPredictCache(
        "cpu", ServeMetrics(), min_bucket=8, max_bucket=max_bucket,
        devices=["cpu"] * shards, sharded_threshold=threshold)


@pytest.mark.parametrize("shards", [2, 3])
@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("threshold", [None, 0, 16, 100])
def test_routing_is_the_references(shards, K, threshold):
    """``shards_for`` against the reference's ``CompiledPredictCache``
    with a mesh of as many devices, bucket by bucket."""
    import jax

    from dryad_tpu.engine.distributed import make_mesh

    mine = _cache(threshold, shards, max_bucket=256)
    ref = JCache("jax", mesh=make_mesh(jax.devices()[:shards]),
                 max_bucket=256, sharded_threshold=threshold)
    assert mine.n_shards == ref.n_shards == shards
    for b in mine.buckets():
        assert mine.shards_for(b, K) == ref.shards_for(b, K), b


def test_one_device_is_no_family():
    c = CompiledPredictCache("cpu", devices=["cpu"], sharded_threshold=0)
    assert c.n_shards == 1 and c.shards_for(64, 1) == 1


@pytest.mark.parametrize("kind", ["binary", "multiclass"])
def test_cache_family_keys_and_bitwise(models, kind):
    """Buckets at or past the threshold (in row-outputs) take the sharded
    family, the rest one device; both answer bitwise the direct predict,
    and warm traffic adds no entry."""
    _, port, X = models[kind]
    K = port.num_outputs
    reg = ModelRegistry()
    v = reg.add(port)
    entry = reg.get(v)
    cache = _cache(32 * K)
    plain = CompiledPredictCache("cpu", min_bucket=8, max_bucket=64)
    rows = port.mapper.transform(np.tile(X, (2, 1))[:150])
    for n in (1, 8, 9, 31, 32, 33, 64, 150):
        got = cache.predict_raw(entry, rows[:n])
        assert np.array_equal(got, plain.predict_raw(entry, rows[:n])), n
        assert np.array_equal(got, P.predict_binned(port, rows[:n],
                                                    device="cpu")), n
    assert cache._warm == {(v, 8, 1), (v, 16, 1), (v, 32, 2), (v, 64, 2)}
    n_warm = cache.num_entries
    for n in (3, 17, 40, 64, 100):
        cache.predict_raw(entry, rows[:n])
    assert cache.num_entries == n_warm


def test_server_sharded_options(models, monkeypatch):
    """``sharded`` builds the family from every visible card: none on the
    CPU; on two cards ``True`` sets the threshold to 0, ``"auto"`` keeps
    the default, ``False`` turns it off.  ``stats()`` reports both."""
    import torch

    s = PredictServer(device="cpu")
    st = s.stats()
    assert st["mesh_shards"] == 1 and st["sharded_threshold"] is None
    with pytest.raises(ValueError, match="sharded"):
        PredictServer(device="cpu", sharded="yes")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    for sharded, want in (("auto", 32768), (True, 0), (False, None)):
        s = PredictServer(device="cuda", sharded=sharded)
        st = s.stats()
        assert st["sharded_threshold"] == want
        assert st["mesh_shards"] == (1 if want is None else 2)
    s = PredictServer(device="cuda", sharded_threshold=4096)
    assert s.cache.sharded_threshold == 4096
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert PredictServer(device="cuda", sharded=True).cache.n_shards == 1


def test_one_staged_copy_per_device(models, monkeypatch):
    """A bare ``cuda`` takes the current card's index, so the server's
    device and the sharded family's ``cuda:0`` are one key (one staged
    copy, one stream); serving a bucket from each family over two CPU
    blocks stages the tables once on the one device."""
    import torch

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    c = CompiledPredictCache("cuda", devices=["cuda:0", "cuda:1"],
                             sharded_threshold=0)
    assert c.device == c.devices[0] == torch.device("cuda", 0)
    assert hash(c.device) == hash(c.devices[0])
    monkeypatch.undo()
    _, port, X = models["binary"]
    reg = ModelRegistry()
    entry = reg.get(reg.add(port))
    cache = _cache(32)
    rows = port.mapper.transform(X[:64])
    for n in (8, 64):                   # buckets 8 (one device) and 64 (two)
        cache.predict_raw(entry, rows[:n])
    assert {k[2] for k in cache._warm} == {1, 2}
    assert entry.staged_bytes == 2 * entry._staged_bytes


def test_sharded_predict_in_pieces(models, monkeypatch):
    """A block past ``SHARD_NODE_BUDGET`` (row, tree) ids goes through in
    pieces, bitwise the whole."""
    ref, port, X = models["binary"]
    Xb = port.mapper.transform(X)
    want = P.predict_binned(port, Xb, device="cpu")
    monkeypatch.setattr(P, "SHARD_NODE_BUDGET", 8 * 7)
    got = P.predict_binned_sharded(port, Xb, devices=["cpu"] * 3)
    assert np.array_equal(got, want)
