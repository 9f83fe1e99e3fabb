"""Model drift (``dryad_tpu_torch.obs.drift``) and the reference profile
(``dryad_tpu_torch.data.profile``) against the reference's, on the CPU.

The counterparts of ``tests/test_drift.py``'s profile, PSI, monitor, gate,
serving and bench cases (its router cases wait for the fleet):

* ``psi``, ``score_bucket_index``, ``parse_psi_budget``,
  ``merge_drift_states`` and ``drift_report`` give the reference's outputs
  on the same inputs; a ``DriftMonitor`` fed the same binned stream
  exports the reference monitor's state and snapshot, and the exact-merge
  property holds over 1, 2 and 4 monitors.
* The profile of a reference model carried across
  (``convert.booster_from_reference``) is the reference's; the profile of
  a port-trained model equals the reference's ``build_reference_profile``
  over the converted model; streamed and resident sets give one profile.
* Profiles cross between the packages in npz and text files both ways,
  and files without one load.
* Serving: monitors appear on the binned rows and raw scores, shifted
  traffic breaches, in-distribution traffic does not, a profile-less
  model costs one probe, and drift off or the registry disabled allocate
  nothing (tracemalloc, as the reference pins it).
"""

from __future__ import annotations

import json
import tracemalloc

import numpy as np
import pytest

import dryad_tpu
from dryad_tpu.data import profile as jprofile
from dryad_tpu.datasets import higgs_like
from dryad_tpu.obs import drift as jdrift

import dryad_tpu_torch as dt
from dryad_tpu_torch.data.profile import (ReferenceProfile,
                                          build_reference_profile,
                                          profile_from_binned)
from dryad_tpu_torch.obs.drift import (DEFAULT_PSI_BUDGET, SCORE_BUCKETS,
                                       DriftGate, DriftMonitor, drift_report,
                                       merge_drift_states, parse_psi_budget,
                                       psi, score_bucket_index)
from dryad_tpu_torch.obs.registry import Registry, set_default_registry
from dryad_tpu_torch.serve import PredictServer
from torch_layout import one_torch_thread, port_of  # noqa: F401 (autouse)

DISABLED = Registry(enabled=False)
PARAMS = dict(objective="binary", num_trees=8, num_leaves=7, max_bins=32,
              seed=3)


@pytest.fixture(scope="module")
def model():
    """(the port's booster of a reference model with the reference's
    profile, the reference booster, raw rows, the port's Dataset, the
    reference's Dataset)."""
    X, y = higgs_like(900, seed=7)
    jds = dryad_tpu.Dataset(X, y, max_bins=32)
    jb = dryad_tpu.train(PARAMS, jds, backend="cpu")
    jb.profile = jprofile.build_reference_profile(jb, jds)
    tds = dt.Dataset(X, y, max_bins=32)
    np.testing.assert_array_equal(tds.X_binned, jds.X_binned)
    return port_of(jb), jb, X, tds, jds


def _shift_binned(Xb: np.ndarray, by: int = 8) -> np.ndarray:
    return np.minimum(Xb.astype(np.int64) + by, 31).astype(Xb.dtype)


# ---------------------------------------------------------------------------
# the profile: against the reference, and its files


def test_reference_profile_carried_across(model):
    tb, jb, _X, _tds, _jds = model
    assert isinstance(tb.profile, ReferenceProfile)
    assert tb.profile.to_json_dict() == jb.profile.to_json_dict()


def test_port_profile_equals_reference_over_same_model(model):
    tb, jb, X, tds, jds = model
    got = build_reference_profile(tb, tds, device="cpu")
    assert got.to_json_dict() == jb.profile.to_json_dict()
    assert got.n_rows == X.shape[0]
    for c in got.feature_counts:
        assert sum(c) == got.n_rows
    assert got.missing_rate() == [c[0] / got.n_rows
                                  for c in got.feature_counts]
    counts, _total, n = got.score_hist["train"]
    assert n == got.n_rows and sum(counts) == n


def test_profile_valid_split_and_subsample_match_reference(model):
    tb, jb, _X, tds, jds = model
    Xv, yv = higgs_like(300, seed=8)
    vds = tds.bind(Xv, yv)
    jvds = dryad_tpu.Dataset(Xv, yv, mapper=jds.mapper)
    got = build_reference_profile(tb, tds, [vds], device="cpu")
    want = jprofile.build_reference_profile(jb, jds, [jvds])
    assert sorted(got.score_hist) == ["train", "valid"]
    assert got.score_hist["valid"][2] == 300
    assert got.to_json_dict() == want.to_json_dict()
    small = build_reference_profile(tb, tds, max_rows=100, device="cpu")
    assert small.n_rows <= 100
    assert small == build_reference_profile(tb, tds, max_rows=100,
                                            device="cpu")
    assert small.to_json_dict() == jprofile.build_reference_profile(
        jb, jds, max_rows=100).to_json_dict()


def test_streamed_set_profile_equals_resident(model, tmp_path):
    from dryad_tpu_torch.data.stream_dataset import StreamedDataset

    tb, _jb, _X, tds, _jds = model
    sds = StreamedDataset.from_dataset(tds, str(tmp_path / "bins.u8"),
                                       chunk_rows=128)
    for cap in (100, 4096):
        assert (build_reference_profile(tb, sds, max_rows=cap, device="cpu")
                == build_reference_profile(tb, tds, max_rows=cap,
                                           device="cpu"))


def test_port_trained_profile_equals_reference_over_converted(
        model, monkeypatch, tmp_path):
    """A port-trained model's profile (attached by ``dt.train``) equals the
    reference's profile computed over that model read into the reference
    and the reference's binning of the same rows."""
    _tb, _jb, X, tds, jds = model
    monkeypatch.setenv("DRYAD_PROFILE", "1")
    Xv, yv = higgs_like(300, seed=9)
    b = dt.train(PARAMS, tds, [tds.bind(Xv, yv)], device="cpu")
    assert isinstance(b.profile, ReferenceProfile)
    path = str(tmp_path / "port.dryad")
    b.save(path)
    jb = dryad_tpu.Booster.load(path)
    want = jprofile.build_reference_profile(
        jb, jds, [dryad_tpu.Dataset(Xv, yv, mapper=jds.mapper)])
    assert b.profile.to_json_dict() == want.to_json_dict()
    assert jb.profile.to_json_dict() == want.to_json_dict()
    monkeypatch.setenv("DRYAD_PROFILE", "0")
    assert dt.train(dict(PARAMS, num_trees=2), tds,
                    device="cpu").profile is None


@pytest.mark.parametrize("fmt", ["npz", "text"])
def test_profiles_cross_both_ways(model, tmp_path, fmt):
    tb, jb, _X, tds, _jds = model
    want = jb.profile.to_json_dict()
    p_ref, p_port = str(tmp_path / "ref"), str(tmp_path / "port")
    if fmt == "npz":
        jb.save(p_ref)
        tb.save(p_port)
    else:
        jb.save_text(p_ref)
        tb.save_text(p_port)
    assert dt.Booster.load_any(p_ref).profile.to_json_dict() == want
    assert dryad_tpu.Booster.load_any(p_port).profile.to_json_dict() == want
    again = dt.Booster.load_any(p_port)
    assert again.profile == tb.profile
    if fmt == "text":
        # floats and counts round-trip exactly: the re-dump is the same
        assert again.dump_text() == tb.dump_text()
        assert json.loads(tb.dump_text())["profile"] == json.loads(
            jb.dump_text())["profile"]


def test_profileless_files_load_both_ways(model, tmp_path):
    tb, jb, _X, tds, _jds = model
    saved_t, saved_j = tb.profile, jb.profile
    try:
        tb.profile = jb.profile = None
        for i, b in enumerate((tb, jb)):
            b.save(str(tmp_path / f"old{i}.dryad"))
            b.save_text(str(tmp_path / f"old{i}.txt"))
    finally:
        tb.profile, jb.profile = saved_t, saved_j
    for i in range(2):
        for ext in ("dryad", "txt"):
            path = str(tmp_path / f"old{i}.{ext}")
            old = dt.Booster.load_any(path)
            assert old.profile is None
            assert dryad_tpu.Booster.load_any(path).profile is None
            np.testing.assert_array_equal(
                old.predict_binned(tds.X_binned[:64], raw_score=True,
                                   device="cpu"),
                tb.predict_binned(tds.X_binned[:64], raw_score=True,
                                  device="cpu"))
    assert "profile" not in json.loads(
        dt.Booster.load_any(str(tmp_path / "old0.txt")).dump_text())


def test_profile_from_binned_synthesizes_baseline(model):
    tb, jb, _X, tds, _jds = model
    p = profile_from_binned(tb, tds.X_binned[:128], device="cpu")
    assert p.n_rows == 128 and "train" in p.score_hist
    assert p == ReferenceProfile.from_json_dict(
        jprofile.profile_from_binned(jb, tds.X_binned[:128]).to_json_dict())


# ---------------------------------------------------------------------------
# PSI and the score buckets against the reference


def test_score_buckets_and_index_match_reference():
    assert SCORE_BUCKETS == jdrift.SCORE_BUCKETS
    probes = list(SCORE_BUCKETS) + [SCORE_BUCKETS[0] - 1.0,
                                    SCORE_BUCKETS[-1] * 2, 0.0, -0.0,
                                    float("nan"), float("inf"),
                                    float("-inf"), 1e-7, -3.3, 12.5]
    probes += list(np.random.default_rng(3).normal(0, 3, 200))
    for v in probes:
        assert score_bucket_index(v) == jdrift.score_bucket_index(v), v
    for i, b in enumerate(SCORE_BUCKETS):
        assert score_bucket_index(b) == i
    assert score_bucket_index(float("nan")) == len(SCORE_BUCKETS)
    assert score_bucket_index(0.0) == len(SCORE_BUCKETS) // 2


def test_psi_and_budget_match_reference():
    rng = np.random.default_rng(5)
    cases = [([10, 10, 10], [10, 10, 10]), ([10, 10, 10], [1, 1, 28]),
             ([0, 0, 0], [1, 2, 3]), ([30, 0, 0], [0, 0, 30])]
    cases += [(list(rng.integers(0, 50, 33)), list(rng.integers(0, 50, 33)))
              for _ in range(20)]
    for ref, obs in cases:
        assert psi(ref, obs) == jdrift.psi(ref, obs)     # bitwise
    assert psi([10, 10, 10], [10, 10, 10]) == 0.0
    assert psi([10, 10, 10], [1, 1, 28]) > 0.5
    assert psi([0, 0, 0], [1, 2, 3]) == 0.0
    assert np.isfinite(psi([30, 0, 0], [0, 0, 30]))
    with pytest.raises(ValueError):
        psi([1, 2], [1, 2, 3])
    for spec in ("", "off", "none", "0.35", " OFF "):
        assert parse_psi_budget(spec) == jdrift.parse_psi_budget(spec)
    assert DEFAULT_PSI_BUDGET == jdrift.DEFAULT_PSI_BUDGET == 0.2


def _monitors(model, cls, k, window=10 ** 6):
    p = model[1].profile
    return [cls(p.feature_counts, ref_score_state=p.score_hist["train"],
                model="m", window_rows=window,
                registry=DISABLED if cls is DriftMonitor
                else jdrift_disabled()) for _ in range(k)]


def jdrift_disabled():
    from dryad_tpu.obs.registry import Registry as JRegistry

    return JRegistry(enabled=False)


def test_monitor_state_and_snapshot_match_reference(model):
    """Fed the same binned stream and scores (windows that rotate), the
    port's monitor exports the reference's state and PSI readout."""
    tb, _jb, _X, tds, _jds = model
    Xb = tds.X_binned
    for window in (256, 10 ** 6):
        (tm,) = _monitors(model, DriftMonitor, 1, window)
        (jm,) = _monitors(model, jdrift.DriftMonitor, 1, window)
        for i in range(0, 900, 75):
            b = _shift_binned(Xb[i:i + 75], by=i // 300)
            s = tb.predict_binned(b, raw_score=True, device="cpu")
            for m in (tm, jm):
                m.observe_features(b)
                m.observe_scores(s)
        assert tm.export_state() == jm.export_state()
        assert (tm.snapshot(DEFAULT_PSI_BUDGET)
                == jm.snapshot(DEFAULT_PSI_BUDGET))


def test_exact_merge_property_1_2_4_replicas(model):
    """Counts merged across k monitors equal one monitor fed the
    concatenation, bitwise, and PSI on the merge equals PSI on the
    concatenation exactly; the reference's merge and readout agree."""
    tb, _jb, _X, tds, _jds = model
    Xb = tds.X_binned
    batches = [Xb[i * 60:(i + 1) * 60] for i in range(8)]
    scores = [tb.predict_binned(b, raw_score=True, device="cpu")
              for b in batches]

    def fed(k: int):
        mons = _monitors(model, DriftMonitor, k)
        for i, (b, s) in enumerate(zip(batches, scores)):
            mons[i % k].observe_features(b)
            mons[i % k].observe_scores(s)
        blocks = [m.export_state() for m in mons]
        merged = merge_drift_states(blocks)
        assert merged == jdrift.merge_drift_states(blocks)
        return merged

    want = fed(1)
    for k in (2, 4):
        got = fed(k)
        assert got["features"] == want["features"]
        assert got["rows"] == want["rows"]
        assert got["score"][0] == want["score"][0]
        assert got["score"][2] == want["score"][2]
        ra = drift_report(got, budget_psi=0.2)
        rb = drift_report(want, budget_psi=0.2)
        assert ra["psi_max"] == rb["psi_max"]
        assert ra["score_psi"] == rb["score_psi"]
        assert ra["top"] == rb["top"]
        assert ra == jdrift.drift_report(got, budget_psi=0.2)
    with pytest.raises(ValueError):
        merge_drift_states([want, {"model": "m", "rows": 1, "bins": [2],
                                   "features": [[1, 0]]}])


def test_monitor_breach_and_no_false_positive(model):
    tb, _jb, _X, tds, _jds = model
    Xb = tds.X_binned
    (clean,) = _monitors(model, DriftMonitor, 1, 1024)
    clean.observe_features(Xb[:500])
    clean.observe_scores(tb.predict_binned(Xb[:500], raw_score=True,
                                           device="cpu"))
    r = clean.snapshot(DEFAULT_PSI_BUDGET)
    assert r["rows"] == 500 and not r["breached"]
    (shifted,) = _monitors(model, DriftMonitor, 1, 1024)
    sb = _shift_binned(Xb[:500])
    shifted.observe_features(sb)
    shifted.observe_scores(tb.predict_binned(sb, raw_score=True,
                                             device="cpu"))
    r2 = shifted.snapshot(DEFAULT_PSI_BUDGET)
    assert r2["breached"] and r2["psi_max"] > DEFAULT_PSI_BUDGET
    assert r2["top"] and r2["features_over"] >= 1


def test_window_rotation_forgets_old_traffic(model):
    tb, _jb, _X, tds, _jds = model
    Xb = tds.X_binned
    m = DriftMonitor(tb.profile.feature_counts, model="m", window_rows=800,
                     registry=DISABLED)
    m.observe_features(_shift_binned(Xb[:400]))
    assert drift_report(m.export_state(),
                        budget_psi=DEFAULT_PSI_BUDGET)["breached"]
    for start in range(0, 800, 400):        # two full epochs of clean rows
        m.observe_features(Xb[start:start + 400])
    r = drift_report(m.export_state(), budget_psi=DEFAULT_PSI_BUDGET)
    assert not r["breached"], r


def test_monitor_ignores_malformed_batches(model):
    p = model[0].profile
    m = DriftMonitor(p.feature_counts, model="m", registry=DISABLED)
    m.observe_features(np.zeros((0, p.num_features), np.uint8))
    m.observe_features(np.zeros((4, p.num_features + 3), np.uint8))
    m.observe_scores(np.zeros((0,), np.float32))
    assert m.export_state()["rows"] == 0
    m.observe_features(np.full((3, p.num_features), 255, np.uint8))
    st = m.export_state()
    assert st["rows"] == 3
    for c in st["features"]:
        assert c[-1] == 3 and sum(c) == 3
    m.observe_features(np.full((2, p.num_features), -1, np.int32))
    st = m.export_state()
    assert st["rows"] == 5
    for c in st["features"]:
        assert c[0] == 2 and sum(c) == 5


def test_monitor_gauges(model):
    tb, _jb, _X, tds, _jds = model
    reg = Registry()
    m = DriftMonitor(tb.profile.feature_counts, model="m1", window_rows=256,
                     registry=reg)
    m.observe_features(_shift_binned(tds.X_binned[:100]))
    r = m.snapshot(DEFAULT_PSI_BUDGET)
    snap = reg.snapshot()["gauges"]
    assert snap["dryad_drift_psi_max"]['model="m1"'] == r["psi_max"]
    assert snap["dryad_drift_rows"]['model="m1"'] == 100
    assert any(k.startswith('feature=') or 'feature=' in k
               for k in snap["dryad_drift_psi"])


# ---------------------------------------------------------------------------
# DriftGate


def test_gate_sustained_breach_hold_and_recovery():
    breaches: list = []
    gate = DriftGate(0.2, breach_after=2, registry=DISABLED,
                     on_breach=lambda m, v: breaches.append((m, v)))
    bad = {"m": {"rows": 100, "psi_max": 1.5, "score_psi": 0.0, "top": []}}
    good = {"m": {"rows": 100, "psi_max": 0.01, "score_psi": 0.0, "top": []}}
    empty = {"m": {"rows": 0, "psi_max": 0.0, "score_psi": 0.0, "top": []}}
    v1 = gate.evaluate(bad)
    assert v1["m"]["breached"] and not v1["m"]["sustained"]
    assert gate.ok and not breaches and gate.warnings() == []
    v2 = gate.evaluate(bad)
    assert v2["m"]["sustained"] and not gate.ok
    assert breaches == [("m", v2["m"])]
    assert gate.warnings() == ["drift:m"]
    v3 = gate.evaluate(empty)
    assert v3["m"]["sustained"] and gate.warnings() == ["drift:m"]
    assert len(breaches) == 1
    v4 = gate.evaluate(good)
    assert not v4["m"]["sustained"] and gate.ok and gate.warnings() == []
    gate.evaluate(bad)
    gate.evaluate(bad)
    assert len(breaches) == 2
    assert gate.verdicts()["m"]["sustained"]


def test_gate_verdicts_match_reference():
    from dryad_tpu.obs.health import HealthState as JHealth

    from dryad_tpu_torch.obs.health import HealthState

    rng = np.random.default_rng(2)
    th, jh = HealthState(DISABLED), JHealth(jdrift_disabled())
    tg = DriftGate(0.2, breach_after=2, degrade=True, registry=DISABLED,
                   health=th)
    jg = jdrift.DriftGate(0.2, breach_after=2, degrade=True,
                          registry=jdrift_disabled(), health=jh)
    for _ in range(40):
        reports = {m: {"rows": int(rng.integers(0, 3)) * 50,
                       "psi_max": float(rng.uniform(0, 0.4)),
                       "score_psi": float(rng.uniform(0, 0.25)),
                       "top": []} for m in ("a", "b")}
        assert tg.evaluate(reports) == jg.evaluate(reports)
        assert tg.warnings() == jg.warnings() and tg.ok == jg.ok
        assert sorted(th.reasons()) == sorted(jh.reasons())
    gate = DriftGate(0.2, breach_after=1, registry=DISABLED)
    v = gate.evaluate({"m": {"rows": 10, "psi_max": 0.0, "score_psi": 0.9,
                             "top": []}})
    assert v["m"]["sustained"]


# ---------------------------------------------------------------------------
# serving


@pytest.fixture()
def fresh_registry():
    reg = Registry()
    old = set_default_registry(reg)
    yield reg
    set_default_registry(old)


def test_serve_path_monitors_and_report(model, fresh_registry):
    tb, _jb, X, tds, _jds = model
    server = PredictServer(device="cpu", max_batch_rows=512,
                           max_wait_ms=0.5, drift_window=2048)
    server.registry.add(tb)
    with server:
        server.predict(X[:300])                        # raw rows
        server.predict(tds.X_binned[:200], binned=True)
        report = server.drift_report(DEFAULT_PSI_BUDGET)
    assert list(report) == ["v1"]
    r = report["v1"]
    assert r["rows"] == 500 and not r["breached"]
    state = server.drift_state()["v1"]
    assert state["score"][2] == 500
    assert state["ref_score"] is not None
    assert server.stats()["drift"]["v1"]["rows"] == 500
    # the same traffic through the reference's monitor gives the same state
    jm = jdrift.DriftMonitor(tb.profile.feature_counts,
                             ref_score_state=tb.profile.score_hist["train"],
                             model="v1", window_rows=2048,
                             registry=jdrift_disabled())
    for rows in (tds.X_binned[:300], tds.X_binned[:200]):
        jm.observe_features(rows)
        jm.observe_scores(tb.predict_binned(rows, raw_score=True,
                                            device="cpu"))
    assert jm.export_state() == state
    assert fresh_registry.snapshot()["gauges"]["dryad_drift_rows"][
        'model="v1"'] == 500


def test_serve_shifted_traffic_breaches(model, fresh_registry):
    tb, _jb, _X, tds, _jds = model
    server = PredictServer(device="cpu", max_batch_rows=64,
                           max_wait_ms=0.5, drift_window=256)
    server.registry.add(tb, name="champion")
    with server:
        server.predict(_shift_binned(tds.X_binned[:300]), binned=True)
        report = server.drift_report(DEFAULT_PSI_BUDGET)
    assert report["champion"]["breached"]


def test_serve_profileless_model_costs_one_probe(model, fresh_registry):
    tb, _jb, X, _tds, _jds = model
    saved = tb.profile
    try:
        tb.profile = None
        server = PredictServer(device="cpu", max_batch_rows=64,
                               max_wait_ms=0.5)
        server.registry.add(tb)
        with server:
            server.predict(X[:8])
            assert server._drift_monitors == {1: None}
            assert server.drift_report() == {}
            assert server.drift_state() == {}
        assert "drift" not in server.stats()
    finally:
        tb.profile = saved


def test_serve_drift_disabled_allocates_nothing(model):
    tb, _jb, X, _tds, _jds = model
    old = set_default_registry(Registry(enabled=False))
    try:
        server = PredictServer(device="cpu", max_batch_rows=64,
                               max_wait_ms=0.2)
        assert server._drift_monitors is None
        server.registry.add(tb)
        with server:
            rows = X[:2]
            for _ in range(16):
                server.predict(rows)

            def leaked() -> list:
                tracemalloc.start()
                for _ in range(100):
                    server.predict(rows)
                snap_mem = tracemalloc.take_snapshot()
                tracemalloc.stop()
                return [st for st in snap_mem.statistics("filename")
                        if st.traceback[0].filename.endswith(
                            ("obs/drift.py", "data/profile.py"))]

            for _ in range(3):
                bad = leaked()
                if not bad:
                    break
            assert not bad, f"disabled drift path allocated: {bad}"
        assert server.drift_report() == {}
    finally:
        set_default_registry(old)


def test_serve_drift_off_flag(model):
    assert PredictServer(device="cpu", drift="off")._drift_monitors is None
    assert PredictServer(device="cpu",
                         drift_window=0)._drift_monitors is None
    assert PredictServer(device="cpu")._drift_monitors == {}


def test_served_answers_equal_with_drift_on_and_off(model):
    tb, _jb, X, _tds, _jds = model
    outs = []
    for drift in ("auto", "off"):
        server = PredictServer(device="cpu", max_batch_rows=64,
                               max_wait_ms=0.5, drift=drift)
        server.registry.add(tb)
        with server:
            outs.append(server.predict(X[:200], raw_score=True))
    np.testing.assert_array_equal(outs[0], outs[1])


# ---------------------------------------------------------------------------
# bench and trends


def test_trends_track_drift_overhead():
    from dryad_tpu_torch.obs.trends import _direction, _spread_fields_of

    assert _direction("drift_overhead_ms") == "lower_better"
    assert _direction("drift_overhead_pct") == "lower_better"
    assert _spread_fields_of("drift_overhead_ms") == (
        "drift_overhead_spread",)
    assert _direction("drift_overhead_spread") is None


def test_bench_drift_arm_smoke(model):
    from dryad_tpu_torch.serve.bench import run_bench_drift

    tb = model[0]
    out = run_bench_drift(tb, device="cpu", clients=2, duration_s=0.2,
                          sizes=(1, 3), arms=1, max_batch_rows=64)
    for key in ("drift_overhead_ms", "drift_overhead_pct",
                "drift_overhead_spread"):
        assert key in out
    assert out["drift_windows"]
