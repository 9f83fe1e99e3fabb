"""The port's metrics exporter, run journal and its tail, the training
loop's spans and the SLO gate, against the reference on the CPU.

* The exporter's ``/healthz`` (always open), ``/stats``, ``/metrics`` and
  ``/trace`` and its bearer auth (``tests/test_obs.py:423``).
* ``JournalTail``: parity with ``RunJournal.read()``, the reset on a new
  ``run_start``, partial lines (``tests/test_obs.py:262-339``), on
  journals written by the port's ``RunJournal`` and by the reference's;
  ``read_last_run`` equals the reference's.
* The loop's spans (``tests/test_obs.py:396-421``): ``train.iteration``
  counts ``num_trees``, ``train.grow`` lies within it, the fetch spans
  appear, the ``dryad_train_iteration`` gauge is set, and a disabled
  registry stays empty.
* ``SloGate`` (``tests/test_fleet_trace.py:232-343``): the verdicts equal
  the reference gate's on the same histogram states, with sustained
  breach, hold, recovery and independent priorities.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from dryad_tpu.datasets import higgs_like
from dryad_tpu.obs import health as jhealth
from dryad_tpu.obs import registry as jregistry
from dryad_tpu.obs import slo as jslo
from dryad_tpu.resilience.journal import RunJournal as JRunJournal

import dryad_tpu_torch as dt
from dryad_tpu_torch.obs import spans as S
from dryad_tpu_torch.obs.exporter import start_exporter
from dryad_tpu_torch.obs.health import HealthState
from dryad_tpu_torch.obs.journal_tail import JournalTail
from dryad_tpu_torch.obs.registry import (REQUEST_LATENCY, Registry,
                                          set_default_registry)
from dryad_tpu_torch.obs.slo import DEFAULT_BUDGETS_MS, SloGate, parse_budgets
from dryad_tpu_torch.obs.trace_export import disable_tracing, enable_tracing
from dryad_tpu_torch.resilience.journal import RunJournal
from torch_layout import one_torch_thread  # noqa: F401 (autouse)

PARAMS = dict(objective="binary", num_trees=6, num_leaves=7, max_bins=32,
              seed=3, min_data_in_leaf=5)


@pytest.fixture(scope="module")
def data():
    X, y = higgs_like(1500, seed=21)
    return dt.Dataset(X, y, max_bins=32), X, y


@pytest.fixture()
def fresh_registry():
    reg = Registry()
    old = set_default_registry(reg)
    yield reg
    set_default_registry(old)


def _get(url, token=None, timeout=5):
    headers = {"Authorization": f"Bearer {token}"} if token else {}
    req = urllib.request.Request(url, headers=headers)
    return urllib.request.urlopen(req, timeout=timeout).read()


def _parse_exposition(text):
    values = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name_lbl, val = line.rsplit(" ", 1)
            values[name_lbl] = float(val)
    return values


# ---- the exporter ------------------------------------------------------------

def test_exporter_endpoints_and_bearer_auth():
    reg = Registry()
    reg.counter("dryad_thing_total", "a thing").inc(3)
    with S.span("stage", reg):
        pass
    ex = start_exporter(reg, port=0, auth_token="s3cret",
                        extra_stats=[lambda: {"extra": 1},
                                     lambda: 1 / 0])
    try:
        assert json.loads(_get(ex.url + "/healthz")) == {"ok": True}
        for path in ("/stats", "/metrics", "/trace"):
            with pytest.raises(urllib.error.HTTPError) as err:
                _get(ex.url + path)
            assert err.value.code == 401
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(ex.url + "/stats", token="wrong")
        assert err.value.code == 401
        stats = json.loads(_get(ex.url + "/stats", token="s3cret"))
        assert stats["counters"]["dryad_thing_total"][""] == 3
        assert stats["spans"]["stage"]["count"] == 1
        assert stats["uptime_s"] >= 0
        assert stats["extra"] == 1 and stats["stats_errors"]
        text = _get(ex.url + "/metrics", token="s3cret").decode()
        assert "# TYPE dryad_thing_total counter" in text
        assert _parse_exposition(text)["dryad_thing_total"] == 3
        doc = json.loads(_get(ex.url + "/trace", token="s3cret"))
        assert doc["displayTimeUnit"] == "ms"
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(ex.url + "/nope", token="s3cret")
        assert err.value.code == 404
    finally:
        ex.stop()


def test_exporter_trace_serves_the_ring_and_stats_match_reference():
    reg = Registry()
    buf = enable_tracing()
    try:
        buf.clear()
        with S.span("outer", reg):
            with S.span("inner", reg):
                pass
        with start_exporter(reg, port=0) as ex:
            doc = json.loads(_get(ex.url + "/trace"))
        names = [e["name"] for e in doc["traceEvents"] if e["ph"] == "X"]
        assert names == ["outer", "inner"]
    finally:
        disable_tracing()
        buf.clear()
    # the span summary has the reference's shape and values
    from dryad_tpu.obs import spans as jspans

    jreg = jregistry.Registry()
    for r, mod in ((reg, S), (jreg, jspans)):
        mod.record_at("a/b", 1.0, 0.25, registry=r)
        mod.record("c", 0.5, registry=r)
    got = {k: v for k, v in S.snapshot(reg).items() if k in ("a/b", "c")}
    assert got == jspans.snapshot(jreg)


# ---- the run journal and its tail -------------------------------------------

def _write_events(journal_cls, jpath):
    with journal_cls(jpath) as j:
        j.event("run_start", checkpoint_dir="ck", retry_budget=5)
        j.event("segment_start", attempt=0, resume_iteration=0, ch_max=0)
        for i in (0, 4, 8):
            j.event("chunk_dispatch", iteration=i)
        j.event("chunk_fetch", iteration=8)
        j.event("fault", kind="fetch_death", site="fetch", iteration=8)
        j.event("backoff_chunks", ch_max_from=0, ch_max_to=2,
                cap_consulted=True, changed=True)
        j.event("resume", attempt=1, from_iteration=8, sleep_s=0.0)
        j.event("segment_start", attempt=1, resume_iteration=8, ch_max=2)
        j.event("fail_closed", reason="budget")
        j.event("complete", wall_s=1.25, iterations=16, faults=1)


JOURNALS = pytest.mark.parametrize("journal_cls", [RunJournal, JRunJournal],
                                   ids=["port_journal", "reference_journal"])


@JOURNALS
def test_journal_tail_parity_with_read(tmp_path, journal_cls):
    jpath = str(tmp_path / "j.jsonl")
    _write_events(journal_cls, jpath)
    events = RunJournal.read(jpath)
    assert [{k: v for k, v in e.items() if k != "elapsed_s"}
            for e in events] == [
        {k: v for k, v in e.items() if k != "elapsed_s"}
        for e in JRunJournal.read(jpath)]
    reg = Registry()
    tail = JournalTail(jpath, reg)
    n = tail.poll()
    assert n == len(events) == tail.events_seen
    per_kind = {}
    for e in events:
        per_kind[e["event"]] = per_kind.get(e["event"], 0) + 1
    ev_counter = reg.counter("dryad_run_events_total")
    for kind, cnt in per_kind.items():
        assert ev_counter.labels(event=kind).value() == cnt, kind
    assert reg.counter("dryad_run_faults_total").labels(
        kind="fetch_death").value() == 1
    assert reg.counter("dryad_run_chunk_backoffs_total").value() == 1
    assert reg.counter("dryad_run_resumes_total").value() == 1
    assert reg.counter("dryad_run_fail_closed_total").value() == 1
    assert reg.gauge("dryad_run_ch_max").value() == 2
    assert reg.gauge("dryad_run_resume_iteration").value() == 8
    assert reg.gauge("dryad_run_iteration").value() == 8
    assert reg.gauge("dryad_run_attempt").value() == 1
    assert reg.gauge("dryad_run_wall_seconds").value() == 1.25
    assert reg.gauge("dryad_run_iterations").value() == 16
    assert tail.poll() == 0
    assert ev_counter.labels(event="fault").value() == 1
    # the reference's tail folds the same file into the same series
    from dryad_tpu.obs.journal_tail import JournalTail as JTail

    jreg = jregistry.Registry()
    JTail(jpath, jreg).poll()
    assert reg.snapshot() == jreg.snapshot()


@JOURNALS
def test_journal_tail_resets_on_new_run_start(tmp_path, journal_cls):
    jpath = str(tmp_path / "j.jsonl")
    _write_events(journal_cls, jpath)
    reg = Registry()
    tail = JournalTail(jpath, reg)
    tail.poll()
    assert reg.counter("dryad_run_faults_total").labels(
        kind="fetch_death").value() == 1
    with journal_cls(jpath) as j:
        j.event("run_start", checkpoint_dir="ck", retry_budget=5)
        j.event("segment_start", attempt=0, resume_iteration=16, ch_max=0)
        j.event("chunk_dispatch", iteration=16)
        j.event("complete", wall_s=0.5, iterations=24, faults=0)
    tail.poll()
    assert reg.counter("dryad_run_faults_total").labels(
        kind="fetch_death").value() == 0
    assert reg.counter("dryad_run_resumes_total").value() == 0
    assert reg.gauge("dryad_run_wall_seconds").value() == 0.5
    assert reg.gauge("dryad_run_iterations").value() == 24
    assert reg.counter("dryad_run_events_total").labels(
        event="run_start").value() == 1
    assert reg.counter("dryad_run_events_total").labels(
        event="chunk_dispatch").value() == 1
    last = RunJournal.read_last_run(jpath)
    assert [e["event"] for e in last] == [
        e["event"] for e in JRunJournal.read_last_run(jpath)]
    assert [e["event"] for e in last] == [
        "run_start", "segment_start", "chunk_dispatch", "complete"]


def test_journal_tail_carries_partial_lines(tmp_path):
    jpath = str(tmp_path / "j.jsonl")
    reg = Registry()
    tail = JournalTail(jpath, reg)
    assert tail.poll() == 0                      # no file yet
    with open(jpath, "a") as fh:
        fh.write('{"event": "run_start"}\n{"event": "fau')
        fh.flush()
        assert tail.poll() == 1
        fh.write('lt", "kind": "oom"}\nnot json\n')
        fh.flush()
    assert tail.poll() == 1                      # the torn line, once
    assert reg.counter("dryad_run_faults_total").labels(
        kind="oom").value() == 1


def test_journal_tail_thread_folds_a_live_journal(tmp_path):
    jpath = str(tmp_path / "j.jsonl")
    reg = Registry()
    with RunJournal(jpath) as j, JournalTail(jpath, reg,
                                             poll_interval_s=0.01):
        j.event("run_start")
        j.event("chunk_dispatch", iteration=3)
    # stop() ran one last poll
    assert reg.gauge("dryad_run_iteration").value() == 3


# ---- the training loop's spans ----------------------------------------------

def test_loop_records_iteration_grow_and_fetch_spans(data, fresh_registry):
    ds, X, y = data
    dt.train(PARAMS, ds, device="cpu")
    snap = S.snapshot(fresh_registry)
    assert snap["train.iteration"]["count"] == PARAMS["num_trees"]
    assert snap["train.grow"]["count"] == PARAMS["num_trees"]
    assert snap["train.grow"]["total_s"] <= snap["train.iteration"]["total_s"]
    assert snap["train.fetch.final"]["count"] == 1
    assert fresh_registry.gauge("dryad_train_iteration").value() \
        == PARAMS["num_trees"] - 1


def test_loop_spans_eval_checkpoint_and_multiclass(data, fresh_registry,
                                                   tmp_path):
    ds, X, y = data
    vds = ds.bind(X[:300], y[:300])
    # a callback makes evals synchronous: one eval fetch an iteration
    dt.train(PARAMS, ds, [vds], callbacks=[lambda it, info: None],
             checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2,
             device="cpu")
    snap = S.snapshot(fresh_registry)
    assert snap["train.fetch.eval"]["count"] == PARAMS["num_trees"]
    assert snap["train.fetch.checkpoint"]["count"] == 3
    cls = (y > 0).astype(np.int64) + (X[:, 0] > 0)
    mds = dt.Dataset(X, cls.astype(np.float32), max_bins=32)
    before = snap["train.grow"]["count"]
    dt.train(dict(PARAMS, objective="multiclass", num_class=3, num_trees=2),
             mds, device="cpu")
    # one grow span an iteration, over its K trees
    assert S.snapshot(fresh_registry)["train.grow"]["count"] == before + 2


def test_disabled_registry_unchanged_by_training(data, fresh_registry):
    ds, _X, _y = data
    fresh_registry.disable()
    dt.train(PARAMS, ds, device="cpu")
    assert fresh_registry.snapshot() == {
        "counters": {}, "gauges": {}, "histograms": {}}


# ---- the SLO gate ------------------------------------------------------------

def _hist(*values):
    h = Registry().log_histogram(REQUEST_LATENCY)
    for v in values:
        h.observe(v)
    return h.value()


def test_slo_gate_sustained_breach_hold_and_recovery():
    reg = Registry()
    health = HealthState(registry=reg)
    gate = SloGate({"interactive": 10.0}, breach_after=2, registry=reg,
                   health=health)
    slow = _hist(*[0.5] * 5)
    v1 = gate.evaluate({"interactive": slow})
    assert v1["interactive"]["breached"]
    assert not v1["interactive"]["sustained"]
    assert health.ok and gate.ok
    v2 = gate.evaluate({"interactive": slow})
    assert v2["interactive"]["sustained"] and not health.ok and not gate.ok
    assert "slo:interactive" in health.reasons()
    v3 = gate.evaluate({"interactive": ([0] * 62, 0.0, 0)})
    assert v3["interactive"]["sustained"] and not health.ok
    gate.evaluate({"interactive": _hist(*[0.001] * 5)})
    assert health.ok and gate.ok
    assert reg.gauge("dryad_slo_breach_streak").labels(
        priority="interactive").value() == 0


def test_slo_gate_verdicts_match_reference():
    """Random windows on two priorities: the port's verdicts, gauges and
    health reasons equal the reference gate's on the same states."""
    rng = np.random.default_rng(4)
    treg, jreg = Registry(), jregistry.Registry()
    th, jh = HealthState(registry=treg), jhealth.HealthState(registry=jreg)
    budgets = {"interactive": 10.0, "bulk": 80.0}
    tg = SloGate(budgets, breach_after=3, registry=treg, health=th)
    jg = jslo.SloGate(budgets, breach_after=3, registry=jreg, health=jh)
    for _ in range(60):
        states = {}
        for pr in budgets:
            n = int(rng.integers(0, 3)) * 4
            states[pr] = _hist(*rng.choice([0.001, 0.05, 0.5], size=n))
        assert tg.evaluate(states) == jg.evaluate(states)
        assert tg.ok == jg.ok
        assert sorted(th.reasons()) == sorted(jh.reasons())
    assert (treg.snapshot()["gauges"]["dryad_slo_p_ms"]
            == jreg.snapshot()["gauges"]["dryad_slo_p_ms"])


def test_slo_gate_fires_at_exactly_breach_after_and_priorities():
    reg = Registry()
    health = HealthState(registry=reg)
    gate = SloGate({"interactive": 10.0, "bulk": 2000.0}, breach_after=3,
                   registry=reg, health=health)
    slow, fast = _hist(*[0.5] * 5), _hist(*[0.001] * 5)
    for i in (1, 2):
        v = gate.evaluate({"interactive": slow, "bulk": fast})
        assert v["interactive"]["streak"] == i
        assert not v["interactive"]["sustained"] and health.ok
    v = gate.evaluate({"interactive": slow, "bulk": fast})
    assert v["interactive"]["sustained"] and v["bulk"]["streak"] == 0
    assert "slo:interactive" in health.reasons()
    assert "slo:bulk" not in health.reasons()
    clean = gate.evaluate({"interactive": fast})["interactive"]
    assert clean["streak"] == 0 and gate.ok


def test_parse_budgets_and_defaults():
    assert DEFAULT_BUDGETS_MS == jslo.DEFAULT_BUDGETS_MS
    for spec in ("", "interactive=5,bulk=80.5", "off", "none"):
        assert parse_budgets(spec) == jslo.parse_budgets(spec)
    with pytest.raises(ValueError):
        parse_budgets("nonsense")
    gate = SloGate({}, breach_after=1, registry=Registry())
    assert gate.evaluate({"interactive": ([0] * 62, 0.0, 0)}) == {}
    assert gate.ok
