"""The port's Chrome trace export (``dryad_tpu_torch.obs.trace_export``)
and span trace sink: the counterparts of all 12 cases of
``tests/test_trace_export.py``.

Valid trace_event JSON (object form, required keys), non-decreasing ts,
span nesting kept (a child's interval inside its parent's on one tid),
journal instants and stage walls on their own pids, the exporter's
``/trace``, and ``train --trace-out`` with ``--device cpu`` (the sink
removed after the run).  One more case holds the port's documents equal
to the reference's renderer on the same events.
"""

import json
import time
import urllib.request

import numpy as np
import pytest

from dryad_tpu.obs import trace_export as jtrace

from dryad_tpu_torch.obs import spans
from dryad_tpu_torch.obs.exporter import MetricsExporter
from dryad_tpu_torch.obs.registry import Registry
from dryad_tpu_torch.obs.trace_export import (
    SpanTrace,
    default_trace,
    disable_tracing,
    dumps_trace,
    enable_tracing,
    fleet_trace_events,
    to_trace_events,
    write_trace,
)
from torch_layout import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture()
def sink():
    buf = SpanTrace(capacity=1024)
    spans.set_trace_sink(buf.record)
    yield buf
    spans.set_trace_sink(None)


def _nested_spans(reg, sink):
    with spans.span("tree", registry=reg):
        with spans.span("level", registry=reg):
            with spans.span("stage", registry=reg):
                time.sleep(0.002)
            time.sleep(0.001)
    return sink.events()


def test_sink_captures_nested_paths(sink):
    events = _nested_spans(Registry(), sink)
    paths = [e[0] for e in events]
    # spans complete innermost-first
    assert paths == ["tree/level/stage", "tree/level", "tree"]


def test_sink_disabled_registry_records_nothing(sink):
    with spans.span("quiet", registry=Registry(enabled=False)):
        pass
    assert sink.events() == []


def test_record_feeds_the_sink(sink):
    spans.record("loop_body", 0.004, registry=Registry())
    ((path, t0, dur, _tid, trace),) = sink.events()
    assert path == "loop_body" and abs(dur - 0.004) < 1e-9
    assert trace is None                     # record() is untagged


def test_record_at_tags_the_trace(sink):
    reg = Registry()
    spans.record_at("serve.request/predict", 10.0, 0.25,
                    trace="abc123", registry=reg)
    ((path, t0, dur, _tid, trace),) = sink.events()
    assert (path, t0, dur, trace) == (
        "serve.request/predict", 10.0, 0.25, "abc123")
    # the span series got the same completion
    assert reg.counter(spans.COUNT).labels(
        span="serve.request/predict").value() == 1
    # and the rendered trace carries the id in args
    evs = [e for e in to_trace_events(span_events=sink.events())
           if e["ph"] == "X"]
    assert evs[0]["args"]["trace"] == "abc123"


def test_trace_events_schema_monotonic_and_nested(sink):
    events = _nested_spans(Registry(), sink)
    trace = to_trace_events(span_events=events)
    data = [e for e in trace if e["ph"] == "X"]
    # required trace_event keys on every event
    for e in trace:
        assert {"ph", "pid", "tid", "name", "ts"} <= set(e) or e["ph"] == "M"
    # ts monotonic non-decreasing over the whole list
    ts = [e["ts"] for e in trace if "ts" in e]
    assert ts == sorted(ts)
    # nesting: child interval inside parent interval, parent sorts first
    by_path = {e["args"]["path"]: e for e in data}
    parent = by_path["tree"]
    child = by_path["tree/level/stage"]
    assert parent["ts"] <= child["ts"]
    assert child["ts"] + child["dur"] <= parent["ts"] + parent["dur"] + 1e-3
    assert data[0]["args"]["path"] == "tree"   # longest-first at equal ts


def test_trace_json_loads_and_has_object_form(sink):
    events = _nested_spans(Registry(), sink)
    doc = json.loads(dumps_trace(span_events=events))
    assert isinstance(doc["traceEvents"], list) and doc["traceEvents"]
    assert doc["displayTimeUnit"] == "ms"


def test_journal_events_render_as_instants(tmp_path):
    journal = [
        {"event": "run_start", "elapsed_s": 0.0},
        {"event": "fault", "elapsed_s": 1.25, "kind": "fetch_death",
         "detail": {"nested": "dropped"}},
        {"event": "resume", "elapsed_s": 2.5, "from_iteration": 40},
    ]
    trace = to_trace_events(journal_events=journal)
    inst = [e for e in trace if e["ph"] == "i"]
    assert [e["name"] for e in inst] == ["run_start", "fault", "resume"]
    assert all(e["pid"] == 2 for e in inst)
    assert inst[1]["ts"] == 1.25e6
    assert inst[1]["args"]["kind"] == "fetch_death"
    assert "detail" not in inst[1]["args"]     # non-scalar args dropped
    assert inst[2]["args"]["from_iteration"] == 40


def test_stage_walls_lay_out_back_to_back():
    stages = [{"stage": "hist_segmented", "ms": 136.0, "spread": 0.02},
              {"stage": "deep_level", "arm": "wired", "ms": 51.4}]
    trace = to_trace_events(stages=stages)
    xs = [e for e in trace if e["ph"] == "X"]
    assert [e["name"] for e in xs] == ["hist_segmented", "deep_level[wired]"]
    assert xs[0]["ts"] == 0.0 and xs[0]["dur"] == 136.0 * 1e3
    assert xs[1]["ts"] == 136.0 * 1e3 and xs[1]["dur"] == 51.4 * 1e3
    assert all(e["pid"] == 3 for e in xs)


def test_ring_capacity_bounds_and_counts_drops():
    buf = SpanTrace(capacity=4)
    for i in range(10):
        buf.record(f"s{i}", float(i), 0.001)
    assert len(buf.events()) == 4 and buf.dropped == 6
    buf.clear()
    assert buf.events() == [] and buf.dropped == 0


def test_trace_endpoint_serves_the_default_ring():
    reg = Registry()
    buf = enable_tracing()
    try:
        buf.clear()
        assert default_trace() is buf
        with spans.span("served_span", registry=reg):
            pass
        with MetricsExporter(reg) as exporter:
            body = urllib.request.urlopen(exporter.url + "/trace",
                                          timeout=5).read()
        doc = json.loads(body)
        names = [e["name"] for e in doc["traceEvents"]
                 if e["ph"] == "X"]
        assert "served_span" in names
    finally:
        disable_tracing()
        buf.clear()


def test_write_trace_file(tmp_path, sink):
    events = _nested_spans(Registry(), sink)
    out = tmp_path / "trace.json"
    write_trace(str(out), span_events=events)
    doc = json.loads(out.read_text())
    assert len([e for e in doc["traceEvents"] if e["ph"] == "X"]) == 3


def test_renderers_match_reference(sink):
    events = _nested_spans(Registry(), sink) + [
        ("serve.request/predict", 12.0, 0.25, 7, "abc")]
    journal = [{"event": "run_start", "elapsed_s": 0.0},
               {"event": "fault", "elapsed_s": 1.5, "kind": "oom"}]
    stages = [{"stage": "hist_segmented", "ms": 2.9},
              {"stage": "deep_level", "arm": "wired", "ms": 1.4}]
    assert (to_trace_events(events, journal, stages)
            == jtrace.to_trace_events(events, journal, stages))
    tracks = [{"pid": 5, "name": "r0", "events": events, "offset_s": 3.0}]
    assert (fleet_trace_events(tracks, journal, keep={"abc"})
            == jtrace.fleet_trace_events(tracks, journal, keep={"abc"}))
    assert (fleet_trace_events(tracks, keep={"zzz"})
            == jtrace.fleet_trace_events(tracks, keep={"zzz"}))


def test_train_cli_trace_out(tmp_path):
    """--trace-out on the train CLI writes a Perfetto-loadable document
    carrying the loop's span tree."""
    from dryad_tpu.datasets import higgs_like

    from dryad_tpu_torch.__main__ import main

    X, y = higgs_like(1500, seed=13)
    np.save(tmp_path / "X.npy", X)
    np.save(tmp_path / "y.npy", y)
    cfg = dict(objective="binary", num_trees=3, num_leaves=7, max_bins=32)
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    trace_path = tmp_path / "run.trace.json"
    rc = main(["train", "--config", str(tmp_path / "cfg.json"),
               "--data", str(tmp_path / "X.npy"),
               "--label", str(tmp_path / "y.npy"),
               "--device", "cpu", "--quiet",
               "--trace-out", str(trace_path)])
    assert rc == 0 and trace_path.exists()
    # the sink must be uninstalled after the run
    assert spans._TRACE_SINK is None
    doc = json.loads(trace_path.read_text())
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert xs, "the loop's spans must appear in the trace"
    names = [e["name"] for e in xs]
    assert names.count("train.iteration") == 3
    assert "train.fetch.final" in names
    ts = [e["ts"] for e in doc["traceEvents"] if "ts" in e]
    assert ts == sorted(ts)
