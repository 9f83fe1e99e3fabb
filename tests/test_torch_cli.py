"""The port's ``train``, ``predict`` and ``dump`` commands on the CPU: the
counterparts of ``tests/test_cli.py:26-50,106-126,175-185``.

* A round trip of ``train`` (with a valid set and ``--log-jsonl``),
  ``predict`` and ``dump`` (JSON and ``--text``) with ``--device cpu``;
  the model file carries its drift baseline, loads in the reference and
  predicts there bitwise, profile included.
* CSR ``.npz`` input through ``bin_csr``.
* Argument parsing and the guards that run before any data loads.
* ``--metrics-port`` with ``DRYAD_METRICS_HOLD_S``: ``/healthz``,
  ``/metrics`` and ``/stats`` scraped during the hold show the loop's 5
  iterations.
* ``serve --drift-window 0`` serves without monitors; the default window
  serves with one.
* ``train --supervise --journal --retry-budget`` and their usage errors
  (before any data loads); a supervised run's journal, tailed into the
  registry under ``--metrics-port``, reads with the reference's
  ``RunJournal.read`` and folds in its ``JournalTail``; a directory left
  by a sticky CUDA error resumes through ``--supervise --resume`` bitwise
  the straight run.
* ``fleet`` and ``retrain``: their usage errors, before any spawn or load.
"""

import io
import json
import os
import socket
import threading
import time
import urllib.request
from contextlib import redirect_stdout

import numpy as np
import pytest

import dryad_tpu
from dryad_tpu.datasets import criteo_like, higgs_like
from dryad_tpu.metrics import auc

import dryad_tpu_torch as dt
from dryad_tpu_torch.__main__ import main
from torch_layout import one_torch_thread  # noqa: F401 (autouse)

CFG = dict(objective="binary", num_trees=5, num_leaves=7, max_bins=32)


@pytest.fixture()
def paths(tmp_path):
    X, y = higgs_like(2000, seed=41)
    np.save(tmp_path / "X.npy", X)
    np.save(tmp_path / "y.npy", y)
    np.save(tmp_path / "Xv.npy", X[:500])
    np.save(tmp_path / "yv.npy", y[:500])
    (tmp_path / "cfg.json").write_text(json.dumps(CFG))
    return tmp_path


def _train(paths, *extra):
    return main(["train", "--config", str(paths / "cfg.json"),
                 "--data", str(paths / "X.npy"),
                 "--label", str(paths / "y.npy"),
                 "--device", "cpu", "--quiet", *extra])


def test_train_predict_dump_roundtrip(paths, monkeypatch):
    monkeypatch.setenv("DRYAD_PROFILE", "1")
    model = str(paths / "m.dryad")
    assert _train(paths, "--valid", str(paths / "Xv.npy"),
                  "--valid-label", str(paths / "yv.npy"),
                  "--model", model,
                  "--log-jsonl", str(paths / "log.jsonl")) == 0
    lines = [json.loads(line) for line in open(paths / "log.jsonl")]
    assert len(lines) == 5 and "valid_auc" in lines[0]
    b = dt.Booster.load(model)
    assert b.profile is not None
    assert sorted(b.profile.score_hist) == ["train", "valid"]

    assert main(["predict", "--model", model, "--data",
                 str(paths / "X.npy"), "--out", str(paths / "p.npy"),
                 "--device", "cpu"]) == 0
    assert main(["predict", "--model", model, "--data",
                 str(paths / "X.npy"), "--out", str(paths / "r.npy"),
                 "--device", "cpu", "--raw"]) == 0
    preds, raw = np.load(paths / "p.npy"), np.load(paths / "r.npy")
    X, y = np.load(paths / "X.npy"), np.load(paths / "y.npy")
    assert auc(y, preds) > 0.6
    # the port's file predicts bitwise in the reference, profile included
    jb = dryad_tpu.Booster.load(model)
    np.testing.assert_array_equal(jb.predict(X), preds)
    np.testing.assert_array_equal(jb.predict(X, raw_score=True), raw)
    assert jb.profile.to_json_dict() == b.profile.to_json_dict()

    assert main(["dump", "--model", model, "--out",
                 str(paths / "m.json")]) == 0
    dump = json.loads((paths / "m.json").read_text())
    assert dump["num_iterations"] == 5 and len(dump["trees"]) == 5
    assert main(["dump", "--model", model, "--text", "--out",
                 str(paths / "m.txt")]) == 0
    again = dt.Booster.load_any(str(paths / "m.txt"))
    assert again.profile == b.profile
    np.testing.assert_array_equal(
        again.predict(X, raw_score=True, device="cpu"), raw)
    # the text model is the predict command's input too
    assert main(["predict", "--model", str(paths / "m.txt"), "--data",
                 str(paths / "X.npy"), "--out", str(paths / "t.npy"),
                 "--device", "cpu"]) == 0
    np.testing.assert_array_equal(np.load(paths / "t.npy"), preds)


def test_cli_csr_npz_train_predict(tmp_path):
    (indptr, indices, values, F), y, cat_ids = criteo_like(n=2000, seed=43)
    np.savez(tmp_path / "X.npz", indptr=indptr, indices=indices,
             values=values, num_features=F)
    np.save(tmp_path / "y.npy", y)
    cfg = dict(objective="binary", num_trees=4, num_leaves=15, max_bins=64,
               categorical_features=list(cat_ids))
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    model = str(tmp_path / "m.dryad")
    assert main(["train", "--config", str(tmp_path / "cfg.json"),
                 "--data", str(tmp_path / "X.npz"), "--label",
                 str(tmp_path / "y.npy"), "--model", model,
                 "--device", "cpu", "--quiet"]) == 0
    assert main(["predict", "--model", model, "--data",
                 str(tmp_path / "X.npz"), "--out", str(tmp_path / "p.npy"),
                 "--device", "cpu"]) == 0
    preds = np.load(tmp_path / "p.npy")
    assert preds.shape == (2000,) and auc(y, preds) > 0.55
    # the reference's CLI predicts the port's file bitwise on the same CSR
    from dryad_tpu.__main__ import main as jmain

    assert jmain(["predict", "--model", model, "--data",
                  str(tmp_path / "X.npz"),
                  "--out", str(tmp_path / "jp.npy")]) == 0
    np.testing.assert_array_equal(np.load(tmp_path / "jp.npy"), preds)


def test_cli_arg_parsing_and_guards(paths, monkeypatch, capsys):
    with pytest.raises(SystemExit):                 # --data is required
        main(["train", "--label", "y.npy"])
    with pytest.raises(SystemExit):                 # no such device
        main(["train", "--data", "x", "--label", "y", "--device", "tpu"])
    with pytest.raises(SystemExit):
        main(["predict", "--model", "m"])           # --data, --out
    with pytest.raises(SystemExit):
        main(["dump"])                              # --model
    with pytest.raises(SystemExit):
        main(["serve"])                             # --model
    with pytest.raises(SystemExit):
        main(["serve", "--model", "m.dryad", "--device", "gpu"])
    capsys.readouterr()
    missing = str(paths / "absent.npy")
    # the guards run before any data is read (the files do not exist)
    with pytest.raises(SystemExit, match="--valid requires --valid-label"):
        main(["train", "--data", missing, "--label", missing,
              "--valid", missing, "--device", "cpu", "--quiet"])
    with pytest.raises(SystemExit, match="--resume requires"):
        main(["train", "--data", missing, "--label", missing, "--resume",
              "--device", "cpu", "--quiet"])
    monkeypatch.setenv("DRYAD_METRICS_HOLD_S", "soon")
    with pytest.raises(SystemExit, match="DRYAD_METRICS_HOLD_S"):
        main(["train", "--data", missing, "--label", missing,
              "--device", "cpu", "--quiet"])
    monkeypatch.delenv("DRYAD_METRICS_HOLD_S")
    with pytest.raises(SystemExit, match="--request requires --out"):
        main(["serve", "--model", str(paths / "nope.dryad"),
              "--request", str(paths / "X.npy"), "--device", "cpu"])
    # a failing run still stops its exporter and removes the trace sink
    from dryad_tpu_torch.obs import spans

    with pytest.raises(FileNotFoundError):
        main(["train", "--data", missing, "--label", missing,
              "--device", "cpu", "--quiet", "--metrics-port", "0",
              "--trace-out", str(paths / "t.json")])
    assert spans._TRACE_SINK is None
    assert json.loads((paths / "t.json").read_text())["traceEvents"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_metrics_port_serves_the_run_during_the_hold(paths, monkeypatch):
    from dryad_tpu_torch.obs.registry import Registry

    # a registry of this run's own, restored after it
    monkeypatch.setattr("dryad_tpu_torch.obs.registry._default", Registry())
    port = _free_port()
    monkeypatch.setenv("DRYAD_METRICS_HOLD_S", "4")
    result = {}

    def run():
        try:
            result["rc"] = _train(paths, "--metrics-port", str(port),
                                  "--model", str(paths / "m.dryad"))
        except BaseException as e:  # noqa: BLE001 — surfaced below
            result["error"] = e

    base = f"http://127.0.0.1:{port}"
    t = threading.Thread(target=run)
    t.start()
    try:
        stats = None
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and t.is_alive():
            try:
                stats = json.loads(urllib.request.urlopen(
                    base + "/stats", timeout=5).read())
            except OSError:
                stats = None
            if stats and stats["spans"].get("train.fetch.final"):
                break
            time.sleep(0.05)
        assert stats is not None, result
        assert stats["spans"]["train.iteration"]["count"] == 5
        assert stats["gauges"]["dryad_train_iteration"][""] == 4
        assert "ok" in stats["bench_trends"]      # the trends provider
        assert json.loads(urllib.request.urlopen(
            base + "/healthz", timeout=5).read())["ok"] is True
        text = urllib.request.urlopen(base + "/metrics",
                                      timeout=5).read().decode()
        assert "dryad_span_count_total" in text
    finally:
        t.join(60)
    assert result == {"rc": 0}
    assert os.path.exists(paths / "m.dryad")     # saved after the hold
    with pytest.raises(OSError):
        urllib.request.urlopen(base + "/healthz", timeout=2)


def test_serve_drift_window_zero_serves_without_monitors(paths,
                                                         monkeypatch):
    monkeypatch.setenv("DRYAD_PROFILE", "1")
    model = str(paths / "m.dryad")
    assert _train(paths, "--model", model) == 0
    outs, stats = [], []
    for window in ("0", "8192"):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert main(["serve", "--model", model, "--device", "cpu",
                         "--max-batch-rows", "64", "--drift-window", window,
                         "--request", str(paths / "X.npy"),
                         "--out", str(paths / f"s{window}.npy")]) == 0
        text = buf.getvalue()
        stats.append(json.loads(text[text.index("{"):]))
        outs.append(np.load(paths / f"s{window}.npy"))
    assert "drift" not in stats[0]
    assert stats[1]["drift"]["v1"]["rows"] == 2000
    np.testing.assert_array_equal(outs[0], outs[1])
    assert main(["predict", "--model", model, "--data",
                 str(paths / "X.npy"), "--out", str(paths / "d.npy"),
                 "--device", "cpu"]) == 0
    np.testing.assert_array_equal(outs[0], np.load(paths / "d.npy"))


def test_cli_supervise_flags_and_usage_errors(paths, tmp_path):
    missing = str(paths / "absent.npy")
    base = ["train", "--data", missing, "--label", missing, "--device",
            "cpu", "--quiet"]
    with pytest.raises(SystemExit, match="--supervise requires "
                                         "--checkpoint-dir"):
        main(base + ["--supervise"])
    with pytest.raises(SystemExit, match="--journal is the supervised"):
        main(base + ["--journal", str(tmp_path / "j.jsonl")])
    with pytest.raises(SystemExit, match="--retry-budget configures"):
        main(base + ["--retry-budget", "2"])
    ck = tmp_path / "ck"
    ck.mkdir()
    (ck / "ckpt_00000004.dryad").write_bytes(b"")
    with pytest.raises(SystemExit, match="pass --resume"):
        main(base + ["--supervise", "--checkpoint-dir", str(ck)])
    # the guard creates no directory it asks about
    fresh = tmp_path / "not_made"
    with pytest.raises(FileNotFoundError):
        main(base + ["--supervise", "--checkpoint-dir", str(fresh)])
    assert not fresh.exists()


def test_cli_supervised_journal_reads_in_the_reference(paths, monkeypatch):
    from dryad_tpu.obs.journal_tail import JournalTail as RefTail
    from dryad_tpu.obs.registry import Registry as RefRegistry
    from dryad_tpu.resilience.journal import RunJournal as RefJournal

    from dryad_tpu_torch.obs.registry import Registry

    reg = Registry()
    monkeypatch.setattr("dryad_tpu_torch.obs.registry._default", reg)
    cfg = dict(CFG, max_depth=4, deep_layout="legacy")
    (paths / "cfg.json").write_text(json.dumps(cfg))
    journal = str(paths / "run.jsonl")
    model = str(paths / "m.dryad")
    assert _train(paths, "--supervise", "--checkpoint-dir",
                  str(paths / "ck"), "--checkpoint-every", "2",
                  "--journal", journal, "--retry-budget", "2",
                  "--metrics-port", "0", "--model", model) == 0
    events = RefJournal.read(journal)
    assert events[0]["event"] == "run_start"
    assert events[0]["retry_budget"] == 2
    assert events[-1]["event"] == "complete"
    assert events[-1]["iterations"] == cfg["num_trees"]
    # the port's tail folded the run into its registry during the run
    snap = reg.snapshot()
    assert snap["counters"]["dryad_run_events_total"][
        'event="complete"'] == 1
    assert snap["gauges"]["dryad_run_iterations"][""] == cfg["num_trees"]
    # and the reference's tail folds the same journal
    rreg = RefRegistry()
    tail = RefTail(journal, registry=rreg)
    assert tail.poll() == len(events)
    rsnap = rreg.snapshot()
    assert rsnap["counters"]["dryad_run_events_total"] == snap["counters"][
        "dryad_run_events_total"]
    straight = dt.train(cfg, dt.Dataset(np.load(paths / "X.npy"),
                                        np.load(paths / "y.npy"),
                                        max_bins=cfg["max_bins"]),
                        device="cpu")
    got = dt.Booster.load(model)
    for k, v in straight.tree_arrays().items():
        np.testing.assert_array_equal(got.tree_arrays()[k], v, err_msg=k)


def test_cli_resumes_a_sticky_fault_in_a_fresh_run(paths):
    """A sticky CUDA error leaves the checkpoint directory behind (the
    supervisor fails closed); ``train --supervise --resume`` continues it
    to the straight run's trees."""
    import torch

    from dryad_tpu_torch.resilience import (FaultError, RunJournal,
                                            supervise_train)

    # depth 4 on the legacy arm: the plain versions' cheapest route
    cfg = dict(CFG, num_trees=8, max_depth=4, deep_layout="legacy")
    (paths / "cfg.json").write_text(json.dumps(cfg))
    ds = dt.Dataset(np.load(paths / "X.npy"), np.load(paths / "y.npy"),
                    max_bins=cfg["max_bins"])
    ck, journal = str(paths / "ck"), str(paths / "run.jsonl")

    def sticky(site, it):
        if site == "dispatch" and it == 6:
            raise torch.AcceleratorError(
                "CUDA error: an illegal memory access was encountered")

    with pytest.raises(FaultError, match="fresh process"):
        supervise_train(cfg, ds, device="cpu", checkpoint_dir=ck,
                        checkpoint_every=4, journal=journal,
                        fault_injector=sticky)
    assert RunJournal.read(journal)[-1]["reason"] == "sticky_device_error"
    model = str(paths / "m.dryad")
    assert _train(paths, "--supervise", "--resume", "--checkpoint-dir", ck,
                  "--checkpoint-every", "4", "--journal", journal,
                  "--model", model) == 0
    last = RunJournal.read_last_run(journal)
    assert last[1]["resume_iteration"] == 4
    assert last[-1]["event"] == "complete"
    straight = dt.train(cfg, ds, device="cpu")
    got = dt.Booster.load(model)
    for k, v in straight.tree_arrays().items():
        np.testing.assert_array_equal(got.tree_arrays()[k], v, err_msg=k)


def test_cli_fleet_and_retrain_usage_errors(tmp_path, monkeypatch, capsys):
    """``fleet`` and ``retrain``: argument parsing, and the guards that run
    before any replica is spawned or any model or data is read (none of
    the files exist)."""
    monkeypatch.setenv("DRYAD_TRACE", "0")     # no trace sink left behind
    missing = str(tmp_path / "absent.dryad")
    with pytest.raises(SystemExit):
        main(["retrain"])                          # --model, --data, --out
    with pytest.raises(SystemExit):
        main(["retrain", "--model", missing, "--data", missing, "--out",
              missing, "--device", "tpu"])         # no such device
    with pytest.raises(SystemExit):
        main(["fleet"])                            # --model
    with pytest.raises(SystemExit):
        main(["fleet", "--model", missing, "--device", "tpu"])
    with pytest.raises(SystemExit):
        main(["fleet", "--model", missing, "--retrain-device", "tpu"])
    capsys.readouterr()
    shards = tmp_path / "shards"
    shards.mkdir()
    with pytest.raises(SystemExit, match="--refit-decay needs a resident"):
        main(["retrain", "--model", missing, "--data", str(shards),
              "--out", missing, "--refit-decay", "0.9", "--device", "cpu"])
    with pytest.raises(SystemExit, match="--continual-data requires "
                                         "--journal"):
        main(["fleet", "--model", f"m={missing}", "--continual-data",
              missing])
    with pytest.raises(SystemExit, match="NAME=path model specs"):
        main(["fleet", "--model", missing, "--continual-data", missing,
              "--journal", str(tmp_path / "j.jsonl")])
    with pytest.raises(SystemExit, match="--model-cap wants NAME=N"):
        main(["fleet", "--model", missing, "--model-cap", "fraud"])
    with pytest.raises(SystemExit, match="--min-replicas <= "
                                         "--max-replicas"):
        main(["fleet", "--model", missing, "--min-replicas", "3",
              "--max-replicas", "2"])
    # the port's flags and defaults: the card, unless asked for the CPU
    from dryad_tpu_torch.__main__ import build_parser

    args = build_parser().parse_args(["fleet", "--model", missing])
    assert (args.device, args.retrain_device) == ("cuda", "cuda")
    args = build_parser().parse_args(["retrain", "--model", missing,
                                      "--data", missing, "--out", missing])
    assert args.device == "cuda" and args.trees == 20
