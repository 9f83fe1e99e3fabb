"""Continual boosting in the port (``dryad_tpu_torch/continual/`` and
``python -m dryad_tpu_torch retrain``): the counterpart of
``tests/test_continual.py``.

* The warm-start append (``dryad_tpu_torch.train(init_model=)``) against
  the reference's ``dryad.train(init_model=, backend="cpu")`` on the same
  fixture: tree arrays equal, leaf values within fp32 rounding; two port
  appends and a killed-and-resumed append are bitwise equal.
* The scheduler and the publisher run with the reference's fake
  launchers, pushes and verdicts, beside the reference's classes on the
  same inputs: the journals match event for event (walls aside).
* ``model_has_profile`` sniffs both model formats, of either package, in
  a fresh interpreter that never imports torch.
* ``retrain --device cpu`` as a subprocess: the ``bad_generation`` drill
  through the production launcher, a directory of npz shards, and
  ``--refit-decay`` refused on a directory.
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

import dryad_tpu as dryad
from dryad_tpu.datasets import higgs_like

import dryad_tpu_torch as dt
from dryad_tpu_torch.continual import (JournalTailer, ProbationPublisher,
                                       RetrainScheduler,
                                       make_subprocess_launcher,
                                       model_has_profile)
from dryad_tpu_torch.resilience import (FaultInjector, RetryPolicy,
                                        RunJournal, supervise_train)
from dryad_tpu_torch.resilience import faults as F
from torch_layout import one_torch_thread, port_of  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = dict(objective="binary", num_trees=6, num_leaves=7, max_bins=32,
              seed=3, min_data_in_leaf=5)
APPEND_TREES = 4
INT_KEYS = ("feature", "threshold", "left", "right", "default_left",
            "is_cat", "cat_bitset")


def _sub_env(**extra) -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def corpus():
    return higgs_like(1500, seed=21)


@pytest.fixture(scope="module")
def base_model(corpus):
    """The reference's CPU-trained base, and the port's copy of it."""
    X, y = corpus
    ref = dryad.train(PARAMS, dryad.Dataset(X, y, max_bins=32),
                      backend="cpu")
    return ref, port_of(ref)


@pytest.fixture(scope="module")
def fresh_rows():
    return higgs_like(1100, seed=77)


@pytest.fixture(scope="module")
def fresh(fresh_rows, base_model):
    """Fresh rows binned into the base model's frozen bin space (the only
    well-defined append corpus), in the port."""
    X, y = fresh_rows
    return dt.Dataset(X, y, mapper=base_model[1].mapper)


@pytest.fixture(scope="module")
def appended(base_model, fresh):
    """The port's append of APPEND_TREES trees on the fresh rows."""
    return dt.train(dict(PARAMS, num_trees=APPEND_TREES), fresh,
                    device="cpu", init_model=base_model[1])


def _same_trees(a, b) -> None:
    ta, tb = a.tree_arrays(), b.tree_arrays()
    for k in INT_KEYS + ("value",):
        np.testing.assert_array_equal(np.asarray(ta[k]), np.asarray(tb[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(np.asarray(a.init_score),
                                  np.asarray(b.init_score))


# ---- warm-start append: against the reference, and the bitwise pins -------

def test_append_matches_reference_and_is_reproducible(base_model, fresh,
                                                      fresh_rows, appended):
    ref_base, base = base_model
    p = dict(PARAMS, num_trees=APPEND_TREES)
    a = appended
    b = dt.train(p, fresh, device="cpu", init_model=base)
    assert a.num_iterations == PARAMS["num_trees"] + APPEND_TREES
    _same_trees(a, b)
    # the base model's trees are a strict prefix: an append never rewrites
    # what is already serving
    n0 = base.tree_arrays()["feature"].shape[0]
    for k in ("feature", "value"):
        np.testing.assert_array_equal(np.asarray(a.tree_arrays()[k])[:n0],
                                      np.asarray(base.tree_arrays()[k]))
    # the reference's append of the same rows: the tree contract
    X, y = fresh_rows
    r = dryad.train(p, dryad.Dataset(X, y, mapper=ref_base.mapper),
                    backend="cpu", init_model=ref_base)
    ta, tr = a.tree_arrays(), r.tree_arrays()
    for k in INT_KEYS:
        np.testing.assert_array_equal(np.asarray(ta[k]), np.asarray(tr[k]),
                                      err_msg=k)
    np.testing.assert_allclose(np.asarray(ta["value"]),
                               np.asarray(tr["value"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(np.asarray(a.init_score, np.float32),
                                  np.asarray(r.init_score, np.float32))


def test_append_zero_trees_is_identity(base_model, fresh, corpus):
    """trees=0 is a pure re-wrap: predictions bitwise the input model's
    (and the reference's), the base score carried from the MODEL, not
    re-derived from the fresh rows' labels."""
    ref_base, base = base_model
    X, _ = corpus
    out = dt.train(dict(PARAMS, num_trees=0), fresh, device="cpu",
                   init_model=base)
    assert out.num_iterations == base.num_iterations
    np.testing.assert_array_equal(base.predict(X, device="cpu"),
                                  out.predict(X, device="cpu"))
    np.testing.assert_array_equal(out.predict(X, device="cpu"),
                                  ref_base.predict(X))
    np.testing.assert_array_equal(
        np.asarray(base.init_score, np.float32),
        np.asarray(out.init_score, np.float32))


def test_append_zero_trees_without_init_model_rejected(fresh):
    with pytest.raises(ValueError, match="num_trees=0"):
        dt.train(dict(PARAMS, num_trees=0), fresh, device="cpu")


def test_append_kill_and_resume_bitwise(base_model, fresh, appended,
                                       tmp_path):
    """A faulted append resumes from its checkpoint and finishes bitwise
    the uninterrupted append: the retrain worker can die mid-run without
    changing the generation it ships."""
    _, base = base_model
    p = dict(PARAMS, num_trees=APPEND_TREES)
    straight = appended
    injector = FaultInjector([
        (base.num_iterations + 2, F.DEVICE_UNAVAILABLE, "dispatch")])
    jpath = str(tmp_path / "j.jsonl")
    resumed = supervise_train(
        p, fresh, device="cpu", init_model=base,
        checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=1,
        journal=jpath, fault_injector=injector,
        policy=RetryPolicy(backoff_base_s=0.0))
    assert injector.pending == 0
    _same_trees(straight, resumed)
    resumes = [e for e in RunJournal.read(jpath) if e["event"] == "resume"]
    # the retry continued PAST the warm start: it never redid the base
    assert resumes and resumes[0]["from_iteration"] > base.num_iterations


def test_append_rejects_foreign_bin_space(base_model):
    _, base = base_model
    X, y = higgs_like(900, seed=91)
    resketched = dt.Dataset(X, y, max_bins=32)      # its OWN mapper
    with pytest.raises(ValueError, match="frozen bin space"):
        dt.train(dict(PARAMS, num_trees=2), resketched, device="cpu",
                 init_model=base)


def test_append_rejects_tree_geometry_change(base_model, fresh):
    _, base = base_model
    with pytest.raises(ValueError, match="max_nodes"):
        dt.train(dict(PARAMS, num_trees=2, num_leaves=15), fresh,
                 device="cpu", init_model=base)


# ---- generation artifacts ---------------------------------------------------

def test_generation_roundtrips_both_formats(fresh, base_model, tmp_path,
                                            monkeypatch):
    """A generation ships through either model format with its OWN fresh
    reference profile, and loads in the reference too."""
    monkeypatch.setenv("DRYAD_PROFILE", "1")
    _, base = base_model
    gen = dt.train(dict(PARAMS, num_trees=APPEND_TREES), fresh,
                   device="cpu", init_model=base)
    assert gen.profile is not None
    Xp = higgs_like(64, seed=1)[0]
    native = str(tmp_path / "g.dryad")
    text = str(tmp_path / "g.txt")
    gen.save(native)
    gen.save_text(text)
    want = gen.predict(Xp, device="cpu")
    for path in (native, text):
        back = dt.Booster.load_any(path)
        assert back.num_iterations == PARAMS["num_trees"] + APPEND_TREES
        np.testing.assert_array_equal(want, back.predict(Xp, device="cpu"))
        assert back.profile is not None, path
        assert model_has_profile(path)
        ref = dryad.Booster.load_any(path)
        np.testing.assert_array_equal(want, ref.predict(Xp))
        assert ref.profile is not None, path


def test_model_has_profile_sniffs_without_torch(base_model, fresh, tmp_path,
                                                monkeypatch):
    """The scheduler's gate reads artifact metadata only, in a process
    that never imports torch: profile-less artifacts answer False in both
    formats, a generation with its profile True, whichever package wrote
    the file."""
    ref_base, base = base_model
    monkeypatch.setenv("DRYAD_PROFILE", "0")
    bare = dt.train(dict(PARAMS, num_trees=2), fresh, device="cpu",
                    init_model=base)
    monkeypatch.setenv("DRYAD_PROFILE", "1")
    gen = dt.train(dict(PARAMS, num_trees=2), fresh, device="cpu",
                   init_model=base)
    assert bare.profile is None and gen.profile is not None
    files = {}
    for tag, b in (("bare", bare), ("gen", gen)):
        files[f"{tag}.dryad"] = b.save
        files[f"{tag}.txt"] = b.save_text
    files["ref.dryad"] = ref_base.save          # the reference's, no profile
    files["ref.txt"] = ref_base.save_text
    for name, save in files.items():
        save(str(tmp_path / name))
    code = (
        "import json, sys\n"
        "from dryad_tpu_torch.continual import model_has_profile\n"
        f"d = {str(tmp_path)!r}\n"
        f"names = {sorted(files)!r}\n"
        "out = {n: model_has_profile(d + '/' + n) for n in names}\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('torch', 'jax', 'dryad_tpu'))\n"
        "print(json.dumps({'has': out, 'bad': bad}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=_sub_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    doc = json.loads(out.stdout)
    assert doc["bad"] == []
    assert doc["has"] == {"bare.dryad": False, "bare.txt": False,
                          "gen.dryad": True, "gen.txt": True,
                          "ref.dryad": False, "ref.txt": False}


# ---- the retrain scheduler, beside the reference's --------------------------

def _pkg(which: str) -> dict:
    if which == "ref":
        from dryad_tpu.continual import (JournalTailer as JT,
                                         ProbationPublisher as PP,
                                         RetrainScheduler as RS)
        from dryad_tpu.continual import model_has_profile as mhp
        from dryad_tpu.resilience import RetryPolicy as RP
        return dict(RetrainScheduler=RS, ProbationPublisher=PP,
                    RetryPolicy=RP, model_has_profile=mhp, JournalTailer=JT)
    return dict(RetrainScheduler=RetrainScheduler,
                ProbationPublisher=ProbationPublisher,
                RetryPolicy=RetryPolicy, model_has_profile=model_has_profile,
                JournalTailer=JournalTailer)


class Rec:
    """Recording journal callable (the FleetSupervisor.journal shape)."""

    def __init__(self):
        self.events = []

    def __call__(self, kind, **fields):
        self.events.append(dict(fields, event=kind))

    def of(self, kind, **match):
        return [e for e in self.events if e["event"] == kind
                and all(e.get(k) == v for k, v in match.items())]

    def comparable(self) -> list:
        """The events without their walls (the one run-dependent field)."""
        return [{k: v for k, v in e.items() if k != "wall_s"}
                for e in self.events]


def _sched(pkg, models, launch, journal, **kw):
    kw.setdefault("policy", pkg["RetryPolicy"](backoff_base_s=0.0,
                                               retry_budget=3))
    kw.setdefault("has_profile", lambda p: True)
    return pkg["RetrainScheduler"](models, launch, journal=journal, **kw)


def _both(case) -> list:
    """Run ``case(pkg) -> Rec`` for the reference and the port; assert the
    journals match event for event; return the port's Rec."""
    recs = {which: case(_pkg(which)) for which in ("ref", "port")}
    assert recs["port"].comparable() == recs["ref"].comparable()
    return recs["port"]


def test_scheduler_skips_profileless_model(tmp_path, base_model):
    """A profile-less artifact is SKIPPED with a journaled reason: no
    launch, no crash (there is no baseline to retrain against)."""
    ref_base, _ = base_model
    path = str(tmp_path / "old.dryad")
    ref_base.save(path)
    launched = []

    def case(pkg):
        rec = Rec()
        rs = _sched(pkg, {"legacy": path},
                    lambda m, g, j, a: launched.append(m) or (True, a, ""),
                    rec, has_profile=pkg["model_has_profile"])
        assert rs.trigger("legacy") is False
        assert not rs.state()["inflight"]
        return rec

    rec = _both(case)
    assert not launched
    assert len(rec.of("retrain_skipped", model="legacy",
                      reason="no_profile")) == 1


def test_scheduler_skips_unknown_and_unreadable(tmp_path):
    def case(pkg):
        rec = Rec()
        rs = _sched(pkg, {"m": str(tmp_path / "missing.dryad")},
                    lambda *a: (True, "x", ""), rec,
                    has_profile=pkg["model_has_profile"])
        assert rs.trigger("ghost") is False
        # the artifact does not exist: sniffing raises, the scheduler lives
        assert rs.trigger("m") is False
        return rec

    rec = _both(case)
    assert rec.of("retrain_skipped", model="ghost", reason="unknown_model")
    assert any(e["reason"].startswith("artifact_unreadable")
               for e in rec.of("retrain_skipped", model="m"))


def test_scheduler_debounce_inflight_and_cooldown():
    """One sustained breach = one retrain: concurrent duplicates fall to
    in_flight, post-completion duplicates to cooldown."""
    def case(pkg):
        gate = threading.Event()
        done = threading.Event()
        launches = []

        def launch(model, gen, job, artifact):
            launches.append((model, gen, job))
            gate.wait(10.0)
            return True, f"{artifact}-g{gen}", ""

        rec = Rec()
        rs = _sched(pkg, {"m": "art"}, launch, rec, cooldown_s=3600.0)
        orig = rs._retrain_job

        def tracked(*a, **kw):
            try:
                orig(*a, **kw)
            finally:
                done.set()

        rs._retrain_job = tracked
        assert rs.trigger("m") is True
        assert rs.trigger("m") is False      # the worker holds in_flight
        gate.set()
        assert done.wait(10.0)
        assert rs.trigger("m") is False      # now inside the cooldown
        assert launches == [("m", 1, 0)]
        rs.stop(timeout_s=5.0)
        return rec

    rec = _both(case)
    assert rec.of("retrain_skipped", model="m", reason="in_flight")
    assert rec.of("retrain_skipped", model="m", reason="cooldown")
    assert len(rec.of("retrain_triggered", model="m")) == 1
    assert len(rec.of("retrain_complete", model="m", generation=1)) == 1


def test_scheduler_failure_backoff_and_budget():
    """Launch failures journal retrain_failed and arm the per-model
    backoff; a spent retry budget stops the scheduler from flapping."""
    def case(pkg):
        rec = Rec()
        rs = _sched(pkg, {"m": "art"}, lambda *a: (False, None, "rc=9"),
                    rec, cooldown_s=0.0,
                    policy=pkg["RetryPolicy"](backoff_base_s=0.0,
                                              backoff_max_s=0.0,
                                              retry_budget=1))
        for _ in range(4):
            rs.trigger("m")
            deadline = 100                    # wait the worker out
            while rs.state()["inflight"] and deadline:
                deadline -= 1
                threading.Event().wait(0.05)
        assert rs.state()["generation"].get("m", 0) == 0
        return rec

    rec = _both(case)
    fails = rec.of("retrain_failed", model="m")
    assert fails and all(e["detail"] == "rc=9" for e in fails)
    # budget exhausted: later triggers are skipped, not launched
    assert rec.of("retrain_skipped", model="m",
                  reason="retry_budget_exhausted")


def test_journal_tailer_incremental_partial_lines(tmp_path):
    path = str(tmp_path / "j.jsonl")
    t = JournalTailer(path)
    assert t() == []                          # nothing yet: not an error
    with open(path, "a") as f:
        f.write(json.dumps({"event": "a"}) + "\n")
        f.write('{"event": "b", "tr')         # torn mid-record
    got = t()
    assert [e["event"] for e in got] == ["a"]
    with open(path, "a") as f:
        f.write('uncated": 1}\n')
        f.write("not json at all\n")
        f.write(json.dumps({"event": "c"}) + "\n")
    got = t()                                 # the torn line heals whole
    assert [e["event"] for e in got] == ["b", "c"]
    assert t() == []
    # a tailer that starts at the end reads only what comes after
    late = JournalTailer(path, start_at_end=True)
    with open(path, "a") as f:
        f.write(json.dumps({"event": "d"}) + "\n")
    assert [e["event"] for e in late()] == ["d"]


# ---- the probation publisher, beside the reference's ------------------------

def _verdict(rows=128, breached=False, sustained=False, psi=0.05):
    return {"rows": rows, "breached": breached, "sustained": sustained,
            "psi_max": psi, "score_psi": 0.0, "streak": 0, "top": []}


def _publish(feed, push_ok=True, **kw):
    """Publish ``gen`` over ``feed`` with both packages' publishers;
    returns (outcome, pushes, Rec) of the port after the journals
    matched."""
    results = {}

    def case(pkg):
        rec = Rec()
        pushes = []
        it = iter(feed)

        def verdicts():
            return {"m": next(it)}

        def push(path, model):
            pushes.append(path)
            return (True, "") if push_ok else (False, "drain timeout")

        kw.setdefault("probation_polls", len(feed))
        pub = pkg["ProbationPublisher"](push, verdicts, journal=rec,
                                        poll_interval_s=0.0, **kw)
        out = pub.publish("gen1", model="m", prior_path="gen0",
                          generation=1)
        results[id(rec)] = (out, pushes)
        return rec

    recs = {which: case(_pkg(which)) for which in ("ref", "port")}
    assert recs["port"].comparable() == recs["ref"].comparable()
    assert results[id(recs["port"])] == results[id(recs["ref"])]
    out, pushes = results[id(recs["port"])]
    return out, pushes, recs["port"]


def test_publisher_promotes_on_clear():
    out, pushes, rec = _publish([_verdict(rows=0), _verdict(), _verdict()],
                                clear_after=2)
    assert out == "promoted"
    assert pushes == ["gen1"]                 # promote never re-pushes
    assert rec.of("push_probation", model="m", generation=1)
    promo = rec.of("generation_promoted", model="m", generation=1)
    assert len(promo) == 1 and promo[0]["path"] == "gen1"


def test_publisher_rolls_back_bad_generation():
    """Prior clean + pushed generation sustains a breach => the PRIOR
    ARTIFACT is re-pushed through the same rolling machinery; the
    registry is never mutated in place."""
    feed = [_verdict(),                                    # prior: clean
            _verdict(breached=True, psi=0.9),
            _verdict(breached=True, sustained=True, psi=0.9)]
    out, pushes, rec = _publish(feed)
    assert out == "rolled_back"
    assert pushes == ["gen1", "gen0"]         # the rollback IS a re-push
    rb = rec.of("generation_rolled_back", model="m", generation=1)
    assert len(rb) == 1
    assert rb[0]["prior"] == "gen0" and rb[0]["restore_ok"] is True
    assert not rec.of("generation_promoted", model="m", generation=1)


def test_publisher_no_rollback_when_prior_was_dirty():
    """If the PREDECESSOR was already breaching at push time, a breach in
    probation proves nothing against the new generation."""
    feed = ([_verdict(breached=True, sustained=True)]      # prior: dirty
            + [_verdict(breached=True, sustained=True)] * 3)
    out, pushes, rec = _publish(feed)
    assert out == "promoted"                  # window expired, kept
    assert pushes == ["gen1"]
    promo = rec.of("generation_promoted", model="m", generation=1)
    assert len(promo) == 1 and promo[0]["verdict"] == "expired"
    assert not rec.of("generation_rolled_back")


def test_publisher_push_failure_is_terminal():
    out, _, rec = _publish([_verdict()], push_ok=False)
    assert out == "push_failed"
    assert rec.of("push_failed", model="m", generation=1)
    assert not rec.of("push_probation")


def test_publisher_empty_windows_do_not_clear():
    """rows == 0 is no evidence: a generation must not promote off an
    idle fleet's empty drift windows."""
    feed = [_verdict()] + [_verdict(rows=0)] * 3
    out, _, rec = _publish(feed, clear_after=1, probation_polls=3)
    assert out == "promoted"
    assert rec.of("generation_promoted", model="m",
                  generation=1)[0]["verdict"] == "expired"


# ---- the retrain worker as a subprocess -------------------------------------

@pytest.fixture(scope="module")
def base_file(base_model, tmp_path_factory):
    """The port's base saved WITH a profile (the scheduler's gate)."""
    _, base = base_model
    d = tmp_path_factory.mktemp("retrain")
    X, y = higgs_like(1500, seed=21)
    from dryad_tpu_torch.data.profile import build_reference_profile

    b = dt.Booster.load_any(_save(base, str(d / "plain.dryad")))
    b.profile = build_reference_profile(
        b, dt.Dataset(X, y, mapper=base.mapper), device="cpu")
    return _save(b, str(d / "base.dryad"))


def _save(b, path: str) -> str:
    b.save(path)
    return path


def test_retrain_worker_bad_generation_through_the_launcher(
        base_model, base_file, fresh_rows, tmp_path):
    """The production launcher runs ``retrain --device cpu`` with the
    ``bad_generation`` drill armed at job 1: the worker trains on the
    covariates scaled by 0.25, bitwise the in-process append on them."""
    X, y = fresh_rows
    data = str(tmp_path / "fresh.npz")
    np.savez(data, X=X.astype(np.float32), y=y)
    spec = F.encode_points([F.FaultPoint(site="retrain", iteration=1,
                                         kind=F.BAD_GENERATION)])
    launch = make_subprocess_launcher(
        data, str(tmp_path / "out"), trees=2, device="cpu", timeout_s=300,
        extra_env={F.CONTINUAL_FAULTS_ENV: spec, "OMP_NUM_THREADS": "1",
                   "PYTHONPATH": ROOT})
    ok, out_path, detail = launch("m", 1, 1, base_file)
    assert ok, detail
    assert out_path.endswith("m-gen1.dryad")
    log = open(str(tmp_path / "out" / "retrain-m-g1.log")).read()
    summary = json.loads(log.strip().splitlines()[-1])
    assert summary["fault"] == F.BAD_GENERATION and summary["profile"]
    assert summary["trees_after"] == PARAMS["num_trees"] + 2
    gen = dt.Booster.load_any(out_path)
    base = dt.Booster.load_any(base_file)
    want = dt.train(dict(PARAMS, num_trees=2),
                    dt.Dataset(X.astype(np.float32) * np.float32(0.25), y,
                               mapper=base.mapper),
                    device="cpu", init_model=base)
    _same_trees(gen, want)
    assert gen.profile is not None


def test_retrain_worker_streams_a_shard_directory(base_file, fresh_rows,
                                                  tmp_path):
    """A directory of npz shards streams through the frozen mapper and
    appends bitwise the resident append on the same rows; the spill is
    removed."""
    X, y = fresh_rows
    d = tmp_path / "shards"
    d.mkdir()
    np.savez(d / "a.npz", X=X[:500].astype(np.float32), y=y[:500])
    np.savez(d / "b.npz", X=X[500:].astype(np.float32), y=y[500:])
    out = str(tmp_path / "g.dryad")
    res = subprocess.run(
        [sys.executable, "-m", "dryad_tpu_torch", "retrain", "--model",
         base_file, "--data", str(d), "--out", out, "--trees", "2",
         "--device", "cpu", "--text"],
        cwd=ROOT, env=_sub_env(), capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr
    summary = json.loads(res.stdout.strip().splitlines()[-1])
    assert summary["fault"] is None and summary["trees_after"] == 8
    assert not os.path.exists(out + ".bins")
    gen = dt.Booster.load_any(out)
    base = dt.Booster.load_any(base_file)
    want = dt.train(dict(PARAMS, num_trees=2),
                    dt.Dataset(X.astype(np.float32), y, mapper=base.mapper),
                    device="cpu", init_model=base)
    _same_trees(gen, want)


def test_retrain_refit_decay_refused_on_a_directory(base_file, tmp_path):
    d = tmp_path / "shards"
    d.mkdir()
    res = subprocess.run(
        [sys.executable, "-m", "dryad_tpu_torch", "retrain", "--model",
         base_file, "--data", str(d), "--out", str(tmp_path / "g.dryad"),
         "--refit-decay", "0.9", "--device", "cpu"],
        cwd=ROOT, env=_sub_env(), capture_output=True, text=True,
        timeout=300)
    assert res.returncode != 0
    assert "--refit-decay needs a resident npz corpus" in res.stderr
    assert not (tmp_path / "g.dryad").exists()
