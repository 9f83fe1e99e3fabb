"""Supervised training in the port (``dryad_tpu_torch/resilience``, M15b):
the counterpart of ``tests/test_resilience.py`` and
``tests/test_resilience_sweep.py``, on the CPU.

* Classification of the reference's signatures and of CUDA's (OOM,
  NCCL/gloo failures, the sticky errors and ``is_sticky``), injection,
  the chunk-cap ladder.
* The mixed-fault soak: bitwise the unsupervised port run, and the same
  trees as the reference's ``supervise_train`` on its CPU trainer
  (integer arrays equal, leaf values within 1e-6: the port's fixed-point
  histograms against the trainer's f32 sums).
* The kill at each checkpoint boundary of a validated, bagged run with
  early stopping, bitwise the uninterrupted run.
* Warm start, the CPU device, every fail-closed path, the journal; a
  sticky CUDA error fails closed and its directory resumes in a fresh
  supervisor (and through ``train --supervise --resume``) bitwise.
* A streamed set killed and resumed; a ``STALL`` at a fetch seen by the
  fetch watchdog and journaled beside the fault that follows it; two
  gloo ranks, each under its own supervisor with the same injection
  points, bitwise one process.

Not ported: the reference's four ``test_ch_max_*`` cases, which test the
chunked dispatch arm the port leaves out by design (ROADMAP).  The loop
never consults the chunk cap, so ``backoff_chunks`` says
``cap_consulted: false`` here where the reference's chunked arm says true.
"""

import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import dryad_tpu
from dryad_tpu.datasets import higgs_like
from dryad_tpu.resilience import FaultInjector as RefFaultInjector
from dryad_tpu.resilience import RetryPolicy as RefRetryPolicy
from dryad_tpu.resilience import supervise_train as ref_supervise_train

import dryad_tpu_torch as dt
import torch_dist_worker as W
from dryad_tpu_torch.resilience import (
    FaultError,
    FaultInjector,
    FaultPoint,
    RetryPolicy,
    RunJournal,
    classify_fault,
    is_sticky,
    make_fault,
    supervise_train,
)
from dryad_tpu_torch.resilience import faults as F
from dryad_tpu_torch.resilience.policy import ChunkCapPolicy
from torch_layout import one_torch_thread  # noqa: F401 (autouse)

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
# the reference's fixture params, cut to depth 4 on the legacy arm (the
# plain versions' cheapest route on the CPU)
PARAMS = dict(objective="binary", num_trees=16, num_leaves=7, max_bins=32,
              seed=3, min_data_in_leaf=5, max_depth=4, deep_layout="legacy")
SWEEP = dict(PARAMS, num_trees=10, subsample=0.8, early_stopping_rounds=4)
EVERY = 2
BOUNDARIES = (0, 2, 4, 6, 8)
RANK_TIMEOUT_S = 240
NO_WAIT = dict(backoff_base_s=0.0)
CPU = "cpu"


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Two gloo ranks training under supervision, started first so they
    run beside this module's tests; joined by the test that reads them."""
    d = tmp_path_factory.mktemp("sup_ranks")
    spec = {"world": 2, "store": str(d / "store"), "timeout_s": 60,
            "supervise": True, "ckpt_dir": str(d / "ckpt")}
    path = str(d / "spec.pkl")
    with open(path, "wb") as f:
        pickle.dump(spec, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, TESTS, os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="1")
    procs = []
    for r in range(2):
        with open(f"{path}.{r}.log", "wb") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(TESTS, "torch_dist_worker.py"),
                 path, str(r)], env=env, stdout=log,
                stderr=subprocess.STDOUT))
    yield path, procs
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def data(ranks):
    X, y = higgs_like(3000, seed=21)
    return dt.Dataset(X, y, max_bins=32)


@pytest.fixture(scope="module")
def valid(data):
    X, y = higgs_like(1200, seed=22)
    return data.bind(X, y)


@pytest.fixture(scope="module")
def straight(data):
    return dt.train(PARAMS, data, device=CPU)


@pytest.fixture(scope="module")
def straight_sweep(data, valid):
    return dt.train(SWEEP, data, [valid], device=CPU)


def _same(want, got, check_values=True):
    wa, ga = want.tree_arrays(), got.tree_arrays()
    for k in wa:
        if k in ("value", "gain") and not check_values:
            continue
        np.testing.assert_array_equal(ga[k], wa[k], err_msg=k)
    np.testing.assert_array_equal(got.init_score, want.init_score)
    Xp = np.zeros((4, want.mapper.num_features), np.float32)
    np.testing.assert_array_equal(got.predict(Xp, device=CPU),
                                  want.predict(Xp, device=CPU))


def _same_run(want, got):
    """tests/test_resilience_sweep.py's ``_assert_bitwise``."""
    assert got.num_iterations == want.num_iterations
    assert got.best_iteration == want.best_iteration
    assert got.train_state["best_value"] == want.train_state["best_value"]
    assert got.train_state["stale"] == want.train_state["stale"]
    assert (got.train_state.get("eval_history")
            == want.train_state.get("eval_history"))
    _same(want, got)


# ---- classification ---------------------------------------------------------

def test_classify_recorded_signatures():
    unavailable = RuntimeError(
        "UNAVAILABLE: TPU device error: worker process crashed")
    assert classify_fault(unavailable) == F.DEVICE_UNAVAILABLE
    assert classify_fault(unavailable, at_fetch=True) == F.FETCH_DEATH
    assert classify_fault(RuntimeError("DEADLINE_EXCEEDED: ..."),
                          at_fetch=False) == F.FETCH_DEATH
    assert classify_fault(RuntimeError(
        "RESOURCE_EXHAUSTED: out of memory allocating 1.3G")) == F.OOM
    assert classify_fault(RuntimeError(
        "ABORTED: the TPU worker was preempted")) == F.PREEMPTION
    assert classify_fault(RuntimeError(
        "Preempted by the scheduler")) == F.PREEMPTION


def test_classify_cuda_signatures():
    oom = torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 160.00 GiB. GPU 0 has a "
        "total capacity of 79.19 GiB")
    assert classify_fault(oom) == F.OOM
    assert classify_fault(oom, at_fetch=True) == F.OOM
    assert classify_fault(torch.cuda.OutOfMemoryError("allocator")) == F.OOM
    assert not is_sticky(oom)
    for msg in ("CUDA error: an illegal memory access was encountered",
                "CUDA error: device-side assert triggered\nCUDA kernel "
                "errors might be asynchronously reported",
                "CUDA error: unspecified launch failure",
                "CUDA error: misaligned address",
                "CUDA error: an illegal instruction was encountered"):
        exc = torch.AcceleratorError(msg)
        assert is_sticky(exc), msg
        assert classify_fault(exc) == F.DEVICE_UNAVAILABLE, msg
        # sticky at a fetch site too: the fetch only reports the error
        assert classify_fault(exc, at_fetch=True) == F.DEVICE_UNAVAILABLE
    dist = torch.distributed.DistBackendError("NCCL communicator was aborted")
    assert classify_fault(dist) == F.DEVICE_UNAVAILABLE
    assert classify_fault(dist, at_fetch=True) == F.FETCH_DEATH
    for msg in ("[Rank 1] Watchdog caught collective operation timeout: "
                "WorkNCCL(SeqNum=7, OpType=ALLREDUCE) ran for 600000 "
                "milliseconds before timing out.",
                "[gloo/transport/tcp/pair.cc:534] Connection closed by "
                "peer [127.0.0.1]:29500"):
        assert classify_fault(RuntimeError(msg)) == F.DEVICE_UNAVAILABLE
        assert classify_fault(RuntimeError(msg),
                              at_fetch=True) == F.FETCH_DEATH
        assert not is_sticky(RuntimeError(msg))
    assert not is_sticky(ValueError("an illegal memory access"))


def test_classify_fails_closed_on_everything_else():
    assert classify_fault(ValueError("UNAVAILABLE: looks tunnely")) == F.UNKNOWN
    assert classify_fault(RuntimeError("some novel explosion")) == F.UNKNOWN
    assert classify_fault(KeyboardInterrupt()) == F.UNKNOWN
    assert classify_fault(RuntimeError(
        "compilation aborted: invalid argument")) == F.UNKNOWN
    assert classify_fault(ValueError(
        "CUDA error: device-side assert triggered")) == F.UNKNOWN


def test_make_fault_roundtrips_through_classification():
    for kind in F.RETRYABLE:
        exc = make_fault(kind)
        assert isinstance(exc, RuntimeError)
        assert not is_sticky(exc), kind        # injected faults retry
        assert classify_fault(exc, at_fetch=False) == kind
        assert classify_fault(exc, at_fetch=True) in (kind, F.FETCH_DEATH)
    assert isinstance(make_fault(F.OOM), torch.cuda.OutOfMemoryError)
    assert "CUDA out of memory" in str(make_fault(F.OOM))
    assert classify_fault(make_fault(F.UNKNOWN)) == F.UNKNOWN
    with pytest.raises(ValueError):
        make_fault("nope")


# ---- injector ---------------------------------------------------------------

def test_injector_fires_exactly_once_at_first_event_at_or_after():
    inj = FaultInjector([(5, F.OOM, "dispatch")])
    inj("fetch", 7)
    inj("dispatch", 3)
    with pytest.raises(RuntimeError):
        inj("dispatch", 6)
    inj("dispatch", 6)
    assert inj.pending == 0
    assert inj.fired == [{"point": 0, "site": "dispatch", "iteration": 6,
                          "kind": F.OOM}]
    with pytest.raises(ValueError):
        FaultPoint(0, site="telepathy")
    with pytest.raises(ValueError):
        FaultPoint(0, kind=F.STALL, site="fetch")        # needs stall_s
    # the replica drills' wire format round-trips
    pts = [FaultPoint(3, F.REPLICA_CRASH, "request"),
           FaultPoint(1, F.SLOW_HEALTH, "health", 6.0, True)]
    assert F.decode_points(F.encode_points(pts)) == pts
    assert F.injector_from_env({}) is None


# ---- chunk-cap policy -------------------------------------------------------

def test_chunk_cap_ladder_degrade_and_rewiden():
    cap = ChunkCapPolicy(RetryPolicy(rewiden_after_clean_chunks=2))
    assert cap.cap() == 0
    assert cap.degrade() == 8
    cap.note_clean_chunk()
    assert cap.cap() == 8
    cap.note_clean_chunk()
    assert cap.cap() == 0
    assert cap.degrade() == 8 and cap.degrade() == 4 and cap.degrade() == 2
    assert cap.degrade() == 2
    for _ in range(4):
        cap.note_clean_chunk()
    assert cap.cap() == 2
    tight = ChunkCapPolicy(RetryPolicy(ch_max_start=1))
    assert tight.degrade() == 1
    seen = ChunkCapPolicy(RetryPolicy())
    seen.note_dispatch(6)
    assert seen.degrade() == 4
    wide = ChunkCapPolicy(RetryPolicy(ch_max_start=8))
    wide.note_dispatch(3)
    assert wide.degrade() == 2 and wide.last_shrunk
    exhausted = ChunkCapPolicy(RetryPolicy())
    exhausted.note_dispatch(2)
    assert exhausted.degrade() == 2 and not exhausted.last_shrunk
    asc = ChunkCapPolicy(RetryPolicy(ch_max_ladder=(2, 4, 8)))
    assert asc.degrade() == 8
    with pytest.raises(ValueError, match="at least one step"):
        ChunkCapPolicy(RetryPolicy(ch_max_ladder=()))
    osc = ChunkCapPolicy(RetryPolicy(rewiden_after_clean_chunks=1))
    osc.note_dispatch(6)
    assert osc.degrade() == 4
    assert osc.degrade() == 2
    osc.note_clean_chunk()
    assert osc.cap() == 2
    pol = RetryPolicy()
    # the ladder is the policy table's chunk_cap gate
    assert pol.ch_max_ladder == (8, 4, 2)
    assert pol.next_checkpoint_every(50) == 25
    assert pol.next_checkpoint_every(6) == 5
    assert pol.next_checkpoint_every(2) == 2


# ---- the supervised soak ----------------------------------------------------

SOAK_POINTS = [(3, F.DEVICE_UNAVAILABLE, "dispatch"), (6, F.OOM, "dispatch"),
               (10, F.FETCH_DEATH, "fetch")]


def test_supervised_soak_mixed_faults_bitwise(data, straight, tmp_path):
    injector = FaultInjector(SOAK_POINTS)
    jpath = str(tmp_path / "journal.jsonl")
    infos = []
    booster = supervise_train(
        PARAMS, data, device=CPU,
        checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2,
        journal=jpath, fault_injector=injector,
        callback=lambda it, info: infos.append(info),
        policy=RetryPolicy(ch_max_ladder=(2,), **NO_WAIT))
    assert injector.pending == 0
    _same(straight, booster)

    events = RunJournal.read(jpath)
    kinds = [e["event"] for e in events]
    assert kinds[0] == "run_start" and kinds[-1] == "complete"
    faults = [e for e in events if e["event"] == "fault"]
    assert [f["kind"] for f in faults] == [
        F.DEVICE_UNAVAILABLE, F.OOM, F.FETCH_DEATH]
    assert [f["site"] for f in faults] == ["dispatch", "dispatch", "fetch"]
    assert kinds.count("resume") == 3 and kinds.count("segment_start") == 4
    resume_points = [e["from_iteration"] for e in events
                     if e["event"] == "resume"]
    assert resume_points == sorted(resume_points) == [2, 6, 8]
    backoff = [e for e in events if e["event"] == "backoff_chunks"]
    assert len(backoff) == 1 and backoff[0]["ch_max_to"] == 2
    # the port's loop has no chunks: the remedy is inapplicable
    assert backoff[0]["cap_consulted"] is False
    assert {i["supervise_attempt"] for i in infos} == {0, 1, 2, 3}
    its_seen = [i["iteration"] for i in infos]
    assert len(its_seen) > len(set(its_seen)), "no replayed iterations?"
    assert any(e["event"] == "chunk_dispatch" for e in events)
    assert any(e["event"] == "chunk_fetch" for e in events)
    assert events[-1]["faults"] == 3


def test_soak_matches_the_reference_supervisor(data, straight, tmp_path):
    """The reference's supervise_train on its CPU trainer, the same
    fixture and injection points: the same trees."""
    X, y = higgs_like(3000, seed=21)
    injector = RefFaultInjector(SOAK_POINTS)
    ref = ref_supervise_train(
        PARAMS, dryad_tpu.Dataset(X, y, max_bins=32), backend="cpu",
        checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2,
        fault_injector=injector,
        policy=RefRetryPolicy(backoff_base_s=0.0, ch_max_ladder=(2,)))
    assert injector.pending == 0
    ra, pa = ref.tree_arrays(), straight.tree_arrays()
    for k in ra:
        if k in ("value", "gain"):
            continue
        np.testing.assert_array_equal(pa[k], ra[k], err_msg=k)
    np.testing.assert_allclose(pa["value"], ra["value"], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(straight.init_score, ref.init_score)


def test_supervised_warm_start_resumes_from_checkpoint(data, tmp_path):
    warm = dt.train(dict(PARAMS, num_trees=4), data, device=CPU)
    full = dt.train(PARAMS, data, device=CPU, init_booster=warm)
    injector = FaultInjector([(8, F.DEVICE_UNAVAILABLE, "dispatch")])
    jpath = str(tmp_path / "j.jsonl")
    resumed = supervise_train(
        PARAMS, data, device=CPU, init_booster=warm,
        checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2,
        journal=jpath, fault_injector=injector,
        policy=RetryPolicy(**NO_WAIT))
    assert injector.pending == 0
    _same(full, resumed)
    resumes = [e for e in RunJournal.read(jpath) if e["event"] == "resume"]
    assert resumes and resumes[0]["from_iteration"] > warm.num_iterations
    # init_model appends: the same target in every segment
    injector = FaultInjector([(6, F.OOM, "dispatch")])
    appended = supervise_train(
        dict(PARAMS, num_trees=12), data, device=CPU, init_model=warm,
        checkpoint_dir=str(tmp_path / "ck2"), checkpoint_every=2,
        fault_injector=injector, policy=RetryPolicy(**NO_WAIT))
    assert injector.pending == 0
    _same(full, appended)


def test_supervised_cpu_device_bitwise(data, straight, tmp_path):
    """Faults at a dispatch and at a checkpoint fetch on the CPU device."""
    injector = FaultInjector([(5, F.DEVICE_UNAVAILABLE, "dispatch"),
                              (9, F.OOM, "fetch")])
    infos = []
    booster = supervise_train(
        PARAMS, data, device=CPU,
        checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=3,
        callback=lambda it, i: infos.append(i),
        fault_injector=injector, policy=RetryPolicy(**NO_WAIT))
    assert injector.pending == 0
    assert infos and all("supervise_attempt" in i for i in infos)
    _same(straight, booster)


# ---- the kill at each checkpoint boundary ----------------------------------

@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_kill_at_checkpoint_boundary(tmp_path, data, valid, straight_sweep,
                                     boundary):
    """A device fault at the first dispatch at or after each boundary,
    iteration 0 included (no checkpoint yet), supervises back to the
    uninterrupted run: trees, evals and the early-stopping state."""
    assert straight_sweep.num_iterations == SWEEP["num_trees"]
    injector = FaultInjector([(boundary, F.DEVICE_UNAVAILABLE, "dispatch")])
    resumed = supervise_train(
        SWEEP, data, [valid], device=CPU,
        checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=EVERY,
        fault_injector=injector, policy=RetryPolicy(**NO_WAIT))
    assert injector.pending == 0, "the boundary fault never fired"
    _same_run(straight_sweep, resumed)


def test_sweep_matches_the_reference_supervisor(straight_sweep, tmp_path):
    X, y = higgs_like(3000, seed=21)
    Xv, yv = higgs_like(1200, seed=22)
    rds = dryad_tpu.Dataset(X, y, max_bins=32)
    ref = ref_supervise_train(
        SWEEP, rds, [rds.bind(Xv, yv)], backend="cpu",
        checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=EVERY,
        fault_injector=RefFaultInjector(
            [(4, F.DEVICE_UNAVAILABLE, "dispatch")]),
        policy=RefRetryPolicy(backoff_base_s=0.0))
    assert ref.num_iterations == straight_sweep.num_iterations
    assert ref.best_iteration == straight_sweep.best_iteration
    pa, ra = straight_sweep.tree_arrays(), ref.tree_arrays()
    for k in ("feature", "threshold", "left", "right", "default_left",
              "cover"):
        np.testing.assert_array_equal(pa[k], ra[k], err_msg=k)
    np.testing.assert_allclose(pa["value"], ra["value"], rtol=0, atol=1e-6)


# ---- fail-closed paths ------------------------------------------------------

def test_unknown_fault_fails_closed(data, tmp_path):
    injector = FaultInjector([(2, F.UNKNOWN, "dispatch")])
    jpath = str(tmp_path / "j.jsonl")
    with pytest.raises(FaultError) as ei:
        supervise_train(PARAMS, data, device=CPU,
                        checkpoint_dir=str(tmp_path / "ck"),
                        checkpoint_every=2, journal=jpath,
                        fault_injector=injector,
                        policy=RetryPolicy(**NO_WAIT))
    assert ei.value.reason == "unknown_fault"
    assert ei.value.__cause__ is not None
    events = RunJournal.read(jpath)
    kinds = [e["event"] for e in events]
    assert kinds.count("segment_start") == 1
    assert kinds[-1] == "fail_closed"
    assert events[-1]["reason"] == "unknown_fault"


def _sticky_at(iteration: int):
    """A hook raising what torch raises after a device-side assert."""
    def hook(site, it):
        if site == "dispatch" and it == iteration:
            raise torch.AcceleratorError(
                "CUDA error: device-side assert triggered\nCUDA kernel "
                "errors might be asynchronously reported at some other API "
                "call, so the stacktrace below might be incorrect.")
    return hook


def test_sticky_cuda_error_fails_closed_then_resumes_fresh(data, straight,
                                                           tmp_path):
    """A sticky error is journaled as a fault, then fails closed with
    ``sticky_device_error`` (no in-process retry); the directory resumes
    in a fresh supervisor bitwise."""
    jpath = str(tmp_path / "j.jsonl")
    ck = str(tmp_path / "ck")
    with pytest.raises(FaultError) as ei:
        supervise_train(PARAMS, data, device=CPU, checkpoint_dir=ck,
                        checkpoint_every=4, journal=jpath,
                        fault_injector=_sticky_at(6),
                        policy=RetryPolicy(**NO_WAIT))
    assert ei.value.reason == "sticky_device_error"
    assert ei.value.kind == F.DEVICE_UNAVAILABLE
    assert isinstance(ei.value.__cause__, torch.AcceleratorError)
    events = RunJournal.read(jpath)
    tail = [e for e in events if not e["event"].startswith("chunk_")]
    assert [e["event"] for e in tail] == [
        "run_start", "segment_start", "fault", "fail_closed"]
    assert tail[2]["kind"] == F.DEVICE_UNAVAILABLE
    assert tail[3]["reason"] == "sticky_device_error"
    assert tail[3]["resume_point"] == 4
    # the fresh process's supervisor continues the directory
    resumed = supervise_train(PARAMS, data, device=CPU, checkpoint_dir=ck,
                              checkpoint_every=4, journal=jpath,
                              policy=RetryPolicy(**NO_WAIT))
    _same(straight, resumed)
    last = RunJournal.read_last_run(jpath)
    assert last[1]["resume_iteration"] == 4
    assert last[-1]["event"] == "complete"


def test_retry_budget_exhausted_fails_closed(data, tmp_path):
    injector = FaultInjector([(2, F.DEVICE_UNAVAILABLE, "dispatch"),
                              (8, F.DEVICE_UNAVAILABLE, "dispatch")])
    jpath = str(tmp_path / "j.jsonl")
    with pytest.raises(FaultError) as ei:
        supervise_train(PARAMS, data, device=CPU,
                        checkpoint_dir=str(tmp_path / "ck"),
                        checkpoint_every=2, journal=jpath,
                        fault_injector=injector,
                        policy=RetryPolicy(retry_budget=1, **NO_WAIT))
    assert ei.value.reason == "retry_budget_exhausted"
    events = RunJournal.read(jpath)
    assert events[-1]["reason"] == "retry_budget_exhausted"
    assert [e["event"] for e in events].count("resume") == 1


def test_repeated_same_point_fails_closed(data, tmp_path):
    injector = FaultInjector([(0, F.DEVICE_UNAVAILABLE, "dispatch")] * 3)
    with pytest.raises(FaultError) as ei:
        supervise_train(PARAMS, data, device=CPU,
                        checkpoint_dir=str(tmp_path / "ck"),
                        checkpoint_every=100, fault_injector=injector,
                        policy=RetryPolicy(same_point_retries=2, **NO_WAIT))
    assert ei.value.reason == "repeated_fault_at_same_iteration"


def test_same_point_device_unavailable_degrades_as_fallback(data, tmp_path):
    injector = FaultInjector([(0, F.DEVICE_UNAVAILABLE, "dispatch")] * 2)
    jpath = str(tmp_path / "j.jsonl")
    booster = supervise_train(
        PARAMS, data, device=CPU,
        checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=100,
        journal=jpath, fault_injector=injector,
        policy=RetryPolicy(**NO_WAIT))
    assert injector.pending == 0
    assert booster.num_iterations == PARAMS["num_trees"]
    backoffs = [e for e in RunJournal.read(jpath)
                if e["event"] == "backoff_chunks"]
    assert len(backoffs) == 1
    assert backoffs[0]["trigger"] == "same_point_device_unavailable"


def test_supervise_requires_checkpoint_dir(data):
    with pytest.raises(ValueError, match="checkpoint_dir"):
        supervise_train(PARAMS, data, device=CPU)


def test_supervise_owns_resume_kwarg(data, tmp_path):
    b = supervise_train(dict(PARAMS, num_trees=3), data, device=CPU,
                        resume=True, checkpoint_dir=str(tmp_path / "ck"))
    assert b.num_iterations == 3
    with pytest.raises(ValueError, match="resume=False is contradictory"):
        supervise_train(PARAMS, data, device=CPU, resume=False,
                        checkpoint_dir=str(tmp_path / "ck3"))
    with pytest.raises(ValueError, match="composes its own chunk_hook"):
        supervise_train(PARAMS, data, device=CPU,
                        checkpoint_dir=str(tmp_path / "ck2"),
                        chunk_hook=lambda s, i: None)


def test_journal_closed_on_error_outside_classified_path(data, tmp_path):
    jpath = str(tmp_path / "j.jsonl")
    with pytest.raises(ValueError):
        supervise_train(PARAMS, data, device=CPU, journal=jpath,
                        checkpoint_dir=str(tmp_path / "ck"),
                        checkpoint_every=0)
    events = RunJournal.read(jpath)
    assert events and events[0]["event"] == "run_start"


def test_streamed_set_under_a_group_is_refused(data, tmp_path):
    """The counterpart of the reference's mesh-on-the-CPU-backend case:
    a combination the loop refuses is a ValueError, which the supervisor
    never retries."""
    from dryad_tpu_torch.data.stream_dataset import StreamedDataset
    from dryad_tpu_torch.engine.train import check_group_supported

    sds = StreamedDataset.from_dataset(data, str(tmp_path / "s.bins"),
                                       chunk_rows=700)
    with pytest.raises(ValueError, match="streamed"):
        check_group_supported(dt.make_params(PARAMS), sds)
    jpath = str(tmp_path / "j.jsonl")
    with pytest.raises(FaultError) as ei:
        supervise_train(PARAMS, sds, device=CPU, group=object(),
                        journal=jpath, checkpoint_dir=str(tmp_path / "ck"),
                        policy=RetryPolicy(**NO_WAIT))
    assert ei.value.reason == "unknown_fault"
    assert isinstance(ei.value.__cause__, ValueError)
    assert [e["event"] for e in RunJournal.read(jpath)].count(
        "segment_start") == 1


# ---- journal ----------------------------------------------------------------

def test_journal_shape_and_ownership(data, tmp_path):
    jpath = str(tmp_path / "j.jsonl")
    supervise_train(dict(PARAMS, num_trees=4), data, device=CPU,
                    checkpoint_dir=str(tmp_path / "ck"), journal=jpath)
    events = RunJournal.read(jpath)
    assert events[0]["event"] == "run_start"
    assert events[0]["device"] == CPU
    assert events[-1]["event"] == "complete"
    assert all("elapsed_s" in e for e in events)
    assert events[-1]["iterations"] == 4
    assert events[-1]["faults"] == 0
    assert not any(e["event"] in ("fault", "resume", "backoff_chunks",
                                  "fail_closed") for e in events)
    # the loop's hook sites: a dispatch per iteration, the final fetch
    assert [e["iteration"] for e in events
            if e["event"] == "chunk_dispatch"] == [0, 1, 2, 3]
    assert [e["iteration"] for e in events
            if e["event"] == "chunk_fetch"] == [4]
    # the reference reads the port's journal
    from dryad_tpu.resilience.journal import RunJournal as RefJournal

    assert RefJournal.read(jpath) == events


def test_recompile_listener_lands_in_the_journal(data, tmp_path,
                                                 monkeypatch):
    from dryad_tpu_torch.obs import tripwire

    tw = tripwire.RecompileTripwire()
    monkeypatch.setattr(tripwire, "_default", tw)
    jpath = str(tmp_path / "j.jsonl")

    def hook(site, it):
        if site == "dispatch" and it == 1:
            tw.unexpected("serve.predict", "new bucket after warmup")

    supervise_train(dict(PARAMS, num_trees=2), data, device=CPU,
                    checkpoint_dir=str(tmp_path / "ck"), journal=jpath,
                    fault_injector=hook)
    rec = [e for e in RunJournal.read(jpath)
           if e["event"] == "recompile_unexpected"]
    assert rec == [dict(rec[0], program="serve.predict",
                        detail="new bucket after warmup")]
    assert not tw._listeners                 # removed at the run's end


# ---- streamed sets, the stall drill, a process group -----------------------

def test_supervised_kill_resume_streamed_bitwise(data, tmp_path):
    """The resume's replay walks the streamed matrix; the supervised
    streamed run is the uninterrupted resident run, bit for bit."""
    from dryad_tpu_torch.data.stream_dataset import StreamedDataset

    sds = StreamedDataset.from_dataset(data, str(tmp_path / "s.bins"),
                                       chunk_rows=1231)
    p = dict(PARAMS, num_trees=12)
    ref = dt.train(p, data, device=CPU)
    injector = FaultInjector([(5, F.DEVICE_UNAVAILABLE, "dispatch"),
                              (9, F.OOM, "fetch")])
    jpath = str(tmp_path / "journal.jsonl")
    got = supervise_train(p, sds, device=CPU,
                          checkpoint_dir=str(tmp_path / "ck"),
                          checkpoint_every=3, journal=jpath,
                          fault_injector=injector,
                          policy=RetryPolicy(**NO_WAIT))
    assert injector.pending == 0
    _same(ref, got)
    assert [e["event"] for e in RunJournal.read(jpath)].count("resume") == 2


def test_stall_drill_is_seen_by_the_watchdog(data, straight, tmp_path,
                                             monkeypatch):
    """A STALL at a checkpoint fetch holds the hook inside the fetch's
    watchdog bracket: the in-flight age gauge rises, the stall is counted
    at the checkpoint site and journaled beside the fault that follows."""
    import threading

    from dryad_tpu_torch.obs import registry, watchdog
    from dryad_tpu_torch.obs.health import HealthState

    reg = registry.Registry()
    monkeypatch.setattr(registry, "_default", reg)
    dog = watchdog.FetchWatchdog(registry=reg, threshold_s=0.1,
                                 poll_interval_s=0.02,
                                 health=HealthState(registry=reg))
    monkeypatch.setattr(watchdog, "_default", dog)
    peak, done = [0.0], threading.Event()

    def sample():
        while not done.is_set():
            peak[0] = max(peak[0], reg.gauge(
                "dryad_fetch_inflight_age_seconds").value())
            time.sleep(0.01)

    th = threading.Thread(target=sample, daemon=True)
    th.start()
    injector = FaultInjector([
        FaultPoint(4, F.STALL, "fetch", stall_s=0.5),
        FaultPoint(7, F.DEVICE_UNAVAILABLE, "dispatch")])
    jpath = str(tmp_path / "j.jsonl")
    try:
        booster = supervise_train(
            PARAMS, data, device=CPU, checkpoint_dir=str(tmp_path / "ck"),
            checkpoint_every=2, journal=jpath, fault_injector=injector,
            policy=RetryPolicy(**NO_WAIT))
    finally:
        done.set()
        th.join(5)
    assert not th.is_alive()
    assert injector.pending == 0
    _same(straight, booster)
    assert peak[0] >= 0.1
    assert reg.counter("dryad_fetch_stalls_total").labels(
        site="checkpoint").value() == 1
    stall = dog.last_stall()
    assert stall["site"] == "checkpoint" and stall["iteration"] == 4
    assert stall["age_s"] >= 0.5
    fault = [e for e in RunJournal.read(jpath) if e["event"] == "fault"]
    assert len(fault) == 1 and fault[0]["stall_site"] == "checkpoint"
    assert fault[0]["stall_age_s"] >= 0.5


def test_two_gloo_ranks_under_supervision_equal_one_process(ranks):
    path, procs = ranks
    single = W.run_supervised(W.make_data(), group=False)
    deadline = time.monotonic() + RANK_TIMEOUT_S
    outs = []
    for r, p in enumerate(procs):
        p.wait(timeout=max(1.0, deadline - time.monotonic()))
        with open(f"{path}.{r}.log", errors="replace") as f:
            log = f.read()[-3000:]
        assert p.returncode == 0, f"rank {r}:\n{log}"
        with open(f"{path}.{r}.out", "rb") as f:
            outs.append(pickle.load(f))
    for r, out in enumerate(outs):
        assert "error" not in out, out.get("error")
        got = out["supervised"]
        for k, v in single.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(got[k], v,
                                              err_msg=f"rank {r}: {k}")
            else:
                assert got[k] == v, (r, k)
        events = [json.loads(line) for line in open(f"{path}.{r}.journal")]
        assert [e["kind"] for e in events if e["event"] == "fault"] == [
            F.DEVICE_UNAVAILABLE, F.FETCH_DEATH]
        assert events[-1]["event"] == "complete"
