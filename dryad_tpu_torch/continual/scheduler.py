"""Drift-triggered retrain scheduling — the decision half of continual
boosting.

The scheduler is a journal CONSUMER: the fleet router already owns the
drift verdict (obs/drift.py merges raw counts exactly and journals
``drift_breach`` on a sustained breach); this module's job is everything
between that event and a candidate artifact — debounce, budget, launch,
and the hand-off to the probation publisher.  Design rules:

* **Torch-free, always importable.**  The scheduler lives in the fleet
  control plane.  It must start, tail, and launch while a card is
  wedged mid-collective, so the retrain itself runs as a subprocess
  (``make_subprocess_launcher`` → ``python -m dryad_tpu_torch retrain``)
  and
  the only wait the control plane ever does is a host ``subprocess``
  wait with a timeout.
* **One lock, nothing blocking under it.**  All debounce state sits
  behind ``_lock`` (declared in ``GUARDED_BY``); journal writes, metric
  bumps, file sniffs, subprocess waits, and the publisher's probation
  window all happen OUTSIDE it.  The atomic check-and-mark in
  ``_admit`` is the race-sensitive step: split the check from the mark
  and two concurrent breach deliveries both launch.
* **Skips are journaled, never silent.**  A breach that does not launch
  a retrain writes ``retrain_skipped`` with a machine-readable reason
  (``in_flight`` / ``budget`` / ``cooldown`` /
  ``retry_budget_exhausted`` / ``no_profile`` / ``unknown_model``).
  Profile-less artifacts are a *reason*, not a crash.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from typing import Any, Callable, Mapping, Optional

from dryad_tpu_torch.obs.registry import Registry, default_registry
from dryad_tpu_torch.resilience.policy import RetryPolicy


def model_has_profile(path: str) -> bool:
    """Torch-free artifact sniff: does this saved model embed a
    reference profile (``data/profile.py``)?

    Mirrors ``Booster.load_any``'s magic dispatch (``PK`` → npz binary,
    else the JSON text dump) without importing the booster — the
    scheduler must answer this while a card is wedged, and the profile
    lives in the artifact's JSON metadata either way.  Raises ``OSError``
    / ``ValueError`` on an unreadable artifact; the scheduler maps that
    to a journaled skip.
    """
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"PK":
        import numpy as np

        with np.load(path) as z:
            meta = json.loads(
                np.asarray(z["meta"], dtype=np.uint8).tobytes().decode("utf-8"))
        return meta.get("profile") is not None
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    return doc.get("profile") is not None


class JournalTailer:
    """Incremental reader over a ``RunJournal`` JSONL file.

    Each call returns the events appended since the previous call, in
    order.  Only COMPLETE lines (newline-terminated) are consumed — a
    writer caught mid-line keeps its bytes for the next poll, so a torn
    read can never drop or mangle an event.  Single-consumer by design
    (the scheduler's tail thread); it owns no lock.
    """

    def __init__(self, path: str, *, start_at_end: bool = False):
        self.path = str(path)
        self._offset = 0
        if start_at_end:
            try:
                self._offset = os.path.getsize(self.path)
            except OSError:
                self._offset = 0

    def __call__(self) -> list[dict]:
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                f.seek(self._offset)
                chunk = f.read()
        except OSError:
            return []
        end = chunk.rfind("\n")
        if end < 0:
            return []
        self._offset += end + 1
        out = []
        for line in chunk[:end].split("\n"):
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                continue
        return out


class RetrainScheduler:
    """Debounced drift-breach → retrain-job dispatcher.

    ``models`` maps each served model name to its CURRENT artifact path;
    the scheduler owns that mapping from then on — a promoted generation
    replaces the path, a rollback keeps the old one (the publisher
    re-pushed it).  ``launch(model, generation, job, artifact)`` runs
    one retrain to completion and returns ``(ok, out_path, detail)``;
    the production launcher is :func:`make_subprocess_launcher`, drills
    and tests inject fakes.  ``journal`` is a ``(kind, **fields)``
    callable (``FleetSupervisor.journal`` in the fleet process);
    ``publisher`` is a :class:`~dryad_tpu_torch.continual.publish.
    ProbationPublisher` (``None`` promotes unconditionally — retrain-only
    operation).

    Debounce semantics per breach delivery, checked atomically in
    ``_admit``:

    * a retrain (incl. its probation window) already in flight for the
      model → ``in_flight``;
    * ``max_concurrent`` jobs running fleet-wide → ``budget``;
    * inside the per-model cooldown (``cooldown_s`` after any finished
      job, or ``policy.backoff_s`` after a FAILED one) → ``cooldown``;
    * more than ``policy.retry_budget`` consecutive failures →
      ``retry_budget_exhausted`` (latched until a later success).
    """

    GUARDED_BY = {
        "_artifacts": "_lock",
        "_cooldown_until": "_lock",
        "_fails": "_lock",
        "_generation": "_lock",
        "_inflight": "_lock",
        "_jobs": "_lock",
        "_workers": "_lock",
    }

    def __init__(
        self,
        models: Mapping[str, str],
        launch: Callable[[str, int, int, str], tuple],
        *,
        journal: Optional[Callable[..., None]] = None,
        publisher: Optional[Any] = None,
        policy: Optional[RetryPolicy] = None,
        cooldown_s: float = 300.0,
        max_concurrent: int = 1,
        poll_interval_s: float = 1.0,
        source: Optional[Callable[[], list]] = None,
        has_profile: Callable[[str], bool] = model_has_profile,
        registry: Optional[Registry] = None,
    ):
        self.launch = launch
        self.publisher = publisher
        self.policy = policy if policy is not None else RetryPolicy()
        self.cooldown_s = float(cooldown_s)
        self.max_concurrent = int(max_concurrent)
        self.poll_interval_s = float(poll_interval_s)
        self._source = source
        self._journal_fn = journal
        self._has_profile = has_profile
        self._registry = registry if registry is not None else default_registry()
        self._lock = threading.Lock()
        self._stop_ev = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._workers: list[threading.Thread] = []
        self._artifacts = {str(k): str(v) for k, v in dict(models).items()}
        self._generation = {m: 0 for m in self._artifacts}
        self._inflight: set = set()
        self._cooldown_until: dict = {}
        self._fails: dict = {}
        self._jobs = 0  # global job counter — the fault-injection index

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "RetrainScheduler":
        """Start the journal tail loop (requires a ``source``)."""
        if self._source is None:
            raise ValueError(
                "start() needs an event source (e.g. JournalTailer over the "
                "fleet journal); trigger() works without one")
        t = threading.Thread(target=self._loop, name="retrain-scheduler",
                             daemon=True)
        self._thread = t
        t.start()
        return self

    def stop(self, timeout_s: float = 30.0) -> None:
        """Stop tailing and wait for the tail thread and any in-flight
        retrain workers (bounded — a stuck subprocess is the launcher's
        timeout to kill, not ours to wait out forever)."""
        self._stop_ev.set()
        t = self._thread
        if t is not None:
            t.join(timeout_s)
        with self._lock:
            workers = list(self._workers)
        for w in workers:
            w.join(timeout_s)

    def _loop(self) -> None:
        while not self._stop_ev.is_set():
            try:
                events = self._source()
            except Exception:
                events = []
            for ev in events:
                if ev.get("event") == "drift_breach" and ev.get("model"):
                    self._on_breach(str(ev["model"]), origin="drift_breach")
            self._stop_ev.wait(self.poll_interval_s)

    # -- triggering --------------------------------------------------------

    def trigger(self, model: str, *, origin: str = "manual") -> bool:
        """Operator surface: evaluate a retrain for ``model`` NOW, through
        the same debounce as a journaled breach.  Returns True when a job
        launched (a False is journaled as ``retrain_skipped``)."""
        return self._on_breach(str(model), origin=origin)

    def _on_breach(self, model: str, *, origin: str) -> bool:
        with self._lock:
            path = self._artifacts.get(model)
        if path is None:
            self._skip(model, "unknown_model", origin)
            return False
        # profile sniff outside the lock — it is file I/O; profile-less
        # artifacts are a journaled skip, never a crash
        try:
            has = self._has_profile(path)
        except Exception as e:
            self._skip(model, f"artifact_unreadable:{type(e).__name__}", origin)
            return False
        if not has:
            self._skip(model, "no_profile", origin)
            return False
        admitted, reason, gen, job = self._admit(model)
        if not admitted:
            self._skip(model, reason, origin)
            return False
        self._event("retrain_triggered", model=model, generation=gen,
                    job=job, origin=origin)
        self._count("retrain_triggered", model=model)
        w = threading.Thread(target=self._retrain_job,
                             args=(model, gen, job, path),
                             name=f"retrain-{model}-g{gen}", daemon=True)
        with self._lock:
            self._workers = [t for t in self._workers if t.is_alive()]
            self._workers.append(w)
        w.start()
        return True

    def _admit(self, model: str) -> tuple:
        """Atomic debounce check-and-mark.  The checks and the in-flight
        mark MUST be one critical section: split them and two concurrent
        breach deliveries both pass the check before either marks,
        double-launching the retrain."""
        now = time.monotonic()
        with self._lock:
            if model in self._inflight:
                return False, "in_flight", 0, 0
            if len(self._inflight) >= self.max_concurrent:
                return False, "budget", 0, 0
            if now < self._cooldown_until.get(model, 0.0):
                return False, "cooldown", 0, 0
            if self._fails.get(model, 0) > self.policy.retry_budget:
                return False, "retry_budget_exhausted", 0, 0
            self._inflight.add(model)
            gen = self._generation.get(model, 0) + 1
            job = self._jobs
            self._jobs += 1
        return True, "", gen, job

    # -- the retrain worker ------------------------------------------------

    def _retrain_job(self, model: str, gen: int, job: int,
                     artifact: str) -> None:
        t0 = time.monotonic()
        ok, out_path, detail = False, None, ""
        try:
            ok, out_path, detail = self.launch(model, gen, job, artifact)
        except Exception as e:  # the control plane survives any launcher
            detail = repr(e)
        wall = time.monotonic() - t0
        if not ok or not out_path:
            now = time.monotonic()
            with self._lock:
                fails = self._fails.get(model, 0) + 1
                self._fails[model] = fails
                self._cooldown_until[model] = now + self.policy.backoff_s(
                    fails - 1)
                self._inflight.discard(model)
            self._event("retrain_failed", model=model, generation=gen,
                        job=job, wall_s=round(wall, 3), fails=fails,
                        detail=str(detail)[:500])
            self._count("retrain_failed", model=model)
            return
        self._event("retrain_complete", model=model, generation=gen,
                    job=job, wall_s=round(wall, 3), path=out_path)
        self._count("retrain_complete", model=model)
        outcome = "promoted"
        if self.publisher is not None:
            try:
                outcome = self.publisher.publish(out_path, model=model,
                                                 prior_path=artifact,
                                                 generation=gen)
            except Exception as e:
                outcome = "publish_error"
                self._event("publish_error", model=model, generation=gen,
                            detail=repr(e)[:500])
        now = time.monotonic()
        with self._lock:
            if outcome == "promoted":
                self._artifacts[model] = out_path
                self._generation[model] = gen
                self._fails[model] = 0
            self._cooldown_until[model] = now + self.cooldown_s
            self._inflight.discard(model)
            cur_gen = self._generation.get(model, 0)
        self._gauge("generation", cur_gen, model=model)

    # -- introspection -----------------------------------------------------

    def state(self) -> dict:
        """Snapshot for tests/smokes: current generations, artifact paths,
        in-flight set, failure counts, and the global job counter."""
        with self._lock:
            return {
                "artifacts": dict(self._artifacts),
                "generation": dict(self._generation),
                "inflight": sorted(self._inflight),
                "fails": dict(self._fails),
                "jobs": self._jobs,
            }

    # -- plumbing (all called WITHOUT the lock held) -----------------------

    def _skip(self, model: str, reason: str, origin: str) -> None:
        self._event("retrain_skipped", model=model, reason=reason,
                    origin=origin)
        self._count("retrain_skipped", model=model, reason=reason)

    def _event(self, kind: str, **fields) -> None:
        j = self._journal_fn
        if j is None:
            return
        try:
            j(kind, **fields)
        except Exception:
            pass  # telemetry must never kill the control plane

    def _count(self, name: str, **labels) -> None:
        reg = self._registry
        if reg is not None and reg.enabled:
            reg.counter(f"dryad_continual_{name}_total",
                        "continual-boosting scheduler decisions"
                        ).labels(**labels).inc()

    def _gauge(self, name: str, value: float, **labels) -> None:
        reg = self._registry
        if reg is not None and reg.enabled:
            reg.gauge(f"dryad_continual_{name}",
                      "continual-boosting scheduler state"
                      ).labels(**labels).set(float(value))


def make_subprocess_launcher(
    data_path: str,
    out_dir: str,
    *,
    trees: int = 20,
    device: str = "cuda",
    timeout_s: float = 1800.0,
    refit_decay: float = 0.0,
    supervise: bool = False,
    python: Optional[str] = None,
    log_dir: Optional[str] = None,
    extra_env: Optional[Mapping[str, str]] = None,
) -> Callable[[str, int, int, str], tuple]:
    """Build the production ``launch`` callable: one retrain = one fresh
    ``python -m dryad_tpu_torch retrain`` subprocess on ``device``
    (``cuda``, the default, or ``cpu``).

    The worker is the only torch-importing piece of the loop — it loads
    the served artifact, warm-start appends ``trees`` new trees on the rows
    in ``data_path`` (an npz with ``X``/``y``), optionally after a
    ``Booster.refit`` re-weighting pass, and saves the new generation
    with a FRESH reference profile (``DRYAD_PROFILE=1`` is forced into
    the worker env).  ``supervise=True`` routes the worker's own training
    through ``resilience.supervise_train`` (fault classes degrade and
    resume bitwise inside the subprocess).  The parent environment is
    inherited, so an armed ``DRYAD_CONTINUAL_FAULTS`` spec reaches the
    worker's fault injector (``faults.take('retrain', job)``).
    """
    out_dir = str(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)

    def launch(model: str, generation: int, job: int, artifact: str) -> tuple:
        out_path = os.path.join(out_dir, f"{model}-gen{generation}.dryad")
        argv = [python or sys.executable, "-m", "dryad_tpu_torch",
                "retrain", "--model", artifact, "--data", str(data_path),
                "--out", out_path, "--trees", str(trees),
                "--device", device, "--job-index", str(job)]
        if refit_decay:
            argv += ["--refit-decay", str(refit_decay)]
        if supervise:
            argv += ["--supervise"]
        env = dict(os.environ)
        env["DRYAD_PROFILE"] = "1"  # every generation ships a fresh baseline
        if extra_env:
            env.update(extra_env)
        log_path = os.path.join(log_dir or out_dir,
                                f"retrain-{model}-g{generation}.log")
        with open(log_path, "wb") as log:
            try:
                rc = subprocess.call(argv, stdout=log,
                                     stderr=subprocess.STDOUT, env=env,
                                     timeout=timeout_s)
            except subprocess.TimeoutExpired:
                return False, None, f"timeout {timeout_s}s (log: {log_path})"
        if rc != 0:
            return False, None, f"exit {rc} (log: {log_path})"
        if not os.path.exists(out_path):
            return False, None, f"no artifact at {out_path} (log: {log_path})"
        return True, out_path, ""

    return launch
