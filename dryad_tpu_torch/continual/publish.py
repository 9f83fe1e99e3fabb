"""Probationed rolling publish with score-shift auto-rollback.

A retrained generation never replaces its predecessor blindly: it goes
out through the fleet's EXISTING zero-drop rolling swap
(``FleetSupervisor.rolling_push`` — the same machinery behind
``POST /models/push``) and then sits in a PROBATION window while the
merged fleet drift verdict accumulates evidence against its own fresh
reference profile.  The decision rule compares against the DISPLACED
generation's last-known verdict, captured immediately before the push:

* the new generation's verdict clears (``clear_after`` polls with
  traffic and no breach) → ``generation_promoted``;
* the new generation SUSTAINS a breach while its predecessor was clean
  → ``generation_rolled_back``: the prior ARTIFACT is re-pushed through
  the same rolling swap — the registry is never mutated in place, a
  rollback is just another zero-drop deploy of a file that still exists;
* the predecessor was already breaching (the usual case — a breach is
  what triggered the retrain): a breach by the new generation is not
  conclusive regression, so probation keeps polling for a clear;
* the window expires without decisive evidence (e.g. no traffic) →
  promoted with ``verdict="expired"`` in the journal — visible, not
  silent.

The publisher is deliberately STATELESS per call — every probation
lives on its caller's (retrain worker thread's) stack, so concurrent
publishes of different models share nothing here; the fleet's swap
mutex already serializes the actual swaps.  It imports no torch; the
verdict source is injected (``make_http_verdicts`` polls the router's
``GET /drift``, whose handler performs the fresh replica scrape — each
probation poll IS a drift window advancing).
"""

from __future__ import annotations

import json
import time
import urllib.request
from typing import Any, Callable, Mapping, Optional


class ProbationPublisher:
    """Push → probation → promote-or-rollback.

    ``push(path, model) -> (ok, detail)`` performs one zero-drop rolling
    swap (:func:`make_supervisor_push` adapts ``FleetSupervisor``);
    ``verdicts() -> {model: verdict}`` returns the merged fleet drift
    verdicts (:func:`make_http_verdicts`, or ``DriftGate.verdicts()``
    directly in-process).  ``journal`` is a ``(kind, **fields)``
    callable.  ``publish`` returns one of ``"promoted"`` /
    ``"rolled_back"`` / ``"push_failed"``.
    """

    def __init__(
        self,
        push: Callable[[str, str], tuple],
        verdicts: Callable[[], Mapping[str, Any]],
        *,
        journal: Optional[Callable[..., None]] = None,
        probation_polls: int = 5,
        poll_interval_s: float = 2.0,
        clear_after: int = 1,
        registry: Optional[Any] = None,
    ):
        self.push = push
        self.verdicts = verdicts
        self._journal_fn = journal
        self.probation_polls = int(probation_polls)
        self.poll_interval_s = float(poll_interval_s)
        self.clear_after = max(1, int(clear_after))
        if registry is None:
            from dryad_tpu_torch.obs.registry import default_registry

            registry = default_registry()
        self._registry = registry

    def publish(self, path: str, *, model: str, prior_path: str,
                generation: int) -> str:
        prior = self._verdict_of(model)
        # the displaced generation's standing at the moment it leaves:
        # rollback is only armed when the predecessor was NOT already in
        # sustained breach (a breach-triggered retrain's predecessor is)
        prior_clean = not bool((prior or {}).get("sustained"))
        ok, detail = self.push(path, model)
        if not ok:
            self._event("push_failed", model=model, generation=generation,
                        path=path, detail=str(detail)[:300])
            self._count("push_failed", model=model)
            return "push_failed"
        self._event("push_probation", model=model, generation=generation,
                    path=path, prior_clean=prior_clean,
                    polls=self.probation_polls,
                    interval_s=self.poll_interval_s)
        self._count("push_probation", model=model)
        clean_streak = 0
        for _ in range(self.probation_polls):
            time.sleep(self.poll_interval_s)
            verdict = self._verdict_of(model)
            if not verdict or not verdict.get("rows"):
                continue  # no traffic evidence — this poll decides nothing
            if verdict.get("sustained"):
                if prior_clean:
                    return self._rollback(model, generation, path,
                                          prior_path, verdict)
                clean_streak = 0
                continue
            if verdict.get("breached"):
                clean_streak = 0
                continue
            clean_streak += 1
            if clean_streak >= self.clear_after:
                return self._promote(model, generation, path, "clear")
        return self._promote(model, generation, path, "expired")

    # -- outcomes ----------------------------------------------------------

    def _promote(self, model: str, generation: int, path: str,
                 verdict: str) -> str:
        self._event("generation_promoted", model=model, generation=generation,
                    path=path, verdict=verdict)
        self._count("generation_promoted", model=model)
        return "promoted"

    def _rollback(self, model: str, generation: int, path: str,
                  prior_path: str, verdict: Mapping[str, Any]) -> str:
        # re-push the prior artifact through the same zero-drop swap —
        # NEVER an in-place registry mutation
        ok, detail = self.push(prior_path, model)
        self._event("generation_rolled_back", model=model,
                    generation=generation, path=path, prior=prior_path,
                    psi_max=verdict.get("psi_max"),
                    score_psi=verdict.get("score_psi"),
                    restore_ok=bool(ok), restore_detail=str(detail)[:200])
        self._count("generation_rolled_back", model=model)
        return "rolled_back"

    # -- plumbing ----------------------------------------------------------

    def _verdict_of(self, model: str) -> Optional[Mapping[str, Any]]:
        try:
            return dict(self.verdicts()).get(model)
        except Exception:
            return None

    def _event(self, kind: str, **fields) -> None:
        j = self._journal_fn
        if j is None:
            return
        try:
            j(kind, **fields)
        except Exception:
            pass  # telemetry must never kill a publish decision

    def _count(self, name: str, **labels) -> None:
        reg = self._registry
        if reg is not None and reg.enabled:
            reg.counter(f"dryad_continual_{name}_total",
                        "continual-boosting publish decisions"
                        ).labels(**labels).inc()


def make_supervisor_push(supervisor, *, activate: bool = True,
                         auth_token: Optional[str] = None,
                         drain_timeout_s: float = 30.0,
                         load_timeout_s: float = 120.0):
    """Adapt ``FleetSupervisor.rolling_push`` to the publisher's push
    contract — the identical zero-drop swap ``POST /models/push``
    drives."""

    def push(path: str, model: str) -> tuple:
        res = supervisor.rolling_push(path, name=model, activate=activate,
                                      auth_token=auth_token,
                                      drain_timeout_s=drain_timeout_s,
                                      load_timeout_s=load_timeout_s)
        errs = list(res.get("errors") or [])
        if errs:
            return False, "; ".join(str(e) for e in errs)[:300]
        return True, ""

    return push


def make_http_verdicts(host: str, port: int, *,
                       auth_token: Optional[str] = None,
                       timeout_s: float = 10.0):
    """Poll the fleet router's ``GET /drift`` for merged per-model
    verdicts.  The handler performs a fresh replica scrape + exact count
    merge + gate evaluation per call, so each probation poll advances
    the drift windows it is judging."""
    url = f"http://{host}:{port}/drift"

    def verdicts() -> Mapping[str, Any]:
        req = urllib.request.Request(url)
        if auth_token:
            req.add_header("Authorization", f"Bearer {auth_token}")
        try:
            with urllib.request.urlopen(req, timeout=timeout_s) as r:
                doc = json.loads(r.read().decode("utf-8"))
        except Exception:
            return {}
        return doc.get("models") or {}

    return verdicts
