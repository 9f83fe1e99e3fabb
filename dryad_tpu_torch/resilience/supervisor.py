"""Supervised training: survive the classified device faults without a
human in the loop.

The counterpart of ``dryad_tpu/resilience/supervisor.py::supervise_train``.
It wraps ``dryad_tpu_torch.train`` in a classify -> degrade -> resume ->
retry loop over the invariant the port already holds: checkpoint, crash
and resume give the uninterrupted run's trees bit for bit.

1. A raised failure is classified (``faults.classify_fault``); unknown
   classes fail closed.
2. Fetch-death faults degrade the chunk cap (``policy.ChunkCapPolicy``).
   The port's loop has no chunked dispatch and never consults the cap, so
   the journal's ``backoff_chunks`` says ``cap_consulted: false``.
3. The checkpoint cadence tightens after each fault.
4. Training resumes from the newest checkpoint under an exponential
   backoff and a hard retry budget; repeated faults with no checkpoint
   progress in between fail closed after ``policy.same_point_retries``.

One departure from the reference: a sticky CUDA error (``faults.
is_sticky``: an illegal address, a device-side assert, a launch failure)
poisons the process's CUDA context, so no in-process retry can succeed.
After journaling the ``fault`` the supervisor writes ``fail_closed`` with
``reason="sticky_device_error"`` and raises ``FaultError``; the checkpoint
directory then resumes in a fresh process (``python -m dryad_tpu_torch
train --supervise --resume ...``).

Every classification, backoff, degradation and resume lands in the run
journal (``journal.py``), as do unexpected recompiles (the tripwire's
listener).  Under a process group every rank runs its own supervisor with
the same injector: the ranks fault at the same points, rank 0 writes the
checkpoints and every rank resumes from the same one.
"""

from __future__ import annotations

import os
import time
from typing import Any, Optional

from dryad_tpu_torch.checkpoint import Checkpointer
from dryad_tpu_torch.obs.spans import record as record_span
from dryad_tpu_torch.obs.spans import span
from dryad_tpu_torch.obs.tripwire import default_tripwire
from dryad_tpu_torch.obs.watchdog import default_watchdog
from dryad_tpu_torch.resilience import faults as F
from dryad_tpu_torch.resilience.journal import RunJournal
from dryad_tpu_torch.resilience.policy import ChunkCapPolicy, RetryPolicy


class FaultError(RuntimeError):
    """Fail-closed terminus: the supervisor refuses to keep retrying.
    ``kind`` is the last fault's class, ``reason`` why retrying stopped
    (``unknown_fault`` / ``sticky_device_error`` /
    ``retry_budget_exhausted`` / ``repeated_fault_at_same_iteration``);
    the original exception is chained as ``__cause__``."""

    def __init__(self, message: str, kind: str, reason: str):
        super().__init__(message)
        self.kind = kind
        self.reason = reason


def supervise_train(
    params,
    train_set,
    valid_sets=None,
    *,
    policy: Optional[RetryPolicy] = None,
    device=None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 10,
    journal: "RunJournal | str | None" = None,
    fault_injector=None,
    callbacks=None,
    callback=None,
    valid_names=None,
    group=None,
    **kw: Any,
):
    """Train under supervision on ``device`` (default: the card); returns
    the finished Booster.

    ``checkpoint_dir`` is required: resume is the recovery mechanism.  The
    directory is continued unconditionally, a prior invocation's
    checkpoints included (the CLI asks for ``--resume`` for that).
    ``journal`` takes a path (owned and closed here) or an open
    ``RunJournal``.  ``fault_injector`` is any ``hook(site, iteration)``
    (a ``faults.FaultInjector``) called at the loop's hook sites after the
    journal records them.  ``group`` trains as one rank of a process group
    (``distributed.train_distributed`` builds the ``RowGroup``).  Other
    keywords go to ``dryad_tpu_torch.train``."""
    import dryad_tpu_torch as dt

    policy = policy or RetryPolicy()
    if checkpoint_dir is None:
        raise ValueError("supervise_train requires checkpoint_dir: resume "
                         "from the latest checkpoint is the recovery path")

    # a caller's warm-start booster seeds only the first, checkpoint-less
    # segment: once a checkpoint exists it embodies warm start + progress
    init_booster = kw.pop("init_booster", None)
    # init_model appends num_trees new trees: normalised once into the
    # total-count init_booster form, so every segment sees one target
    init_model = kw.pop("init_model", None)
    if init_model is not None:
        if init_booster is not None:
            raise ValueError("pass init_model (append semantics) or "
                             "init_booster (total-count resume), not both")
        from dryad_tpu_torch.config import make_params

        p0 = make_params(params)
        dt._check_append_compatible(p0, train_set, init_model)
        params = p0.replace(num_trees=p0.num_trees
                            + init_model.num_iterations)
        init_booster = init_model
    # the supervisor owns resume (every segment passes resume=True)
    if kw.pop("resume", True) is False:
        raise ValueError(
            "supervise_train always resumes from checkpoint_dir (that IS "
            "the recovery mechanism); resume=False is contradictory — "
            "point checkpoint_dir at a fresh or cleared directory to "
            "start over")
    # and the loop surfaces it composes
    for owned in ("chunk_hook", "chunk_policy"):
        if owned in kw:
            raise ValueError(
                f"supervise_train composes its own {owned} (journal + "
                "injection + adaptive cap); pass fault_injector/journal "
                "here, or call dryad_tpu_torch.train directly for raw hook "
                "access")

    own_journal = isinstance(journal, (str, os.PathLike))
    j = RunJournal(os.fspath(journal)) if own_journal else journal

    def jevent(kind: str, /, **fields) -> None:
        if j is not None:
            j.event(kind, **fields)

    # the loop's chunk_hook: journal the event and track the last site, so
    # a raised failure can be attributed to a fetch, then run the injector
    last = {"site": None, "iteration": -1}

    def hook(site: str, iteration: int) -> None:
        last["site"], last["iteration"] = site, int(iteration)
        jevent("chunk_" + site, iteration=int(iteration))
        if fault_injector is not None:
            fault_injector(site, iteration)

    # a resumed segment re-delivers callbacks for the iterations re-grown
    # since its checkpoint (the same values); consumers keep the highest
    # supervise_attempt per iteration
    from dryad_tpu_torch.callbacks import combine

    user_cb = combine(([callback] if callback else []) + list(callbacks or []))
    marked_cb = None
    if user_cb is not None:
        def marked_cb(it, info):
            info = dict(info)
            info["supervise_attempt"] = n_faults
            user_cb(it, info)

    chunk_cap = ChunkCapPolicy(policy)
    every = int(checkpoint_every)
    n_faults = 0
    same_point = 0
    last_resume_iter: Optional[int] = None
    t0 = time.perf_counter()

    def latest_iteration() -> int:
        # a directory listing: no checkpoint is read to learn its number
        its = Checkpointer(checkpoint_dir, every=every).iterations()
        return its[-1] if its else 0

    jevent("run_start", checkpoint_dir=checkpoint_dir,
           checkpoint_every=every, device=str(device or "cuda"),
           retry_budget=policy.retry_budget)

    # unexpected recompiles land in the journal beside the faults
    _remove_tw = default_tripwire().add_listener(
        lambda program, detail: jevent("recompile_unexpected",
                                       program=program, detail=detail))

    def fail_closed(exc, kind, reason, text, **fields):
        jevent("fail_closed", reason=reason, **fields)
        raise FaultError(text, kind, reason) from exc

    def _loop():
        nonlocal n_faults, same_point, last_resume_iter, every
        while True:
            resume_iter = latest_iteration()
            # fresh site tracking and cap-consulted flag per segment
            last["site"], last["iteration"] = None, -1
            chunk_cap.consulted = False
            jevent("segment_start", attempt=n_faults,
                   resume_iteration=resume_iter, ch_max=chunk_cap.peek(),
                   checkpoint_every=every)
            # the segment's wall by record(), not a with-span, which would
            # prefix every span the loop opens inside it
            _t_seg = time.perf_counter()
            try:
                booster = dt.train(
                    params, train_set, valid_sets,
                    valid_names=valid_names, device=device, group=group,
                    checkpoint_dir=checkpoint_dir,
                    checkpoint_every=every, resume=True,
                    # a checkpoint (numbered from 1) embodies the warm
                    # start, which must not shadow it
                    init_booster=init_booster if resume_iter == 0 else None,
                    callback=marked_cb,
                    chunk_hook=hook, chunk_policy=chunk_cap, **kw)
                record_span("supervise.segment",
                            time.perf_counter() - _t_seg)
            except Exception as exc:  # noqa: BLE001 — classified just below
                record_span("supervise.segment",
                            time.perf_counter() - _t_seg)
                _t_cl = time.perf_counter()
                kind = F.classify_fault(exc, at_fetch=last["site"] == "fetch")
                record_span("supervise.classify",
                            time.perf_counter() - _t_cl)
                ckpt_iter = latest_iteration()
                # a stall the fetch watchdog saw during this segment is
                # journaled beside the fault it preceded
                stall = default_watchdog().last_stall()
                extra = {}
                if stall is not None and stall.get("ended_at", 0) >= _t_seg:
                    extra = {"stall_age_s": stall["age_s"],
                             "stall_site": stall["site"]}
                jevent("fault", kind=kind, site=last["site"],
                       iteration=last["iteration"], resume_point=ckpt_iter,
                       message=str(exc)[:300], **extra)
                if kind == F.UNKNOWN:
                    fail_closed(exc, kind, "unknown_fault",
                                f"unclassified failure — refusing to "
                                f"retry: {exc}", message=str(exc)[:300])
                if F.is_sticky(exc):
                    fail_closed(exc, kind, "sticky_device_error",
                                f"sticky CUDA error: the process's context "
                                f"is lost, resume {checkpoint_dir} in a "
                                f"fresh process: {exc}",
                                message=str(exc)[:300],
                                resume_point=ckpt_iter)
                n_faults += 1
                if n_faults > policy.retry_budget:
                    fail_closed(exc, kind, "retry_budget_exhausted",
                                f"retry budget ({policy.retry_budget}) "
                                f"exhausted after a {kind} fault: {exc}",
                                faults=n_faults)
                if (last_resume_iter is not None
                        and ckpt_iter == last_resume_iter):
                    same_point += 1
                    if same_point >= policy.same_point_retries:
                        fail_closed(
                            exc, kind, "repeated_fault_at_same_iteration",
                            f"{kind} fault repeated {same_point}x with no "
                            f"checkpoint progress past iteration "
                            f"{ckpt_iter}",
                            resume_point=ckpt_iter, repeats=same_point)
                else:
                    same_point = 0
                last_resume_iter = ckpt_iter
                # the chunk remedy engages on a fetch death, and on a
                # device_unavailable that repeats with no checkpoint
                # progress (a killed fetch can surface at the next enqueue)
                if kind == F.FETCH_DEATH or (
                        kind == F.DEVICE_UNAVAILABLE and same_point >= 1):
                    before = chunk_cap.peek()
                    consulted = chunk_cap.consulted
                    after = chunk_cap.degrade()
                    jevent("backoff_chunks", ch_max_from=before,
                           ch_max_to=after, cap_consulted=consulted,
                           changed=chunk_cap.last_shrunk,
                           trigger=("fetch_death" if kind == F.FETCH_DEATH
                                    else "same_point_device_unavailable"))
                new_every = policy.next_checkpoint_every(every)
                sleep_s = policy.backoff_s(n_faults - 1)
                jevent("resume", attempt=n_faults, from_iteration=ckpt_iter,
                       sleep_s=sleep_s, checkpoint_every=new_every)
                every = new_every
                if sleep_s > 0:
                    with span("supervise.backoff"):
                        time.sleep(sleep_s)
                continue
            wall = time.perf_counter() - t0
            jevent("complete", wall_s=round(wall, 3),
                   iterations=booster.num_iterations, faults=n_faults,
                   ch_max_final=chunk_cap.peek())
            return booster

    try:
        return _loop()
    finally:
        # every exit releases an owned journal and the tripwire listener
        _remove_tw()
        if own_journal and j is not None:
            j.close()
