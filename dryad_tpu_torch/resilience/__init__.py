"""dryad_tpu_torch.resilience: supervised training for long runs.

Fault classification and deterministic injection (``faults.py``), the
retry and degradation policy (``policy.py``), the supervising loop
(``supervisor.py``) and the append-only run journal (``journal.py``); the
counterpart of ``dryad_tpu/resilience/``.  Entry point::

    from dryad_tpu_torch.resilience import supervise_train
    booster = supervise_train(params, ds, [vds], checkpoint_dir="ck/",
                              checkpoint_every=50, journal="run.jsonl")

or ``python -m dryad_tpu_torch train ... --supervise --journal run.jsonl``.
A sticky CUDA error fails closed (``FaultError``, reason
``sticky_device_error``); resume its checkpoint directory in a fresh
process with ``train --supervise --resume``.
"""

from dryad_tpu_torch.resilience.faults import (
    DEVICE_UNAVAILABLE,
    FETCH_DEATH,
    OOM,
    PREEMPTION,
    REJECT_503,
    REPLICA_CRASH,
    REPLICA_CRASH_EXIT,
    REPLICA_KINDS,
    RETRYABLE,
    SLOW_HEALTH,
    UNKNOWN,
    FaultInjector,
    FaultPoint,
    InjectedReject,
    classify_fault,
    is_sticky,
    make_fault,
)
from dryad_tpu_torch.resilience.journal import RunJournal
from dryad_tpu_torch.resilience.policy import ChunkCapPolicy, RetryPolicy
from dryad_tpu_torch.resilience.supervisor import FaultError, supervise_train

__all__ = [
    "DEVICE_UNAVAILABLE", "FETCH_DEATH", "OOM", "PREEMPTION", "RETRYABLE",
    "REJECT_503", "REPLICA_CRASH", "REPLICA_CRASH_EXIT", "REPLICA_KINDS",
    "SLOW_HEALTH", "UNKNOWN", "FaultInjector", "FaultPoint", "InjectedReject",
    "classify_fault", "is_sticky", "make_fault",
    "RunJournal", "ChunkCapPolicy", "RetryPolicy", "FaultError",
    "supervise_train",
]
