"""Continual boosting — close the train → serve → drift → retrain →
publish loop.

The fleet's drift telemetry journals ``drift_breach`` when served
traffic sustainably departs a model's embedded reference profile; this
package turns that event into a new model generation and gets it back
into the fleet safely:

* :class:`~dryad_tpu_torch.continual.scheduler.RetrainScheduler` tails
  the fleet journal, debounces breaches per model (cooldown + a
  max-concurrent-retrains budget, failure backoff riding
  ``resilience.RetryPolicy``), and launches each retrain as a SUPERVISED
  SUBPROCESS (``python -m dryad_tpu_torch retrain``) — a wedged card can
  never hang the fleet control plane.
* The worker warm-starts from the served artifact
  (``dryad_tpu_torch.train(init_model=...)``): boosting resumes from the
  loaded model's carried scores on fresh rows, in the model's frozen bin
  space.
* :class:`~dryad_tpu_torch.continual.publish.ProbationPublisher` pushes
  the new generation through the existing zero-drop rolling swap, then holds
  it in a PROBATION window: the merged fleet score-shift verdict is
  compared against the displaced generation's pre-push verdict —
  promote on clear, AUTO-ROLLBACK (a rolling push of the prior
  artifact; the registry is never mutated in place) when the new
  generation breaches while its predecessor did not.

Every decision is journaled (``retrain_triggered`` / ``retrain_skipped``
/ ``retrain_complete`` / ``retrain_failed`` / ``push_probation`` /
``generation_promoted`` / ``generation_rolled_back``) and exported as
``dryad_continual_*`` counters/gauges on the fleet registry.

The package imports no torch, directly or transitively: the scheduler
and publisher run in the fleet control plane, which must keep
supervising replicas while a card is wedged — the only torch-importing
piece of the loop is the retrain worker subprocess itself.
"""

from dryad_tpu_torch.continual.publish import (ProbationPublisher,
                                               make_http_verdicts,
                                               make_supervisor_push)
from dryad_tpu_torch.continual.scheduler import (JournalTailer,
                                                 RetrainScheduler,
                                                 make_subprocess_launcher,
                                                 model_has_profile)

__all__ = [
    "JournalTailer",
    "ProbationPublisher",
    "RetrainScheduler",
    "make_http_verdicts",
    "make_subprocess_launcher",
    "make_supervisor_push",
    "model_has_profile",
]
