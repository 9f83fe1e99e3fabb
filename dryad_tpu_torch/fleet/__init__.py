"""dryad_tpu_torch.fleet — a replicated serving pool behind one router.

The serve stack (``dryad_tpu_torch/serve``) is one process: one crash,
stall or hot-swap pause takes down all traffic.  This package is the
shared-nothing layer above it: N serve subprocesses supervised like
training runs (crash and hang detection, budgeted respawn with backoff,
an append-only journal: the resilience machinery pointed at processes
instead of device faults), fronted by a thin stdlib router (health-aware
routing, one retry on a different replica, priority-classed load
shedding, per-model admission caps), with zero-drop rolling model pushes
(drain at the pinned version, then swap, replica by replica), one
aggregated ``/metrics``/``/healthz`` scrape for the whole pool, and an
SLO-driven capacity loop (``CapacityController``) that adds a replica on
a sustained p99 breach or admission saturation and drains one back out
on sustained headroom, inside declared min/max bounds.

The package imports no torch, directly or transitively (the control
plane must keep supervising while a card is wedged): replicas own the
card; the fleet owns processes and sockets.  Several replicas share one
card.  Entry points::

    from dryad_tpu_torch.fleet import FleetSupervisor, FleetRouter, serve_argv
    sup = FleetSupervisor(
        lambda i, pf: serve_argv(["m.dryad"], pf, device="cuda"),
        n_replicas=2, journal="fleet.jsonl").start()
    router = FleetRouter(sup, port=8000).start()

or ``python -m dryad_tpu_torch fleet --model m.dryad --replicas 2 --port
8000``.
"""

from dryad_tpu_torch.fleet.autoscale import CapacityController
from dryad_tpu_torch.fleet.replica import (ReplicaProcess,
                                           ReplicaStartupError, serve_argv)
from dryad_tpu_torch.fleet.router import (FleetRouter, make_fleet_router,
                                          relabel_exposition)
from dryad_tpu_torch.fleet.supervisor import FleetSupervisor, ReplicaSlot

__all__ = [
    "CapacityController", "FleetRouter", "FleetSupervisor",
    "ReplicaProcess", "ReplicaSlot", "ReplicaStartupError",
    "make_fleet_router", "relabel_exposition", "serve_argv",
]
