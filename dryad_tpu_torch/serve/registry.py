"""Model registry: versioned boosters with hot swap, rollback, names, and
a device-memory budget with LRU eviction of staged trees.

Every loaded model gets a monotonically increasing integer version.  One
version is *active* (the default for requests that pin none);
``activate`` hot-swaps it and keeps the previous one on a history stack,
so ``rollback`` is one call.  A model may carry a ``name``, a routing
alias for co-serving several models; adding again under a name repoints
it.  In-flight requests resolve their version at submit time, so a swap
never changes a request already queued.

An entry stages its traversal tables lazily (``engine.predict.
stage_trees``: packed node words, or the SoA dict for a model whose
fields overflow them, plus the leaf values, the init scores and the
categorical bitsets) and keeps one upload of them on the serving device
(``device_state``), which every bucket's program reads.

``budget_bytes`` bounds the summed staged footprint; crossing it evicts
the least recently used staged entries.  Eviction drops only the staged
and device tensors (the booster, version, aliases and metrics history
stay), and ``on_evict(version)`` lets the predict cache drop the
version's CUDA graphs, which hold the same tensors, so the device memory
is really released.  The next request re-stages transparently.  The
active version and the entry that just staged are pinned, so the budget
is best-effort.

The counterpart of ``dryad_tpu/serve/registry.py``.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

import torch

from dryad_tpu_torch.booster import Booster


def indexed_device(device) -> torch.device:
    """``device`` with its card's index: ``cuda`` and ``cuda:0`` compare
    unequal, so a bare ``cuda`` would stage a second copy of a version's
    tables on the same card (and the cache a second stream for it)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _nbytes(arrays) -> int:
    total = 0
    for a in arrays:
        if isinstance(a, dict):
            total += sum(v.nbytes for v in a.values())
        elif a is not None:
            total += a.nbytes
    return total


class ModelEntry:
    """A registered model plus its lazily staged predict state.

    ``_lock`` guards the staging state; ``version``/``booster``/``name``
    are immutable, ``last_used`` is written by the registry under its
    lock, and ``closed`` is set once by ``ModelRegistry.unload``.  The
    entry lock is never held across the registry lock."""

    GUARDED_BY = {"_staged": "_lock", "_device": "_lock",
                  "_staged_bytes": "_lock", "_stage_count": "_lock",
                  "closed": "_lock"}

    def __init__(self, version: int, booster: Booster,
                 path: Optional[str] = None,
                 num_iteration: Optional[int] = None,
                 name: Optional[str] = None, registry=None):
        self.version = int(version)
        self.booster = booster
        self.path = path
        self.name = name
        self.num_iteration = num_iteration
        self.last_used = 0        # registry tick; LRU eviction order
        self.closed = False       # set by unload: staging is over forever
        self._registry = registry
        self._lock = threading.Lock()
        self._staged = None       # stage_trees' (table, value, bitset, init, n_iter)
        self._device: dict = {}   # torch.device -> device tensors
        self._staged_bytes = 0
        self._stage_count = 0     # > 1: re-staged after an eviction

    @property
    def num_outputs(self) -> int:
        return self.booster.num_outputs

    @property
    def depth_bound(self) -> int:
        return max(self.booster.max_depth_seen, 1)

    @property
    def is_staged(self) -> bool:
        with self._lock:
            return self._staged is not None

    @property
    def staged_layout(self) -> Optional[str]:
        """``"packed"`` or ``"legacy"`` (SoA) while staged, else None."""
        with self._lock:
            if self._staged is None:
                return None
            return "legacy" if isinstance(self._staged[0], dict) else "packed"

    @property
    def staged_bytes(self) -> int:
        """The budget's unit: the host tables plus one copy per device
        they were uploaded to."""
        with self._lock:
            if self._staged is None:
                return 0
            return self._staged_bytes * (1 + len(self._device))

    def staged(self):
        """``stage_trees``' numpy tables, built once (again after an
        eviction); notifies the registry so the budget can react."""
        notify = restage = False
        with self._lock:
            if self.closed:
                raise KeyError(
                    f"model version {self.version} is not loaded")
            if self._staged is None:
                from dryad_tpu_torch.engine.predict import stage_trees

                self._staged = stage_trees(self.booster, self.num_iteration)
                self._staged_bytes = _nbytes(self._staged[:4])
                self._stage_count += 1
                notify = True
                restage = self._stage_count > 1
            staged = self._staged
        if notify and self._registry is not None:
            self._registry._on_staged(self, restage=restage)
        return staged

    def device_state(self, device: torch.device) -> dict:
        """The staged tables as tensors on ``device`` (``table``,
        ``value``, ``bitset`` or None, ``init``, ``n_iter``), uploaded
        once and shared by every bucket's program.  Keyed by the indexed
        device, so ``cuda`` and ``cuda:0`` share one copy."""
        device = indexed_device(device)
        while True:
            staged = self.staged()
            with self._lock:
                if self._staged is not staged:
                    # a concurrent eviction fired between staged() and
                    # here: an upload now would be invisible to the budget
                    continue
                state = self._device.get(device)
                if state is None:
                    from dryad_tpu_torch.engine.predict import table_to

                    table, value, bitset, init, n_iter = staged
                    state = self._device[device] = {
                        "table": table_to(table, device),
                        "value": torch.from_numpy(value).to(device),
                        "bitset": (None if bitset is None
                                   else torch.from_numpy(bitset).to(device)),
                        "init": torch.from_numpy(init).to(device),
                        "n_iter": n_iter,
                    }
                return state

    def evict_staged(self) -> int:
        """Drop the staged and device tensors (model and stats stay);
        returns the host bytes released."""
        with self._lock:
            if self._staged is None:
                return 0
            freed = self._staged_bytes
            self._staged = None
            self._device = {}
            self._staged_bytes = 0
            return freed


class ModelRegistry:
    """Version, alias and active bookkeeping under ``_lock``, which is held
    only for dict and stack updates, never across staging or an entry
    lock: ``_on_staged`` picks victims under it and evicts them after
    releasing it."""

    GUARDED_BY = {"_models": "_lock", "_aliases": "_lock",
                  "_active": "_lock", "_history": "_lock",
                  "_next_version": "_lock", "_tick": "_lock"}

    def __init__(self, budget_bytes: Optional[int] = None, metrics=None,
                 on_evict: Optional[Callable[[int], None]] = None):
        self._lock = threading.Lock()
        self._models: dict[int, ModelEntry] = {}
        self._aliases: dict[str, int] = {}
        self._active: Optional[int] = None
        self._history: list[int] = []   # previously active versions
        self._next_version = 1
        self._tick = 0
        self.budget_bytes = None if budget_bytes is None else int(budget_bytes)
        self.metrics = metrics
        self.on_evict = on_evict

    # ---- loading -----------------------------------------------------------
    def load(self, path: str, *, activate: bool = True,
             num_iteration: Optional[int] = None,
             name: Optional[str] = None) -> int:
        """Register a model file (npz or text, ``Booster.load_any``, either
        package's); returns its version."""
        return self.add(Booster.load_any(path), path=path, activate=activate,
                        num_iteration=num_iteration, name=name)

    def load_latest_checkpoint(self, directory: str, *, activate: bool = True,
                               num_iteration: Optional[int] = None,
                               name: Optional[str] = None) -> int:
        """Register the newest checkpoint a ``Checkpointer`` left in
        ``directory``."""
        from dryad_tpu_torch.checkpoint import Checkpointer

        latest = Checkpointer(directory).latest()
        if latest is None:
            raise FileNotFoundError(f"no checkpoints in {directory!r}")
        booster, it = latest
        return self.add(booster, path=f"{directory}@{it}", activate=activate,
                        num_iteration=num_iteration, name=name)

    def add(self, booster: Booster, *, path: Optional[str] = None,
            activate: bool = True, num_iteration: Optional[int] = None,
            name: Optional[str] = None) -> int:
        with self._lock:
            version = self._next_version
            self._next_version += 1
            self._models[version] = ModelEntry(version, booster, path,
                                               num_iteration, name=name,
                                               registry=self)
            if name is not None:
                self._aliases[str(name)] = version
            if activate or self._active is None:
                if self._active is not None:
                    self._history.append(self._active)
                self._active = version
            return version

    # ---- lifecycle ---------------------------------------------------------
    def activate(self, version: int) -> None:
        """Hot-swap the active version (it must be loaded)."""
        with self._lock:
            version = int(version)
            if version not in self._models:
                raise KeyError(f"model version {version} is not loaded")
            if version == self._active:
                return
            if self._active is not None:
                self._history.append(self._active)
            self._active = version

    def rollback(self) -> int:
        """Re-activate the previously active version; returns it."""
        with self._lock:
            while self._history:
                prev = self._history.pop()
                if prev in self._models:      # skip versions unloaded since
                    self._active = prev
                    return prev
            raise LookupError("no previous version to roll back to")

    def unload(self, version: int) -> None:
        with self._lock:
            version = int(version)
            if version == self._active:
                raise ValueError("cannot unload the active version; "
                                 "activate or rollback first")
            entry = self._models.pop(version, None)
            for alias, v in list(self._aliases.items()):
                if v == version:
                    del self._aliases[alias]
        if entry is not None:
            # free the tensors now: the budget's victim scan can never
            # reach this entry again
            with entry._lock:
                entry.closed = True
            entry.evict_staged()
            if self.on_evict is not None:
                self.on_evict(version)

    # ---- memory budget -----------------------------------------------------
    def _on_staged(self, entry: ModelEntry, restage: bool = False) -> None:
        """Budget enforcement, called by an entry right after it stages
        (outside its lock)."""
        if restage and self.metrics is not None:
            self.metrics.record_restage(entry.version)
        if self.budget_bytes is None:
            return
        victims: list[ModelEntry] = []
        with self._lock:
            staged = [e for e in self._models.values() if e.staged_bytes > 0]
            total = sum(e.staged_bytes for e in staged)
            # LRU first; the active version and the entry that just staged
            # are pinned
            for e in sorted(staged, key=lambda e: e.last_used):
                if total <= self.budget_bytes:
                    break
                if e.version == self._active or e is entry:
                    continue
                victims.append(e)
                total -= e.staged_bytes
        for e in victims:
            if e.evict_staged() > 0:
                if self.on_evict is not None:
                    self.on_evict(e.version)
                if self.metrics is not None:
                    self.metrics.record_eviction(e.version)

    def memory(self) -> dict:
        """The resident footprint and who is staged, in which layout."""
        with self._lock:
            entries = dict(self._models)
        staged = {v: e.staged_bytes for v, e in entries.items()
                  if e.staged_bytes > 0}
        return {
            "budget_bytes": self.budget_bytes,
            "staged_bytes": sum(staged.values()),
            "staged_versions": sorted(staged),
            "staged_layouts": {v: entries[v].staged_layout
                               for v in sorted(staged)},
        }

    # ---- lookup ------------------------------------------------------------
    def get(self, version: Optional[int] = None, *,
            name: Optional[str] = None) -> ModelEntry:
        with self._lock:
            if name is not None:
                if version is not None:
                    raise ValueError("pass either version or name, not both")
                version = self._aliases.get(str(name))
                if version is None:
                    raise KeyError(f"no model named {name!r}")
            if version is None:
                version = self._active
            if version is None:
                raise LookupError("registry has no models loaded")
            entry = self._models.get(int(version))
            if entry is None:
                raise KeyError(f"model version {version} is not loaded")
            self._tick += 1
            entry.last_used = self._tick
            return entry

    @property
    def active_version(self) -> Optional[int]:
        with self._lock:
            return self._active

    def versions(self) -> list[int]:
        with self._lock:
            return sorted(self._models)

    def aliases(self) -> dict:
        with self._lock:
            return dict(self._aliases)
