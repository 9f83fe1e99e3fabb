"""``resolve(gate, shape_features, device_kind) -> arm``: the one entry.

Each routed call site keeps its signature and calls in with its shape
features; the threshold CONSTANTS live in the table, the COMPARISON
SEMANTICS live here, one resolver per gate of the reference
(``dryad_tpu/policy/gates.py``), the same comparisons.  Every resolution
is a pure function of (params, feature/bin shape, rank count, platform),
never of the row count, so every rank of a group picks the same arm.
Every resolution is recorded: ``decisions()`` is the serving ``stats()``
block, ``dryad_policy_choice{gate,arm}`` the gauge (a no-op with the
registry disabled).

The device kind is read (``device.current_device_kind``, lazy and
memoized) only when some device entry of the table gives the gate a value
other than ``_default``'s (``CalibrationTable.overrides_gate``): a gate
no entry changes resolves without touching a device, whatever the table
holds.

Three gates route no call in the port: ``partition`` (no masked-reduce /
gather column select), ``chunk_cap`` (the chunked dispatch arm is not
ported; ``resilience/policy.py`` reads its ladder through ``gate_value``)
and ``hist_backend`` (the port's ``"auto"`` takes the kernels
on every platform it has, whatever a table says).  They resolve all the
same, so a table crosses whole.
"""

from __future__ import annotations

from typing import Callable, Optional

from dryad_tpu_torch.policy import table as _table
from dryad_tpu_torch.policy.device import current_device_kind

_UNSET = object()

# gate -> (values, features) -> arm.  Comparison semantics only; every
# constant comes from the overlaid table values.
_RESOLVERS: dict = {}


def _resolver(name: str):
    def deco(fn: Callable) -> Callable:
        _RESOLVERS[name] = fn
        return fn
    return deco


@_resolver("partition")
def _partition(v: dict, f: dict) -> str:
    row_bytes = f["num_features"] * f["itemsize"]
    return "reduce" if row_bytes <= v["reduce_max_row_bytes"] else "gather"


@_resolver("hist_reduce")
def _hist_reduce(v: dict, f: dict) -> str:
    # config.hist_reduce_resolved.  bin_bytes is the binned matrix's
    # itemsize (u8 up to 256 bins, else u16): structural, not calibrated
    bin_bytes = 1 if f["total_bins"] <= 256 else 2
    wide = (f["num_features"] * f["total_bins"] * bin_bytes
            >= v["wide_bytes"])
    return "feature" if (wide and f["n_shards"] > 1) else "fused"


@_resolver("hist_backend")
def _hist_backend(v: dict, f: dict) -> str:
    # the reference's histogram "auto": the kernels' arm on the listed
    # platforms, its XLA arm elsewhere (no site in the port)
    return "pallas" if f["platform"] in v["pallas_platforms"] else "xla"


@_resolver("deep_layout")
def _deep_layout(v: dict, f: dict) -> str:
    # levelwise.deep_layout_supported's calibrated caps (the structural
    # exclusions stay at the call site: a table can narrow, never widen)
    if f["num_leaves"] > v["max_leaves"]:
        return "legacy"
    if f["record_bytes"] > v["max_record_bytes"]:
        return "legacy"
    return "layout"


@_resolver("leafwise_layout")
def _leafwise_layout(v: dict, f: dict) -> str:
    # leafwise_fast.leafwise_layout_supported: 2^D run slots against the
    # segment cap
    d = f["max_depth"]
    if not 0 < d or (1 << d) > v["max_segments"]:
        return "legacy"
    return "layout"


@_resolver("predict_layout")
def _predict_layout(v: dict, f: dict) -> str:
    # predict.stage_trees "auto": the preferred arm when every traversal
    # field fits its packed width, legacy (SoA) otherwise
    return v["preferred"] if f["fits"] else "legacy"


@_resolver("predict_sharded")
def _predict_sharded(v: dict, f: dict) -> str:
    # rows x num_outputs must carry real work
    return "sharded" if f["work"] >= v["min_work"] else "single"


@_resolver("chunk_cap")
def _chunk_cap(v: dict, f: dict) -> str:
    # the decision record is the ladder spelling; consumers take the tuple
    # through gate_value()
    return "/".join(str(int(s)) for s in v["ladder"])


#: the gate catalog (stable order: README table, selftest sweep)
GATE_NAMES = tuple(_RESOLVERS)

#: newest decision per gate: {gate: {"arm", "detail", "count"}}
_DECISIONS: dict = {}
_LAST_ARM: dict = {}


def resolve(gate: str, shape_features: dict,
            device_kind=_UNSET, table=None,
            detail: Optional[str] = None) -> str:
    """Resolve one gate for one shape.  ``device_kind`` defaults to the
    process's card (``None`` explicitly = the defaults); ``table`` to the
    process table (``current_table``)."""
    if gate not in _RESOLVERS:
        raise KeyError(f"unknown policy gate {gate!r} "
                       f"(catalog: {', '.join(GATE_NAMES)})")
    tab = table if table is not None else _table.current_table()
    values = tab.gate_values(gate, _device_kind_for(tab, gate, device_kind))
    arm = _RESOLVERS[gate](values, shape_features)
    _note(gate, arm, detail)
    return arm


def _device_kind_for(tab, gate: str, device_kind):
    """The effective device key, read from the card only when a device
    entry of ``tab`` could change this gate's answer (module doc)."""
    if device_kind is not _UNSET:
        return device_kind
    if not tab.overrides_gate(gate):
        return None
    return current_device_kind()


def gate_value(gate: str, key: str, device_kind=_UNSET, table=None):
    """The raw calibrated value behind a gate (serving's sharding
    threshold) under the same overlay as ``resolve``; lists come back as
    tuples."""
    tab = table if table is not None else _table.current_table()
    values = tab.gate_values(gate, _device_kind_for(tab, gate, device_kind))
    if key not in values:
        raise KeyError(f"gate {gate!r} has no value {key!r}")
    v = values[key]
    return tuple(v) if isinstance(v, list) else v


def _note(gate: str, arm: str, detail: Optional[str]) -> None:
    prev = _DECISIONS.get(gate)
    count = (prev["count"] + 1) if prev else 1
    _DECISIONS[gate] = {"arm": arm, "detail": detail, "count": count}
    from dryad_tpu_torch.obs.registry import default_registry

    reg = default_registry()
    if not reg.enabled:
        return
    fam = reg.gauge("dryad_policy_choice",
                    "Chosen dispatch arm per policy gate (1 = active)")
    last = _LAST_ARM.get(gate)
    if last is not None and last != arm:
        fam.labels(gate=gate, arm=last).set(0.0)
    _LAST_ARM[gate] = arm
    fam.labels(gate=gate, arm=arm).set(1.0)


def decisions() -> dict:
    """Snapshot of the newest decision per gate (the ``stats()`` block)."""
    return {g: dict(d) for g, d in _DECISIONS.items()}


def reset_decisions() -> None:
    """Forget recorded decisions (test isolation)."""
    _DECISIONS.clear()
    _LAST_ARM.clear()


def stats_block() -> dict:
    """The serving ``stats()["policy"]`` block: where the table came from,
    whether it fell back, which device key resolutions use, and the newest
    decision per gate (with predict_layout's fallback reason: why a model
    serves the SoA traversal)."""
    tab = _table.current_table()
    return {
        "device_kind": current_device_kind(),
        "table_source": tab.source,
        "table_explicit": tab.explicit,
        "fallback_reason": tab.fallback_reason,
        "device_keys": sorted(tab.devices),
        "decisions": decisions(),
    }
