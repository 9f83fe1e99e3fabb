"""The one ``device_kind`` derivation of the port.

The calibration table keys its entries by the card's name,
``torch.cuda.get_device_name(0)`` (for example "NVIDIA H100 80GB HBM3"),
and the profile artifacts stamp it.  Importing this module imports no
``torch``: the probe below is lazy, memoized and best-effort, and every
failure (no torch, no card, a wedged card) resolves to ``None``, which
the table maps to the committed defaults.  The counterpart of
``dryad_tpu/policy/device.py``, which returns the jax device kind.
"""

from __future__ import annotations

from typing import Optional

_UNRESOLVED = object()
_cached: object = _UNRESOLVED


def current_device_kind() -> Optional[str]:
    """The first card's name, or None without a card.  Memoized;
    ``reset()`` un-memoizes (tests)."""
    global _cached
    if _cached is _UNRESOLVED:
        try:
            import torch  # dryadlint: disable=policy-torch-free -- the ONE sanctioned lazy device probe; resolution paths pass device_kind explicitly or accept the None->defaults fallback

            _cached = (torch.cuda.get_device_name(0)
                       if torch.cuda.is_available() else None)
        except Exception:  # noqa: BLE001 -- a stamp/table probe never raises
            _cached = None
    return _cached  # type: ignore[return-value]


def reset() -> None:
    """Forget the memoized kind (test isolation)."""
    global _cached
    _cached = _UNRESOLVED
