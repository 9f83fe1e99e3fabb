"""Canonical digests of the census's op streams, and the goldens store.

The counterpart of ``dryad_tpu/analysis/digests.py``.  The reference
digests traced jaxprs; the port has no traced program, so its digest is
taken over what an arm really dispatched (``census.py``): one entry per
op in dispatch order (its name, and each tensor argument's dtype and
rank) and one entry per kernel event (its name).  Shapes, addresses and
values stay out, so a digest moves when the program changes (an op added,
removed, reordered or retyped) and never with the arm's row count.

A different torch version legitimately dispatches other ops for the same
code; the store is stamped with the version, and a mismatch is reported
as a rebaseline, not as code drift.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Iterable, Optional

GOLDENS_PATH = os.path.join(os.path.dirname(__file__), "goldens",
                            "census.json")


def canonical_digest(stream: Iterable[str]) -> str:
    """sha256 over an op stream, one entry per line."""
    h = hashlib.sha256()
    for entry in stream:
        h.update(entry.encode())
        h.update(b"\x00")
    return h.hexdigest()[:32]


def load_goldens(path: Optional[str] = None) -> dict:
    path = path or GOLDENS_PATH
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def save_goldens(data: dict, path: Optional[str] = None) -> str:
    path = path or GOLDENS_PATH
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=1, sort_keys=True)
        f.write("\n")
    return path
