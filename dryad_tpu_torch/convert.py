"""Carry a model across from the reference package.

The reference's model is passed in as plain numpy arrays and dicts
(``dryad_tpu.Booster.tree_arrays()``, ``mapper.to_json_dict()``,
``init_score``, ``params.to_dict()``, ``max_depth_seen``), so this module
imports nothing of the reference.  The mapper state plays the part of the
weights: it is what makes the port bin new rows exactly as the reference
does.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from dryad_tpu_torch.booster import Booster
from dryad_tpu_torch.config import OBJECTIVES, Params
from dryad_tpu_torch.data.sketch import BinMapper


def booster_from_reference(tree_arrays: dict, mapper_json: dict, init_score,
                           params_dict: dict,
                           max_depth_seen: int) -> Booster:
    """The port's Booster for a reference model.  Only what predict reads
    must be in the slice: a single-output binary or regression gbdt model
    without categorical splits; training-only parameters are not
    carried."""
    if params_dict.get("objective", "binary") not in OBJECTIVES:
        raise ValueError(f"objective {params_dict.get('objective')!r} is "
                         "outside this slice of the port")
    if int(params_dict.get("num_class", 1)) != 1:
        raise ValueError("multiclass models are outside this slice")
    if params_dict.get("boosting", "gbdt") not in ("gbdt", "goss"):
        # rf averages and dart rescales at predict time
        raise ValueError(f"boosting={params_dict.get('boosting')!r} is "
                         "outside this slice of the port")
    if mapper_json.get("type", "plain") != "plain":
        raise ValueError("bundled (EFB) mappers are outside this slice")
    if np.asarray(tree_arrays["is_cat"]).any():
        raise ValueError("categorical splits are outside this slice")
    known = {f.name for f in dataclasses.fields(Params)}
    kept = {k: v for k, v in params_dict.items() if k in known}
    params = Params(**kept)
    return Booster(params, BinMapper.from_json_dict(mapper_json),
                   {k: np.asarray(v) for k, v in tree_arrays.items()},
                   init_score, max_depth_seen)
