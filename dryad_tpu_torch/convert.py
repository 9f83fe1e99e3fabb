"""Carry a model across from the reference package.

The reference's model is passed in as plain numpy arrays and dicts
(``dryad_tpu.Booster.tree_arrays()``, ``mapper.to_json_dict()``,
``init_score``, ``params.to_dict()``, ``max_depth_seen``), so this module
imports nothing of the reference.  The mapper state plays the part of the
weights: it is what makes the port bin new rows exactly as the reference
does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from dryad_tpu_torch.booster import Booster
from dryad_tpu_torch.config import Params
from dryad_tpu_torch.data.bundling import mapper_from_json_dict


def booster_from_reference(tree_arrays: dict, mapper_json: dict, init_score,
                           params_dict: dict, max_depth_seen: int,
                           best_iteration: int = -1,
                           train_state: Optional[dict] = None) -> Booster:
    """The port's Booster for a reference model (its ``best_iteration``
    and ``train_state`` carried too, so it resumes or predicts as the
    reference would).  Only what predict reads must be in the slice: a
    model of any of the nine objectives and any boosting mode (K outputs
    and K trees per iteration for multiclass; an rf model predicts
    averaged), with categorical splits and a plain or bundled (EFB)
    mapper; parameters that only shape the reference's training are not
    carried.  ``Booster.load`` of a reference model file
    is the other way across."""
    params = Params.from_reference_dict(params_dict)
    return Booster(params, mapper_from_json_dict(mapper_json),
                   {k: np.asarray(v) for k, v in tree_arrays.items()},
                   init_score, max_depth_seen, best_iteration, train_state)
