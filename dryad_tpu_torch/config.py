"""Training parameters of the port: the subset of ``dryad_tpu.config.Params``
that the depthwise grower runs (binary and regression objectives, the
wired leaf-ordered layout and the legacy plan arm).

Defaults and LightGBM-style aliases are the reference's.  A parameter the
slice does not run raises a ``ValueError`` naming it, unless it is given at
the reference's default value (so a params dict written for the reference
at its defaults still loads).  Note that the reference's default growth is
``"leafwise"``, which this slice does not run: pass ``growth="depthwise"``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

OBJECTIVES = ("binary", "regression")
GROWTH_POLICIES = ("depthwise",)

_PARAM_ALIASES = {
    "num_iterations": "num_trees",
    "n_estimators": "num_trees",
    "num_round": "num_trees",
    "num_boost_round": "num_trees",
    "eta": "learning_rate",
    "shrinkage_rate": "learning_rate",
    "max_bin": "max_bins",
    "reg_lambda": "lambda_l2",
    "lambda": "lambda_l2",
    "min_sum_hessian_in_leaf": "min_child_weight",
    "min_child_samples": "min_data_in_leaf",
    "min_data": "min_data_in_leaf",
    "min_gain_to_split": "min_split_gain",
    "bagging_fraction": "subsample",
    "feature_fraction": "colsample",
    "random_state": "seed",
    "bagging_seed": "seed",
    "application": "objective",
    "grow_policy": "growth",
    "num_classes": "num_class",
    "boosting_type": "boosting",
    "top_rate": "goss_top_rate",
    "other_rate": "goss_other_rate",
    "rate_drop": "drop_rate",
}

_OBJECTIVE_ALIASES = {
    "binary_logloss": "binary",
    "logistic": "binary",
    "binary:logistic": "binary",
    "l2": "regression",
    "mse": "regression",
    "reg:squarederror": "regression",
}

_GROWTH_ALIASES = {
    "leaf": "leafwise",
    "lossguide": "leafwise",
    "leaf_wise": "leafwise",
    "depth": "depthwise",
    "depth_wise": "depthwise",
}

# Reference parameters this slice does not run, at the reference's default
# values.  Given at these values they change nothing and are accepted; any
# other value raises.
_OUTSIDE_SLICE_DEFAULTS: dict[str, Any] = {
    "num_class": 1,
    "unbounded_depth": "auto",
    "boosting": "gbdt",
    "goss_top_rate": 0.2,
    "goss_other_rate": 0.1,
    "drop_rate": 0.1,
    "skip_drop": 0.5,
    "max_drop": 50,
    "subsample": 1.0,
    "colsample": 1.0,
    "categorical_features": (),
    "monotone_constraints": (),
    "metric": "",
    "early_stopping_rounds": 0,
    "eval_period": 1,
    "scale_pos_weight": 1.0,
    "alpha": 0.9,
    "fair_c": 1.0,
    "poisson_max_delta_step": 0.7,
    "sigmoid": 1.0,
    "ndcg_at": 10,
    "lambdarank_truncation": 30,
    "hist_backend": "auto",
    "predict_layout": "auto",
    "hist_reduce": "auto",
    "ch_max": 0,
    "rows_per_chunk": 65536,
    "deterministic": True,
    "hist_precision": "exact",
}


@dataclasses.dataclass(frozen=True)
class Params:
    """Frozen hyper-parameters for one training run of the port."""

    objective: str = "binary"
    num_trees: int = 100
    num_leaves: int = 31
    max_depth: int = -1
    learning_rate: float = 0.1
    max_bins: int = 256
    lambda_l2: float = 1.0
    min_child_weight: float = 1e-3
    min_data_in_leaf: int = 20
    min_split_gain: float = 0.0
    growth: str = "leafwise"
    seed: int = 0
    hist_subtraction: bool = True
    deep_layout: str = "auto"    # auto | legacy (the plan arm on request)

    @property
    def effective_num_leaves(self) -> int:
        if self.growth == "depthwise" and self.max_depth > 0:
            return (min(self.num_leaves, 2 ** self.max_depth)
                    if self.num_leaves > 0 else 2 ** self.max_depth)
        return self.num_leaves

    @property
    def max_nodes(self) -> int:
        return 2 * self.effective_num_leaves - 1

    @property
    def num_outputs(self) -> int:
        return 1

    @property
    def effective_learning_rate(self) -> float:
        return self.learning_rate

    def validate(self) -> "Params":
        if self.objective not in OBJECTIVES:
            raise ValueError(
                f"objective {self.objective!r} is outside this slice of the "
                f"port (supported: {OBJECTIVES})")
        if self.growth not in GROWTH_POLICIES:
            raise ValueError(
                f"growth {self.growth!r} is outside this slice of the port: "
                "pass growth='depthwise' (leaf-wise growth is a later slice)")
        if self.max_depth <= 0:
            raise ValueError(
                "max_depth must be > 0: depthwise growth needs a depth cap")
        if not (2 <= self.max_bins <= 65536):
            raise ValueError("max_bins must be in [2, 65536]")
        if self.min_data_in_leaf < 1:
            raise ValueError("min_data_in_leaf must be >= 1")
        if self.num_leaves < 2:
            raise ValueError("num_leaves must be >= 2")
        if self.num_trees < 1:
            raise ValueError("num_trees must be >= 1")
        if not (0.0 < self.learning_rate):
            raise ValueError("learning_rate must be > 0")
        if self.deep_layout not in ("auto", "legacy"):
            raise ValueError("deep_layout must be auto|legacy")
        return self

    def replace(self, **kw: Any) -> "Params":
        return dataclasses.replace(self, **kw).validate()

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Params":
        norm: dict[str, Any] = {}
        known = {f.name for f in dataclasses.fields(cls)}
        for key, value in d.items():
            key = _PARAM_ALIASES.get(key, key)
            if key == "objective" and isinstance(value, str):
                value = _OBJECTIVE_ALIASES.get(value, value)
            if key == "growth" and isinstance(value, str):
                value = _GROWTH_ALIASES.get(value, value)
            if key in _OUTSIDE_SLICE_DEFAULTS:
                default = _OUTSIDE_SLICE_DEFAULTS[key]
                if isinstance(default, tuple):
                    value = tuple(value)
                if value != default:
                    raise ValueError(
                        f"parameter {key!r}={value!r} is outside this slice "
                        "of the port (only its default "
                        f"{default!r} is accepted)")
                continue
            if key not in known:
                raise ValueError(f"unknown parameter {key!r}")
            norm[key] = value
        return cls(**norm).validate()


def make_params(params: "Params | Mapping[str, Any] | None" = None,
                **kw: Any) -> Params:
    """Accept a Params, a plain dict, or kwargs."""
    if params is None:
        return Params.from_dict(kw)
    if isinstance(params, Params):
        return params.replace(**kw) if kw else params.validate()
    merged = dict(params)
    merged.update(kw)
    return Params.from_dict(merged)
