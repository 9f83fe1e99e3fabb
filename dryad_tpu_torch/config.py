"""Training parameters of the port: the subset of ``dryad_tpu.config.Params``
that it runs (binary and regression objectives; leaf-wise and depthwise
growth, on the wired leaf-ordered layout or the legacy plan arm; bagging,
column sampling, evaluation and early stopping), and the growth-policy
helpers that pick a grower.

Defaults and LightGBM-style aliases are the reference's, so
``{"objective": "binary"}`` alone trains leaf-wise with 31 leaves and
``max_depth=-1``, which ``effective_depth_params`` maps to a depth cap as
the reference does.  A parameter the port does not run raises a
``ValueError`` naming it, unless it is given at the reference's default
value (so a params dict written for the reference at its defaults still
loads).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

OBJECTIVES = ("binary", "regression")
GROWTH_POLICIES = ("leafwise", "depthwise")

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
    "boosting": "gbdt",
    "goss_top_rate": 0.2,
    "goss_other_rate": 0.1,
    "drop_rate": 0.1,
    "skip_drop": 0.5,
    "max_drop": 50,
    "categorical_features": (),
    "monotone_constraints": (),
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
    # leaf-wise max_depth <= 0: "auto" maps it to a depth cap the batched
    # grower takes (effective_depth_params); "exact" keeps unbounded
    # best-first growth on the sequential grower
    unbounded_depth: str = "auto"
    # per-iteration Philox(seed, iteration) draw of the row bag and the
    # feature mask (engine/loop_state.sample_masks)
    subsample: float = 1.0
    colsample: float = 1.0
    seed: int = 0
    # evaluation / early stopping
    metric: str = ""              # "" = the objective's default
    # 0 = disabled.  Counts evaluations without improvement, so with
    # eval_period > 1 the patience in iterations is
    # early_stopping_rounds * eval_period
    early_stopping_rounds: int = 0
    eval_period: int = 1
    # binary: multiply the positive class's grad/hess (imbalanced data)
    scale_pos_weight: float = 1.0
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
                f"growth must be one of {GROWTH_POLICIES}, got "
                f"{self.growth!r}")
        if self.unbounded_depth not in ("auto", "exact"):
            raise ValueError("unbounded_depth must be auto|exact")
        if not (2 <= self.max_bins <= 65536):
            raise ValueError("max_bins must be in [2, 65536]")
        if self.min_data_in_leaf < 1:
            raise ValueError("min_data_in_leaf must be >= 1")
        if self.num_leaves < 2:
            raise ValueError("num_leaves must be >= 2")
        if self.num_trees < 0:
            # 0 is the warm-start no-op append; train() rejects it for a
            # fresh run
            raise ValueError("num_trees must be >= 0")
        if not (0.0 < self.learning_rate):
            raise ValueError("learning_rate must be > 0")
        if (not (0.0 < self.subsample <= 1.0)
                or not (0.0 < self.colsample <= 1.0)):
            raise ValueError("subsample/colsample must be in (0, 1]")
        if not (self.scale_pos_weight > 0.0):
            raise ValueError("scale_pos_weight must be > 0")
        if self.eval_period < 1:
            raise ValueError("eval_period must be >= 1")
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

    @classmethod
    def from_reference_dict(cls, d: Mapping[str, Any]) -> "Params":
        """The port's Params for a ``dryad_tpu`` model's params dict (a
        model file's ``meta.params``): a single-output binary or
        regression gbdt model.  Parameters outside the slice that only
        shape training on the reference's device (its histogram backend,
        chunking, ...) are dropped."""
        if d.get("objective", "binary") not in OBJECTIVES:
            raise ValueError(f"objective {d.get('objective')!r} is outside "
                             "this slice of the port")
        if int(d.get("num_class", 1)) != 1:
            raise ValueError("multiclass models are outside this slice "
                             "(M8)")
        if d.get("boosting", "gbdt") not in ("gbdt", "goss"):
            # rf averages and dart rescales at predict time
            raise ValueError(f"boosting={d.get('boosting')!r} is outside "
                             "this slice of the port")
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known}).validate()

    def to_dict(self) -> dict[str, Any]:
        """Every field; each is a field of ``dryad_tpu.config.Params`` of
        the same name and meaning, so the reference's ``Params.from_dict``
        loads it."""
        return dataclasses.asdict(self)


# ---- growth-policy helpers, the reference's (dryad_tpu/config.py) ----------
# The grower is a pure function of params and data shape, the same on both
# packages, so their trees agree.  The constants are the reference's.
LEAFWISE_HIST_BYTES_BUDGET = 256 << 20   # pinned expansion histogram buffer
MAX_FAST_DEPTH = 14
# peak-residency envelope of the batched grower: the pinned (Pf, 3, F, B)
# buffer fans out ~6x at the widest level, beside the row-scaled working
# set.  The reference sized it for a 16 GiB device; the port keeps it so
# that both packages pick the same grower.
LEAFWISE_TOTAL_BYTES_BUDGET = 12 << 30


def leafwise_fast_supported(p: Params, num_features: int,
                            total_bins: int,
                            num_rows: int | None = None) -> bool:
    """Whether the batched leaf-wise grower can take this config: a finite
    depth cap up to ``MAX_FAST_DEPTH``, histogram subtraction (the
    expansion derives every larger sibling by it), the pinned expansion
    buffer within its budget and, given ``num_rows``, the whole working
    set within the envelope."""
    D = p.max_depth
    if not 0 < D <= MAX_FAST_DEPTH:
        return False
    if not p.hist_subtraction:
        return False
    Pf = 1 << max(D - 1, 0)
    pinned = Pf * 3 * num_features * total_bins * 4
    if pinned > LEAFWISE_HIST_BYTES_BUDGET:
        return False
    if num_rows is not None:
        bin_bytes = 1 if total_bins <= 256 else 2
        rec_words = 2 + -(-num_features * bin_bytes // 4)
        K = p.num_outputs
        per_row = (num_features * bin_bytes      # binned matrix
                   + 4 * rec_words               # per-tree record table
                   + 16 * K + 8)                 # g/h/score + slots
        if 6 * pinned + num_rows * per_row > LEAFWISE_TOTAL_BYTES_BUDGET:
            return False
    return True


def effective_depth_params(p: Params, num_features: int,
                           total_bins: int,
                           num_rows: int | None = None) -> Params:
    """The ``max_depth=-1`` policy of leaf-wise growth: under
    ``unbounded_depth="auto"`` the depth becomes

        min(ceil(log2(num_leaves)) + 4, MAX_FAST_DEPTH)

    whenever the batched grower then takes the config; otherwise (and
    under ``"exact"``, or for depthwise growth, or an explicit cap) the
    params come back unchanged."""
    if (p.max_depth > 0 or p.growth != "leafwise"
            or p.unbounded_depth == "exact"):
        return p
    L = p.effective_num_leaves
    eff = min(max((L - 1).bit_length(), 1) + 4, MAX_FAST_DEPTH)
    if L > (1 << eff):
        return p                      # the cap cannot hold the leaf budget
    cand = p.replace(max_depth=eff)
    if leafwise_fast_supported(cand, num_features, total_bins, num_rows):
        return cand
    return p


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
