"""Training parameters of the port: the subset of ``dryad_tpu.config.Params``
that it runs (the reference's nine objectives: binary, multiclass
softmax, regression, the robust and count family l1, huber, fair,
quantile and poisson, and lambdarank ranking; leaf-wise and depthwise
growth, on the wired leaf-ordered layout or the legacy plan arm;
categorical features; monotone constraints; bagging, column sampling,
evaluation and early stopping; the boosting modes gbdt, goss, dart and
rf), and the growth-policy helpers that pick a grower.

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

OBJECTIVES = ("binary", "multiclass", "regression", "lambdarank",
              "l1", "huber", "fair", "quantile", "poisson")
GROWTH_POLICIES = ("leafwise", "depthwise")
BOOSTING = ("gbdt", "goss", "dart", "rf")

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
    "softmax": "multiclass",
    "multi:softmax": "multiclass",
    "multiclassova": "multiclass",
    "l2": "regression",
    "mse": "regression",
    "reg:squarederror": "regression",
    "mae": "l1",
    "regression_l1": "l1",
    "reg:absoluteerror": "l1",
    "reg:quantileerror": "quantile",
    "count:poisson": "poisson",
    "lambdamart": "lambdarank",
    "rank:ndcg": "lambdarank",
}

_GROWTH_ALIASES = {
    "leaf": "leafwise",
    "lossguide": "leafwise",
    "leaf_wise": "leafwise",
    "depth": "depthwise",
    "depth_wise": "depthwise",
}

# Reference parameters the port leaves out by design, at the reference's
# default values.  Given at these values they change nothing and are
# accepted; any other value raises.  ``ch_max`` caps the reference's chunked
# dispatch, a TPU program-length workaround the port does not have.
_OUTSIDE_SLICE_DEFAULTS: dict[str, Any] = {
    "ch_max": 0,
}


@dataclasses.dataclass(frozen=True)
class Params:
    """Frozen hyper-parameters for one training run of the port."""

    objective: str = "binary"
    # multiclass: K softmax outputs, K trees per iteration
    num_class: int = 1
    num_trees: int = 100
    num_leaves: int = 31
    max_depth: int = -1
    learning_rate: float = 0.1
    max_bins: int = 256
    # categorical features' ids; the Dataset's mapper decides what the
    # grower treats as categorical, this list what the mapper was asked for
    categorical_features: tuple[int, ...] = ()
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
    # gbdt: plain boosting.  goss: keep the goss_top_rate share of rows
    # with the largest |g|, pick goss_other_rate of the rest and amplify
    # their g/h by (1 - top) / other (engine/goss.py).  dart: each
    # iteration drops earlier iterations with prob drop_rate (none with
    # prob skip_drop, at most max_drop), fits against the pruned ensemble,
    # then scales the new trees by 1/(k+1) and the k dropped ones by
    # k/(k+1).  rf: every tree fits the g/h of the constant init score on
    # its own bag, at shrinkage 1, and predict averages the trees.
    boosting: str = "gbdt"
    goss_top_rate: float = 0.2
    goss_other_rate: float = 0.1
    drop_rate: float = 0.1
    skip_drop: float = 0.5
    max_drop: int = 50
    # per-feature -1/0/+1, () unconstrained: a +1 feature splits only where
    # the right child's (clamped) output is >= the left's, and children
    # inherit output bounds (LightGBM's "basic" mode)
    monotone_constraints: tuple[int, ...] = ()
    # evaluation / early stopping
    metric: str = ""              # "" = the objective's default
    # 0 = disabled.  Counts evaluations without improvement, so with
    # eval_period > 1 the patience in iterations is
    # early_stopping_rounds * eval_period
    early_stopping_rounds: int = 0
    eval_period: int = 1
    # binary: multiply the positive class's grad/hess (imbalanced data)
    scale_pos_weight: float = 1.0
    # the robust and count family (LightGBM conventions): ``alpha`` is the
    # Huber delta and the quantile level, ``fair_c`` the Fair-loss scale,
    # ``poisson_max_delta_step`` the Poisson hessian stabiliser
    alpha: float = 0.9
    fair_c: float = 1.0
    poisson_max_delta_step: float = 0.7
    # LambdaMART: the pairwise sigmoid's sigma, the NDCG eval cut-off, and
    # the lambda pass's truncation to pairs that touch the top k
    sigmoid: float = 1.0
    ndcg_at: int = 10
    lambdarank_truncation: int = 30
    hist_subtraction: bool = True
    deep_layout: str = "auto"    # auto | legacy (the plan arm on request)
    # the cross-rank histogram reduction of a process group
    # (``hist_reduce_resolved``): one int64 all-reduce of every pass
    # ("fused"), or a reduce-scatter of each level's pass over features
    # with a combine of the ranks' best splits ("feature"); without a
    # group it changes nothing
    hist_reduce: str = "auto"    # auto | fused | feature
    # predict's traversal table: packed node words when every field fits
    # (auto), always (packed: raises on overflow), or structure-of-arrays
    # (legacy)
    predict_layout: str = "auto"
    # the histogram passes' arm.  "auto" and "pallas" take the kernels (K1,
    # K3, and the wired layout's K1 and K2) wherever K1 holds the bins
    # (``hist.MAX_BINS``), and arm A1 past them, as the reference's "auto"
    # does on its accelerator.  "xla" takes arm A1
    # (``histogram.build_hist_a1``: plain torch int64 scatter-adds, the
    # counterpart of the reference's XLA arm) for every pass, and with it
    # the legacy plan arm, since the wired layout feeds the kernels: the
    # reference's device-against-device comparison arm.  An explicit
    # choice, never a fallback; both arms sum one fixed point, so their
    # histograms agree bit for bit
    hist_backend: str = "auto"   # auto | xla | pallas
    # arm A1's row chunk: its scratch is (chunk, F) cells at a time.  The
    # chunking changes no bit (integer sums); values below 1 count as 1,
    # as the reference's chunker reads them
    rows_per_chunk: int = 65536
    # accepted for the reference's params dicts; the reference never reads
    # it, and the port is always deterministic (fixed-point integer sums)
    deterministic: bool = True
    # "fast" is the reference's single-pass bf16 MXU product.  The port's
    # fixed-point sums are exact at either value, so "fast" trees equal
    # "exact" trees: accepted, and changes nothing
    hist_precision: str = "exact"

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
        """Score columns, and trees per iteration."""
        return self.num_class if self.objective == "multiclass" else 1

    @property
    def effective_learning_rate(self) -> float:
        """1.0 under rf, which averages full-strength trees; every leaf
        finalizer reads this, never ``learning_rate``."""
        return 1.0 if self.boosting == "rf" else self.learning_rate

    def validate(self) -> "Params":
        if self.objective not in OBJECTIVES:
            raise ValueError(
                f"objective {self.objective!r} is outside this slice of the "
                f"port (supported: {OBJECTIVES})")
        if self.objective == "multiclass" and self.num_class < 2:
            raise ValueError("multiclass requires num_class >= 2")
        if self.growth not in GROWTH_POLICIES:
            raise ValueError(
                f"growth must be one of {GROWTH_POLICIES}, got "
                f"{self.growth!r}")
        if self.unbounded_depth not in ("auto", "exact"):
            raise ValueError("unbounded_depth must be auto|exact")
        if not (2 <= self.max_bins <= 65536):
            raise ValueError("max_bins must be in [2, 65536]")
        if self.categorical_features and self.max_bins > 256:
            raise ValueError("categorical splits support max_bins <= 256 "
                             "(bitset width)")
        if self.min_data_in_leaf < 1:
            raise ValueError("min_data_in_leaf must be >= 1")
        if any(m not in (-1, 0, 1) for m in self.monotone_constraints):
            raise ValueError(
                "monotone_constraints entries must be -1, 0 or +1")
        if self.boosting not in BOOSTING:
            raise ValueError(f"boosting must be one of {BOOSTING}, got "
                             f"{self.boosting!r}")
        if self.boosting == "rf" and self.subsample >= 1.0:
            # every tree would fit the same g/h on the same rows
            raise ValueError(
                "boosting='rf' requires subsample < 1.0: trees only "
                "de-correlate through per-iteration row bagging")
        if self.boosting == "dart":
            if not (0.0 <= self.drop_rate <= 1.0):
                raise ValueError("drop_rate must be in [0, 1]")
            if not (0.0 <= self.skip_drop <= 1.0):
                raise ValueError("skip_drop must be in [0, 1]")
            if self.max_drop < 1:
                raise ValueError("max_drop must be >= 1")
            if self.early_stopping_rounds:
                # later drops rescale the trees the best iteration was
                # scored with
                raise ValueError(
                    "early_stopping_rounds is incompatible with "
                    "boosting='dart'")
        if self.boosting == "goss":
            if (not (0 < self.goss_top_rate < 1)
                    or not (0 < self.goss_other_rate < 1)):
                raise ValueError("goss rates (goss_top_rate, "
                                 "goss_other_rate) must be in (0, 1)")
            if self.goss_top_rate + self.goss_other_rate > 1:
                raise ValueError(
                    "goss_top_rate + goss_other_rate must be <= 1")
            if self.subsample < 1.0:
                raise ValueError("goss replaces bagging; set subsample=1.0")
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
        if self.objective == "quantile" and not (0.0 < self.alpha < 1.0):
            raise ValueError("quantile objective needs alpha in (0, 1)")
        if self.objective == "huber" and not (self.alpha > 0.0):
            raise ValueError("huber objective needs alpha (delta) > 0")
        if self.objective == "fair" and not (self.fair_c > 0.0):
            raise ValueError("fair objective needs fair_c > 0")
        if (self.objective == "poisson"
                and not (self.poisson_max_delta_step >= 0.0)):
            raise ValueError("poisson_max_delta_step must be >= 0")
        if self.eval_period < 1:
            raise ValueError("eval_period must be >= 1")
        if self.deep_layout not in ("auto", "legacy"):
            raise ValueError("deep_layout must be auto|legacy")
        if self.hist_reduce not in ("auto", "fused", "feature"):
            raise ValueError("hist_reduce must be auto|fused|feature")
        if self.predict_layout not in ("auto", "packed", "legacy"):
            raise ValueError("predict_layout must be auto|packed|legacy")
        if self.hist_backend not in ("auto", "xla", "pallas"):
            raise ValueError("hist_backend must be auto|xla|pallas")
        if self.hist_precision not in ("exact", "fast"):
            raise ValueError("hist_precision must be exact|fast")
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
            if key in ("categorical_features", "monotone_constraints"):
                value = tuple(int(v) for v in value)
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
        model file's ``meta.params``): a model of any of the nine
        objectives and any boosting mode.  Parameters that only shape
        training on the reference's device (its histogram backend,
        chunking, ...) are dropped."""
        if d.get("objective", "binary") not in OBJECTIVES:
            raise ValueError(f"objective {d.get('objective')!r} is outside "
                             "this slice of the port")
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in known}
        for key in ("categorical_features", "monotone_constraints"):
            if key in kw:
                kw[key] = tuple(int(v) for v in kw[key])
        return cls(**kw).validate()

    def to_dict(self) -> dict[str, Any]:
        """Every field; each is a field of ``dryad_tpu.config.Params`` of
        the same name and meaning, so the reference's ``Params.from_dict``
        loads it."""
        return dataclasses.asdict(self)


def check_rf_continuation(prev: Params, p: Params) -> None:
    """Refuse to continue a model across rf and non-rf boosting: rf
    predictions average the trees, so a mixed tree table has no sound
    aggregation."""
    if "rf" in (prev.boosting, p.boosting) and prev.boosting != p.boosting:
        raise ValueError(
            "cannot continue training across rf and non-rf boosting: rf "
            "predictions average the trees, so a mixed tree table has no "
            "sound aggregation")


# ---- growth-policy helpers, the reference's (dryad_tpu/config.py) ----------
# hist_reduce="auto" takes the feature arm where one slot's histogram
# column, F * B * bin_bytes, is at least this many bytes (the reference's
# committed policy default, ``policy/gates.py``)
HIST_REDUCE_WIDE_BYTES = 262144


def hist_reduce_resolved(p: Params, num_features: int, total_bins: int,
                         n_ranks: int) -> str:
    """"fused" or "feature": the explicit choice, else "feature" when the
    histogram column is wide (``HIST_REDUCE_WIDE_BYTES``) and there is more
    than one rank.  A pure function of params, shape and rank count, never
    of rows, so every rank picks the same arm."""
    if p.hist_reduce != "auto":
        return p.hist_reduce
    bin_bytes = 1 if total_bins <= 256 else 2
    wide = num_features * total_bins * bin_bytes >= HIST_REDUCE_WIDE_BYTES
    return "feature" if (wide and n_ranks > 1) else "fused"


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
