"""scikit-learn-style estimators over ``train`` and ``predict``, the
counterparts of ``dryad_tpu/sklearn.py``: ``fit(X, y)``, ``predict``,
``predict_proba``, ``feature_importances_`` (gain) and
``get_params``/``set_params``.  They import no sklearn, yet fit its
estimator protocol.  ``device`` (default: the card) takes the place of
the reference's ``backend``.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np

from dryad_tpu_torch import Booster, Dataset, train
from dryad_tpu_torch.config import Params, make_params


class _DryadModel:
    _objective: str = "regression"

    def __init__(
        self,
        num_trees: int = 100,
        num_leaves: int = 31,
        max_depth: int = -1,
        learning_rate: float = 0.1,
        max_bins: int = 256,
        lambda_l2: float = 1.0,
        min_child_weight: float = 1e-3,
        min_data_in_leaf: int = 20,
        min_split_gain: float = 0.0,
        growth: str = "leafwise",
        subsample: float = 1.0,
        colsample: float = 1.0,
        seed: int = 0,
        categorical_features: Sequence[int] = (),
        early_stopping_rounds: int = 0,
        device=None,
        **extra_params: Any,
    ):
        self.num_trees = num_trees
        self.num_leaves = num_leaves
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.max_bins = max_bins
        self.lambda_l2 = lambda_l2
        self.min_child_weight = min_child_weight
        self.min_data_in_leaf = min_data_in_leaf
        self.min_split_gain = min_split_gain
        self.growth = growth
        self.subsample = subsample
        self.colsample = colsample
        self.seed = seed
        self.categorical_features = tuple(categorical_features)
        self.early_stopping_rounds = early_stopping_rounds
        self.device = device
        self.extra_params = dict(extra_params)
        self.booster_: Optional[Booster] = None

    # ---- sklearn protocol ---------------------------------------------------
    _PARAM_NAMES = (
        "num_trees", "num_leaves", "max_depth", "learning_rate", "max_bins",
        "lambda_l2", "min_child_weight", "min_data_in_leaf", "min_split_gain",
        "growth", "subsample", "colsample", "seed", "categorical_features",
        "early_stopping_rounds", "device",
    )

    def get_params(self, deep: bool = True) -> dict:
        out = {k: getattr(self, k) for k in self._PARAM_NAMES}
        out.update(self.extra_params)
        return out

    def set_params(self, **kw: Any) -> "_DryadModel":
        for k, v in kw.items():
            if k in self._PARAM_NAMES:
                setattr(self, k, v)
            else:
                self.extra_params[k] = v
        return self

    def _params(self, **overrides: Any) -> Params:
        d = {k: getattr(self, k) for k in self._PARAM_NAMES if k != "device"}
        d["objective"] = self._objective
        d.update(self.extra_params)
        d.update(overrides)
        return make_params(d)

    def _fit(self, X, y, *, sample_weight=None, group=None, eval_set=None,
             eval_group=None, **param_overrides):
        p = self._params(**param_overrides)
        ds = Dataset(np.asarray(X, np.float32), np.asarray(y, np.float32),
                     weight=sample_weight, group=group,
                     categorical_features=self.categorical_features,
                     max_bins=p.max_bins)
        valid = None
        if eval_set is not None:
            Xv, yv = eval_set[0] if isinstance(eval_set, list) else eval_set
            valid = ds.bind(np.asarray(Xv, np.float32),
                            np.asarray(yv, np.float32), group=eval_group)
        self.booster_ = train(p, ds, [valid] if valid is not None else None,
                              device=self.device)
        self.n_features_in_ = ds.num_features
        return self

    # ---- shared inference ---------------------------------------------------
    def _check_fitted(self) -> Booster:
        if self.booster_ is None:
            raise RuntimeError("call fit() first")
        return self.booster_

    @property
    def feature_importances_(self) -> np.ndarray:
        return self._check_fitted().feature_importance("gain")

    @property
    def best_iteration_(self) -> int:
        return self._check_fitted().best_iteration


class DryadRegressor(_DryadModel):
    """L2 regression estimator."""

    _objective = "regression"

    def fit(self, X, y, sample_weight=None, eval_set=None) -> "DryadRegressor":
        return self._fit(X, y, sample_weight=sample_weight, eval_set=eval_set)

    def predict(self, X) -> np.ndarray:
        return self._check_fitted().predict(np.asarray(X, np.float32),
                                            device=self.device)


class DryadClassifier(_DryadModel):
    """Binary or multiclass classifier (objective from the number of
    classes; labels remapped through ``classes_``)."""

    _objective = "binary"

    def fit(self, X, y, sample_weight=None, eval_set=None) -> "DryadClassifier":
        y = np.asarray(y)
        self.classes_ = np.unique(y)
        n_class = self.classes_.size
        if n_class < 2:
            raise ValueError("DryadClassifier needs at least 2 classes in y")
        y_enc = np.searchsorted(self.classes_, y).astype(np.float32)
        if n_class == 2:
            self._objective = "binary"
            over = {}
        else:
            self._objective = "multiclass"
            over = {"num_class": n_class}
        if eval_set is not None:
            Xv, yv = eval_set[0] if isinstance(eval_set, list) else eval_set
            yv = np.asarray(yv)
            unknown = np.setdiff1d(np.unique(yv), self.classes_)
            if unknown.size:
                raise ValueError(
                    f"eval_set labels {unknown.tolist()} never appear in the "
                    "training labels")
            yv = np.searchsorted(self.classes_, yv).astype(np.float32)
            eval_set = (Xv, yv)
        return self._fit(X, y_enc, sample_weight=sample_weight,
                         eval_set=eval_set, **over)

    def predict_proba(self, X) -> np.ndarray:
        prob = self._check_fitted().predict(np.asarray(X, np.float32),
                                            device=self.device)
        if prob.ndim == 1:                       # binary: P(class 1)
            return np.stack([1.0 - prob, prob], axis=1)
        return prob

    def predict(self, X) -> np.ndarray:
        return self.classes_[np.argmax(self.predict_proba(X), axis=1)]


class DryadRanker(_DryadModel):
    """LambdaMART ranker (NDCG); ``predict`` gives raw scores."""

    _objective = "lambdarank"

    def fit(self, X, y, group, sample_weight=None, eval_set=None,
            eval_group=None) -> "DryadRanker":
        return self._fit(X, y, sample_weight=sample_weight, group=group,
                         eval_set=eval_set, eval_group=eval_group)

    def predict(self, X) -> np.ndarray:
        return self._check_fitted().predict(np.asarray(X, np.float32),
                                            raw_score=True,
                                            device=self.device)
