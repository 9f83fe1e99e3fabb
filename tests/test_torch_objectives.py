"""The robust and count objectives of the port (L1, Huber, Fair, Quantile,
Poisson) and the renewal gate against the reference.

Inputs are made with numpy from a seed and go through the reference's
``grad_hess_jax`` (jax on the CPU) and the port's ``grad_hess`` (torch on
the CPU), with and without sample weights.

Tolerances:
* L1, Huber, Fair and Quantile g/h: bitwise (the same fp32 ops in the same
  order; residuals equal to the label are included, where ``sign`` and the
  quantile's comparison sit on their edge);
* Poisson g/h: within 2 fp32 ulps of the larger of the result and its
  exp term (``exp(s)`` for g, ``exp(s + max_delta_step)`` for h), times
  the weight: torch's ``exp`` and XLA's differ in the last bit on ~10% of
  entries, and g's subtraction of the label then rounds at the result's
  scale;
* init scores, ``renew_alpha`` and the configuration tables: equal.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dryad_tpu import config as jconfig
from dryad_tpu import objectives as JO

import dryad_tpu_torch as dt
from dryad_tpu_torch import config, objectives as O
from torch_layout import one_torch_thread  # noqa: F401 (autouse)

N = 4000


def _inputs(seed, poisson=False):
    rng = np.random.Generator(np.random.Philox(seed))
    s = rng.normal(size=N).astype(np.float32)
    if poisson:
        y = rng.poisson(np.exp(np.clip(s, -3, 3))).astype(np.float32)
    else:
        y = (s + rng.normal(size=N) * 1.5).astype(np.float32)
        y[::17] = s[::17]                     # residual exactly zero
    w = rng.uniform(0.1, 3.0, size=N).astype(np.float32)
    return s, y, w


def _both(port_obj, ref_obj, s, y, w):
    gt, ht = port_obj.grad_hess(torch.from_numpy(s), torch.from_numpy(y),
                                None if w is None else torch.from_numpy(w))
    gj, hj = ref_obj.grad_hess_jax(jnp.asarray(s), jnp.asarray(y),
                                   None if w is None else jnp.asarray(w))
    assert gt.dtype == torch.float32 and ht.dtype == torch.float32
    return gt.numpy(), ht.numpy(), np.asarray(gj), np.asarray(hj)


CASES = [
    ("l1", lambda: (O.L1(), JO.L1())),
    ("huber", lambda: (O.Huber(0.5), JO.Huber(0.5))),
    ("huber_default", lambda: (O.Huber(), JO.Huber())),
    ("fair", lambda: (O.Fair(1.5), JO.Fair(1.5))),
    ("fair_c_0.3", lambda: (O.Fair(0.3), JO.Fair(0.3))),
    ("quantile", lambda: (O.Quantile(0.75), JO.Quantile(0.75))),
    ("quantile_0.1", lambda: (O.Quantile(0.1), JO.Quantile(0.1))),
]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name,make", CASES, ids=[c[0] for c in CASES])
def test_robust_grad_hess_bitwise_equal_reference(name, make, weighted):
    port_obj, ref_obj = make()
    s, y, w = _inputs(3)
    gt, ht, gj, hj = _both(port_obj, ref_obj, s, y, w if weighted else None)
    np.testing.assert_array_equal(gt, gj)
    np.testing.assert_array_equal(ht, hj)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mds", [0.7, 0.0, 1.3])
def test_poisson_grad_hess_within_two_ulps(mds, weighted):
    s, y, w = _inputs(5, poisson=True)
    ww = w if weighted else None
    gt, ht, gj, hj = _both(O.Poisson(mds), JO.Poisson(mds), s, y, ww)
    scale = np.ones(N, np.float32) if ww is None else ww

    def ulps(exp_term, result):
        big = np.maximum(np.abs(exp_term), np.abs(result))
        return np.spacing(big.astype(np.float32)) * scale

    e_g = np.exp(s.astype(np.float64))
    e_h = np.exp(s.astype(np.float64) + np.float32(mds))
    assert (np.abs(gt - gj) <= 2 * ulps(e_g, gj / scale)).all()
    assert (np.abs(ht - hj) <= 2 * ulps(e_h, hj / scale)).all()


@pytest.mark.parametrize("weighted", [False, True])
def test_init_scores_equal_reference(weighted):
    s, y, w = _inputs(7)
    _, yp, _ = _inputs(7, poisson=True)
    ww = w if weighted else None
    pairs = [(O.L1(), JO.L1(), y), (O.Huber(0.5), JO.Huber(0.5), y),
             (O.Fair(), JO.Fair(), y), (O.Quantile(0.9), JO.Quantile(0.9), y),
             (O.Quantile(0.25), JO.Quantile(0.25), y),
             (O.Poisson(), JO.Poisson(), yp),
             (O.LambdaRank(), JO.LambdaRank(), yp)]
    for port_obj, ref_obj, lab in pairs:
        assert port_obj.init_score(lab, ww) == ref_obj.init_score(lab, ww)
    with pytest.raises(ValueError, match="non-negative"):
        O.Poisson().init_score(-np.abs(y) - 1)


def test_transforms_equal_reference():
    s = np.linspace(-4, 4, 101).astype(np.float32)
    for name in ("l1", "huber", "fair", "quantile", "poisson",
                 "lambdarank"):
        got = O.get_objective(dt.Params(objective=name)).transform_np(s)
        want = JO.get_objective(jconfig.Params(objective=name)).transform_np(s)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("objective", config.OBJECTIVES)
@pytest.mark.parametrize("weighted", [False, True])
def test_renew_alpha_gate_equals_reference(objective, weighted):
    extra = {"num_class": 3} if objective == "multiclass" else {}
    for alpha in (0.9, 0.73, 0.5):
        kw = dict(objective=objective, alpha=alpha, **extra)
        got = O.renew_alpha(dt.Params(**kw), weighted=weighted)
        want = JO.renew_alpha(jconfig.Params(**kw), weighted=weighted)
        assert got == want


def test_renew_alpha_gate_off_for_other_boosting_and_monotone():
    """The two gate cases the port's Params cannot express yet read as
    the reference's on an object that carries them."""
    for boosting, mono in (("dart", ()), ("rf", ()), ("gbdt", (1, 0)),
                           ("goss", ())):
        ns = types.SimpleNamespace(objective="l1", alpha=0.9,
                                   boosting=boosting,
                                   monotone_constraints=mono)
        ref = jconfig.Params(objective="l1", boosting=boosting,
                             monotone_constraints=mono,
                             **({"subsample": 0.5} if boosting == "rf"
                                else {}))
        assert O.renew_alpha(ns) == JO.renew_alpha(ref)


def test_configuration_tables_equal_reference():
    assert set(config.OBJECTIVES) == set(jconfig.OBJECTIVES)
    for alias, target in jconfig._OBJECTIVE_ALIASES.items():
        extra = {"num_class": 3} if target == "multiclass" else {}
        assert dt.Params.from_dict({"objective": alias,
                                    **extra}).objective == target
    d = dt.Params.from_dict({"objective": "quantile", "alpha": 0.3,
                             "fair_c": 2.0, "poisson_max_delta_step": 0.1,
                             "sigmoid": 2.0, "ndcg_at": 5,
                             "lambdarank_truncation": 20}).to_dict()
    ref = jconfig.Params.from_dict(d)
    for k in ("alpha", "fair_c", "poisson_max_delta_step", "sigmoid",
              "ndcg_at", "lambdarank_truncation", "objective"):
        assert getattr(ref, k) == d[k]
    for bad, msg in (({"objective": "quantile", "alpha": 1.0}, "alpha"),
                     ({"objective": "huber", "alpha": 0.0}, "delta"),
                     ({"objective": "fair", "fair_c": 0.0}, "fair_c"),
                     ({"objective": "poisson",
                       "poisson_max_delta_step": -1.0},
                      "poisson_max_delta_step")):
        with pytest.raises(ValueError, match=msg):
            dt.Params.from_dict(bad)
        with pytest.raises(ValueError, match=msg):
            jconfig.Params.from_dict(bad)
