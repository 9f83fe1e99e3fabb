"""Boosting loop for one output, the counterpart of the per-iteration arm
of ``dryad_tpu/engine/train.py::train_device``.

Each iteration: stop if early stopping has run out of patience -> draw the
row bag and the feature mask (Philox(seed, iteration), on the host) ->
grad/hess with sample weights -> grow -> ``score += value[row_leaf]`` ->
add the new tree to every valid set's scores -> evaluate on the device ->
early-stopping books -> callback -> checkpoint when due.

Evals stay on the device when nothing needs their value mid-run (no early
stopping, no callback): they are fetched in bulk before each due
checkpoint and at the end.  Otherwise each eval fetches one scalar per
valid set, in one transfer.

Resume and warm start (``init_booster``) prefill the tree tables and
rebuild the train and valid scores by replaying the trees in fp32 tree
order, the order in which the straight run added them, so a resumed run
reproduces the straight one bit for bit.  The reference's chunked
dispatch arm is not ported: it exists for a remote TPU's program-length
limit.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from dryad_tpu_torch.booster import CAT_WORDS, Booster
from dryad_tpu_torch.config import Params, effective_depth_params
from dryad_tpu_torch.dataset import Dataset
from dryad_tpu_torch.engine.grower import grow_any
from dryad_tpu_torch.engine.loop_state import (
    normalize_valids,
    sample_masks,
    update_best,
)
from dryad_tpu_torch.engine.predict import (
    PACKED_CHILD_BITS,
    PACKED_FEATURE_BITS,
    accumulate,
    add_tree,
    pack_words,
    stage_trees,
)
from dryad_tpu_torch.metrics.device import make_evaluator
from dryad_tpu_torch.objectives import get_objective

TREE_KEYS = ("feature", "threshold", "left", "right", "value", "gain",
             "default_left", "cover")


def binned_to_device(X_binned: np.ndarray, device) -> torch.Tensor:
    """u8 bins stay uint8; wider bins travel as int32 (torch's uint16
    support is thin)."""
    if X_binned.dtype == np.uint8:
        return torch.from_numpy(np.ascontiguousarray(X_binned)).to(device)
    return torch.from_numpy(X_binned.astype(np.int32)).to(device)


def _empty_out(T: int, M: int, device) -> dict[str, torch.Tensor]:
    i64 = torch.int64
    return {
        "feature": torch.full((T, M), -1, dtype=i64, device=device),
        "threshold": torch.zeros((T, M), dtype=i64, device=device),
        "left": torch.zeros((T, M), dtype=i64, device=device),
        "right": torch.zeros((T, M), dtype=i64, device=device),
        "value": torch.zeros((T, M), dtype=torch.float32, device=device),
        "gain": torch.zeros((T, M), dtype=torch.float32, device=device),
        "default_left": torch.ones((T, M), dtype=torch.bool, device=device),
        "cover": torch.zeros((T, M), dtype=torch.float32, device=device),
        "max_depth": torch.zeros(T, dtype=i64, device=device),
    }


def _materialize(p: Params, mapper, out, T: int, init, max_depth_prev: int,
                 best_iteration: int, best_value, stale: int) -> Booster:
    """Fetch the first T trees of the device tables into a Booster."""
    host = {k: v[:T].cpu().numpy() for k, v in out.items()}
    M = host["feature"].shape[1]
    arrays = {
        "feature": host["feature"].astype(np.int32),
        "threshold": host["threshold"].astype(np.int32),
        "left": host["left"].astype(np.int32),
        "right": host["right"].astype(np.int32),
        "value": host["value"],
        "is_cat": np.zeros((T, M), bool),
        "cat_bitset": np.zeros((T, M, CAT_WORDS), np.uint32),
        "gain": host["gain"],
        "default_left": host["default_left"],
        "cover": host["cover"],
    }
    max_depth_seen = max(int(host["max_depth"].max(initial=0)),
                         max_depth_prev)
    return Booster(p, mapper, arrays, init, max_depth_seen, best_iteration,
                   {"best_value": best_value, "stale": int(stale)})


def train_device(params: Params, data: Dataset, valid=None, *,
                 num_trees: Optional[int] = None,
                 init_booster: Optional[Booster] = None,
                 callback: Optional[Callable[[int, dict], None]] = None,
                 checkpointer=None, device: torch.device) -> Booster:
    p = params.validate()
    if data.y is None:
        raise ValueError("training needs labels")
    N, F = data.num_rows, data.num_features
    B = data.mapper.total_bins
    # the max_depth=-1 policy of leaf-wise growth, as the reference applies
    # it; the booster keeps the effective params
    p = effective_depth_params(p, F, B, N)
    obj = get_objective(p)
    T = num_trees if num_trees is not None else p.num_trees
    M = p.max_nodes
    Xb = binned_to_device(data.X_binned, device)
    y = torch.from_numpy(data.y).to(device)
    weight = (None if data.weight is None
              else torch.from_numpy(data.weight).to(device))
    init = np.asarray(obj.init_score(data.y, data.weight),
                      np.float32).reshape(-1)
    if init_booster is not None:
        # the carried base score is part of the model: a continuation on
        # fresh rows must not re-derive it from their labels
        init = np.asarray(init_booster.init_score, np.float32).reshape(-1)
    init_t = torch.from_numpy(init).to(device)
    score = init_t.expand(N).clone()
    learn_missing = data.has_missing
    # a static bound at or above every tree's depth; traversal is exact for
    # any such bound
    depth_bound = (p.max_depth if p.max_depth > 0
                   else max(p.effective_num_leaves - 1, 1))

    # ---- resume / warm start -------------------------------------------
    out = _empty_out(T, M, device)
    start_iter = 0
    max_depth_prev = 0
    replay = None
    if init_booster is not None:
        prev = init_booster
        if prev.params.max_nodes != M or prev.num_outputs != 1:
            raise ValueError("init_booster is incompatible: num_leaves/"
                             "max_depth/num_class must match")
        if prev.num_total_trees > T:
            raise ValueError("new num_trees must cover the init_booster's "
                             "iterations")
        words, value, _, n_prev = stage_trees(prev, prev.num_iterations)
        replay = (torch.from_numpy(words).to(device),
                  torch.from_numpy(value).to(device),
                  max(prev.max_depth_seen, 1))
        score = accumulate(*replay[:2], Xb, init_t, replay[2])[:, 0]
        ta = prev.tree_arrays()
        for key in TREE_KEYS:
            out[key][:n_prev] = torch.from_numpy(ta[key]).to(
                device=device, dtype=out[key].dtype)
        start_iter = n_prev
        max_depth_prev = prev.max_depth_seen

    # ---- valid sets: scored on the device, the first drives early
    # stopping ---------------------------------------------------------------
    valids = normalize_valids(valid)
    evaluators = [make_evaluator(p.objective, p.metric, vds, device)
                  for _, vds in valids]
    if valids and (F > (1 << PACKED_FEATURE_BITS)
                   or M > (1 << PACKED_CHILD_BITS)):
        raise NotImplementedError(
            "valid sets are scored through packed node words; more than "
            f"{1 << PACKED_FEATURE_BITS} features or {1 << PACKED_CHILD_BITS}"
            " nodes need the legacy traversal layout, a later slice")
    sync_eval = bool(p.early_stopping_rounds) or callback is not None
    deferred: list[tuple[int, list[torch.Tensor]]] = []
    eval_history: Optional[dict[str, list]] = None
    if init_booster is not None and init_booster.train_state.get(
            "eval_history"):
        # resume keeps the prior segment's deferred history
        eval_history = {k: list(v) for k, v in
                        init_booster.train_state["eval_history"].items()}
    vXbs = [binned_to_device(v.X_binned, device) for _, v in valids]
    if replay is None:
        vscores = [init_t.expand(v.num_rows).clone() for _, v in valids]
    else:
        vscores = [accumulate(*replay[:2], vXb, init_t, replay[2])[:, 0]
                   for vXb in vXbs]
    best_iteration, best_value, stale = -1, None, 0
    if init_booster is not None:
        best_iteration = init_booster.best_iteration
        best_value = init_booster.train_state.get("best_value")
        stale = init_booster.train_state.get("stale", 0)

    def fold_eval_row(it_d: int, vals) -> None:
        nonlocal best_iteration, best_value, stale, eval_history
        if eval_history is None:
            eval_history = {}
        for vi, ((vname, _), (mname, _, _)) in enumerate(
                zip(valids, evaluators)):
            eval_history.setdefault(f"{vname}_{mname}", []).append(
                [int(it_d), float(vals[vi])])
        best_iteration, best_value, stale = update_best(
            p, best_iteration, best_value, stale, int(it_d), float(vals[0]),
            evaluators[0][1])

    def flush_deferred() -> None:
        """One fetch of every pending eval, then the books in order."""
        if not deferred:
            return
        fetched = torch.stack([torch.stack(v) for _, v in deferred]).cpu()
        for (it_d, _), vals in zip(deferred, fetched.tolist()):
            fold_eval_row(it_d, vals)
        deferred.clear()

    ones_rows = torch.ones(N, dtype=torch.bool, device=device)
    ones_feat = torch.ones(F, dtype=torch.bool, device=device)
    cuda = device.type == "cuda"
    tree_seconds = []
    for it in range(start_iter, T):
        # a checkpoint taken at the early-stop boundary restores stale >=
        # rounds; growing past it would diverge from the stopped run
        if (valids and p.early_stopping_rounds
                and stale >= p.early_stopping_rounds):
            T = it
            break
        t0 = time.perf_counter()
        row_mask, feat_mask = sample_masks(p, it, N, F)
        bag = (ones_rows if row_mask is None
               else torch.from_numpy(row_mask).to(device))
        fmask = (ones_feat if feat_mask is None
                 else torch.from_numpy(feat_mask).to(device))
        g, h = obj.grad_hess(score, y, weight)
        tree = grow_any(p, B, Xb, g, h, bag, fmask,
                        learn_missing=learn_missing)
        score = score + tree["value"][tree["row_leaf"]]
        for key in TREE_KEYS:
            out[key][it] = tree[key]
        out["max_depth"][it] = tree["max_depth"]
        if valids:
            words = pack_words(tree["feature"], tree["threshold"],
                               tree["left"], tree["right"],
                               tree["default_left"])
            vscores = [add_tree(words, tree["value"], vXb, vs, depth_bound)
                       for vXb, vs in zip(vXbs, vscores)]

        info: dict = {"iteration": it}
        stop = False
        # evaluate every eval_period-th iteration and always the last, so
        # the tail is never unscored
        if valids and ((it + 1) % p.eval_period == 0 or it + 1 == T):
            vals_dev = [fn(vs) for vs, (_, _, fn) in zip(vscores,
                                                         evaluators)]
            if not sync_eval:
                deferred.append((it, vals_dev))
            else:
                vals = torch.stack(vals_dev).cpu().tolist()  # one fetch
                for vi, ((vname, _), (mname, higher, _)) in enumerate(
                        zip(valids, evaluators)):
                    info[f"{vname}_{mname}"] = vals[vi]
                    if vi > 0:
                        continue    # early stopping watches the first set
                    best_iteration, best_value, stale = update_best(
                        p, best_iteration, best_value, stale, it, vals[vi],
                        higher)
                    if (p.early_stopping_rounds
                            and stale >= p.early_stopping_rounds):
                        stop = True
        if callback is not None:
            callback(it, info)
        if checkpointer is not None and checkpointer.due(it + 1):
            flush_deferred()
            ckpt = _materialize(p, data.mapper, out, it + 1, init,
                                max_depth_prev, best_iteration, best_value,
                                stale)
            if eval_history is not None:
                ckpt.train_state["eval_history"] = eval_history
            checkpointer.save(ckpt, it + 1)
        if cuda:
            # per-iteration wall time; a synchronisation, not a fetch
            torch.cuda.synchronize(device)
        tree_seconds.append(time.perf_counter() - t0)
        if stop:
            T = it + 1
            break

    flush_deferred()
    booster = _materialize(p, data.mapper, out, T, init, max_depth_prev,
                           best_iteration, best_value, stale)
    if eval_history is not None:
        booster.train_state["eval_history"] = eval_history
    booster.tree_seconds = tree_seconds
    return booster
