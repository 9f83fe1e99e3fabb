"""Boosting loop, the counterpart of the per-iteration arm of
``dryad_tpu/engine/train.py::train_device``.  Scores are (N, K) for K
outputs (K classes of a multiclass model, else 1); an iteration grows K
trees, stored in tree slots ``it * K + k``.

Each iteration: stop if early stopping has run out of patience -> draw the
row bag and the feature mask (Philox(seed, iteration), on the host), which
the K trees share -> under DART, draw the drop set and drop those
iterations' trees (``predict.dart_drop``) -> one grad/hess pass, with
sample weights, of the pre-iteration score (for lambdarank the padded
per-query lambda pass, ``engine/lambdarank.py``, on a plan built once per
run; under rf the pass of the constant init score, made once per run) ->
under GOSS, the selection (``engine/goss.py``) replaces the bag and
amplifies the picked rows' g and h -> for each class k: grow on column k
of g and h (its own fixed-point shift) -> for the L1 family, renew the
leaf values to quantiles of the in-bag residuals against the pre-update
score (``renew_values``) -> under a DART drop, scale the tree by 1/(k+1)
-> ``score[:, k] += value[row_leaf]`` -> add the new tree to column k of
every valid set's scores -> after a DART drop, rebuild the train and
valid scores instead, by the replay-sum a resumed run computes -> then
evaluate on the device (under rf, the averaged scores) -> early-stopping
books -> callback -> checkpoint when due.
Iteration counts (``best_iteration``, ``eval_period``, checkpoints,
``num_iteration``) count iterations; the tree tables count trees.

The binned matrix, labels and weights come from ``Dataset.device_arrays``
(one upload per set and device; a ``StreamedDataset`` assembles the
matrix chunk by chunk from disk), so streamed and resident training run
one program on one tensor and agree bit for bit.  A streamed valid set
raises: ``materialize()`` it.

Evals stay on the device when nothing needs their value mid-run (no early
stopping, no callback, no evaluator that scores on the host): they are
fetched in bulk before each due checkpoint and at the end.  Otherwise
each eval fetches one scalar per valid set, in one transfer.

Resume and warm start (``init_booster``) prefill the tree tables and
rebuild the train and valid scores by replaying the trees in fp32 tree
order, the order in which the straight run added them, so a resumed run
reproduces the straight one bit for bit.  The reference's chunked
dispatch arm is not ported: it exists for a remote TPU's program-length
limit.  The loop is the reference's per-iteration arm, with its hook
sites for supervision (``resilience/``): ``chunk_hook("dispatch", it)``
at the head of each iteration and ``chunk_hook("fetch", it)`` inside the
watchdog bracket of each fetch (a synchronous eval at ``it``, a
checkpoint and the deferred evals it flushes at ``it + 1``, the final
fetch at the run's iteration count).  ``chunk_policy`` is taken as the
reference's trainer takes it, and never consulted: there are no chunks
to cap.  Without a hook nothing is called.

Under a process group (``group``, ``engine/distributed.RowGroup``) each
rank trains on its own rows and every rank ends with the same booster,
bit for bit the single process's on all the rows: the depth policy and
the grower see the global row count, the init score comes from every
rank's labels and weights gathered in rank order, the missing-value
planes are scanned where any rank has a missing value, the bags are
drawn over the global rows, each histogram pass is reduced across ranks
(``grow_any``), and valid sets are whole on every rank, so evals, early
stopping and the best iteration agree.  GOSS takes its threshold and top
count from the group (``engine/goss.py``), lambdarank pads every rank's
queries (each whole on one rank) to the group's widest S, the L1-family
renewal sorts every rank's gathered in-bag residuals (``renew_values``),
and every rank must bin through one mapper (checked by digest, for CSR
and bundled sets too).  Rank 0 alone writes checkpoints, and every rank
waits for the file.  A streamed set raises (``check_group_supported``).
The run's collective plan (``comm_stats``) is exported as the
``dryad_comm_*`` gauges and kept as ``booster.comm_stats``.

Every device-to-host fetch of the loop (``eval``, ``checkpoint``,
``final``) runs under the fetch watchdog (``obs/watchdog.py``) and a span
(``train.fetch.eval|checkpoint|final``), and the run's first tree is its
compile boundary (``engine/introspect.py``, family ``train.step``).
While the registry records, each iteration records the spans
``train.iteration`` (its wall, the one ``tree_seconds`` keeps) and
``train.grow`` (the host's wall of queueing its K trees) and sets the
gauge ``dryad_train_iteration``; no span adds a synchronisation.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Optional

import numpy as np
import torch

from dryad_tpu_torch.booster import CAT_WORDS, Booster
from dryad_tpu_torch.config import (
    Params,
    check_rf_continuation,
    effective_depth_params,
)
from dryad_tpu_torch.dataset import Dataset
from dryad_tpu_torch.engine import introspect
from dryad_tpu_torch.engine.distributed import (
    all_gather_host,
    all_gather_rows,
    all_reduce_max_int,
    check_same_mapper,
    ordered_key,
)
from dryad_tpu_torch.engine.goss import goss_columns
from dryad_tpu_torch.engine.grower import grow_any
from dryad_tpu_torch.engine.lambdarank import (
    PaddingPlan,
    grad_hess_ranking,
    padded_width,
)
from dryad_tpu_torch.engine.loop_state import (
    dart_drop_set,
    normalize_valids,
    sample_masks,
    update_best,
)
from dryad_tpu_torch.engine.predict import (
    accumulate,
    add_tree,
    dart_drop,
    rf_average_dev,
    stage_trees,
    table_to,
    table_words,
)
from dryad_tpu_torch.metrics.device import make_evaluator
from dryad_tpu_torch.objectives import get_objective, renew_alpha
from dryad_tpu_torch.obs.registry import default_registry
from dryad_tpu_torch.obs.spans import record as record_span
from dryad_tpu_torch.obs.spans import span
from dryad_tpu_torch.obs.watchdog import watch_fetch

TREE_KEYS = ("feature", "threshold", "left", "right", "value", "gain",
             "default_left", "cover", "is_cat", "cat_bitset")


def feature_kinds(mapper, learn_missing: bool, device):
    """(is_cat_feat, bundled_mask) as the growers take them: the (F,)
    categorical flags when the mapper has a categorical feature (the
    reference's static ``has_cat``), else None; the EFB bundle columns
    when there are any and the missing-right plane is scanned, else None,
    so numeric runs keep their program."""
    is_cat = mapper.is_categorical
    bundled = getattr(mapper, "bundled_mask", None)
    return ((torch.from_numpy(is_cat).to(device) if is_cat.any() else None),
            (torch.from_numpy(bundled).to(device)
             if learn_missing and bundled is not None and bundled.any()
             else None))


def class_grads(obj, score: torch.Tensor, y: torch.Tensor,
                weight: Optional[torch.Tensor]) -> list:
    """One grad/hess pass of the (N, K) score, as K (g, h) pairs of
    contiguous (N,) columns, one per class tree.  A column of the
    row-major (N, K) result is strided, and the growers hand raw pointers
    to the kernels, so each gets its own copy."""
    if score.shape[1] == 1:
        return [obj.grad_hess(score[:, 0], y, weight)]
    g, h = obj.grad_hess(score, y, weight)
    return [(g[:, k].contiguous(), h[:, k].contiguous())
            for k in range(score.shape[1])]


def renewal_key(lv: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """The renewal's int64 sort key of leaf ids ``lv`` and residuals ``r``:
    ``lv << 32 | ordered bits of r`` (-0.0 keyed as +0.0)."""
    return (lv << 32) | ordered_key(torch.where(r == 0, 0.0, r))


def renewal_sort(key: torch.Tensor, r: torch.Tensor, M: int):
    """The renewal's one stable sort: (residuals in key order, the (M+1,)
    segment bounds of leaves 0..M).  ``engine/probes.py`` times it."""
    key_s, order = torch.sort(key, stable=True)
    bounds = torch.searchsorted(
        key_s >> 32, torch.arange(M + 1, dtype=torch.int64,
                                  device=key.device))
    return r[order], bounds


def renew_values(value: torch.Tensor, feature: torch.Tensor,
                 leaves: torch.Tensor, y: torch.Tensor,
                 score_k: torch.Tensor, bag: torch.Tensor, alpha: float,
                 lr: float, M: int, group=None) -> torch.Tensor:
    """Post-growth leaf renewal (``objectives.renew_alpha``): each leaf's
    Newton value becomes the type-1 alpha-quantile of its in-bag residuals
    ``y - score_k`` (the pre-update score), times the learning rate: the
    order statistic at ``clip(ceil(f32(alpha) f32(cnt)) - 1, 0, cnt - 1)``,
    a pure selection, on leaves with ``cnt > 0``.

    The reference's stable two-key sort (leaf id, then residual; out-of-bag
    rows take the sentinel id M and sink to the tail) is one stable sort
    of int64 keys ``leaf << 32 | ordered bits of the residual``, the bits
    mapped so that their unsigned order is the float order.  As in
    ``lax.sort``, -0.0 and +0.0 compare equal (the key takes +0.0 for
    both) and keep their row order, so the selection is the reference's
    bit for bit, the sign of a zero included.

    Under ``group`` each rank's in-bag keys and residuals (12 B a row) are
    all-gathered in rank order, which is the global row order, and the
    same stable sort runs on every rank: the single process's selection,
    bit for bit (out-of-bag rows only ever sank to the tail)."""
    r = y - score_k
    key = renewal_key(torch.where(bag, leaves.to(torch.int64), M), r)
    if group is not None:
        # (n_in, 3) int32 words: the key's two halves, the residual's bits
        words = torch.cat([key[bag].view(torch.int32).view(-1, 2),
                           r[bag].view(torch.int32)[:, None]], 1)
        words = all_gather_rows(words, group, "renew")
        if words.shape[0] == 0:
            return value
        key = words[:, :2].contiguous().view(torch.int64)[:, 0]
        r = words[:, 2].contiguous().view(torch.float32)
    n = r.shape[0]
    r_s, bounds = renewal_sort(key, r, M)
    cnt = bounds[1:] - bounds[:-1]
    kf = torch.ceil(float(np.float32(alpha)) * cnt.to(torch.float32))
    kidx = torch.clamp(kf.to(torch.int64) - 1, min=torch.zeros_like(cnt),
                       max=torch.clamp(cnt - 1, min=0))
    sel = torch.clamp(bounds[:-1] + kidx, 0, n - 1)
    stat = r_s[sel] * float(np.float32(lr))
    return torch.where((feature < 0) & (cnt > 0), stat, value)


def check_group_supported(p: Params, data: Dataset) -> None:
    """Refuse a streamed set under a process group, as the reference
    refuses one under a mesh: each rank would assemble its rows from its
    own file."""
    if data.is_streamed:
        raise ValueError(
            "streamed datasets cannot train over a process group: "
            "materialize() the rank's rows or train one process")


def comm_stats(p: Params, F: int, B: int, K: int, n_ranks: int, *,
               num_rows: int, gate_rows: Optional[int] = None,
               bin_itemsize: int = 1, has_cat: bool = False) -> dict:
    """The histogram collectives of one boosting iteration on each rank,
    by arm: the counterpart of the reference's ``_comm_stats``, with its
    keys and its per-arm plan, a pure function of the params (effective,
    as ``train_device`` resolves them), the shape and the rank count.
    The passes it counts are ``grower.grow_plan``'s, the plan the growers
    themselves run.  ``num_rows`` is the group's row count, ``gate_rows``
    its largest rank's (the natural-order gate reads it).

    * fused: one int64 SUM all-reduce per pass, the root of each class
      and every level (or every split of the sequential grower);
    * feature: the root stays fused; each level pass is one
      reduce-scatter, and each level's scan one all-gather of the packed
      split records.

    Bytes follow ``RowGroup.stats``: what a collective delivers to a rank
    (an all-reduce its whole buffer, a reduce-scatter its owned block,
    an all-gather every rank's part), so ``stats["hist"]`` and
    ``stats["splits"]`` of a run of ``i`` iterations add up to ``i`` times
    these.  The port's own sizes: 8-byte fixed-point cells, 32-byte split
    records.  By design the port differs from the reference in three
    places: each class's root is its own pass (K root calls: the port has
    no shared multiclass root), a categorical level's raw left sets ride
    the records' all-gather (one call a level, not two, and 4 bytes a
    bin), and the sequential grower without histogram subtraction makes
    two passes a split.  GOSS, the renewal, lambdarank's plan, the shift
    and the set-up are not counted here (their own ``stats`` purposes)."""
    from dryad_tpu_torch.engine.grower import grow_plan
    from dryad_tpu_torch.engine.split import LOCAL_SPLIT_WORDS

    fb = 3 * F * B * 8
    plan = grow_plan(p, F, B, num_rows=num_rows, gate_rows=gate_rows,
                     bin_itemsize=bin_itemsize, n_ranks=n_ranks)
    widths, scan_widths = plan.pass_widths, plan.scan_widths
    level_calls = len(widths)
    mode = plan.hist_reduce
    root_calls = K
    if mode == "feature":
        n = max(int(n_ranks), 1)
        fs = -(-F // n)
        fb_slice = 3 * fs * B * 8
        rec_b = LOCAL_SPLIT_WORDS * 4 + (4 * B if has_cat else 0)
        psum_calls = root_calls
        psum_bytes = fb * K
        rs_calls = level_calls * K
        rs_bytes = K * sum(w * fb_slice for w in widths)
        ag_calls = len(scan_widths) * K
        ag_bytes = K * sum(n * 2 * w * rec_b for w in scan_widths)
    else:
        psum_calls = root_calls + level_calls * K
        psum_bytes = (fb + sum(w * fb for w in widths)) * K
        rs_calls = rs_bytes = ag_calls = ag_bytes = 0
    return {
        "n_shards": int(n_ranks),
        "hist_reduce": mode,
        "psum_calls_per_iter": psum_calls,
        "psum_bytes_per_iter": psum_bytes,
        "reduce_scatter_calls_per_iter": rs_calls,
        "reduce_scatter_bytes_per_iter": rs_bytes,
        "all_gather_calls_per_iter": ag_calls,
        "all_gather_bytes_per_iter": ag_bytes,
        "collective_calls_per_iter": psum_calls + rs_calls + ag_calls,
        "collective_bytes_per_iter": psum_bytes + rs_bytes + ag_bytes,
    }


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
        "is_cat": torch.zeros((T, M), dtype=torch.bool, device=device),
        # uint32 words held in int64
        "cat_bitset": torch.zeros((T, M, CAT_WORDS), dtype=i64,
                                  device=device),
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
        "is_cat": host["is_cat"],
        "cat_bitset": host["cat_bitset"].astype(np.uint32),
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
                 checkpointer=None, device: torch.device,
                 group=None,
                 chunk_hook: Optional[Callable[[str, int], None]] = None,
                 chunk_policy=None) -> Booster:
    p = params.validate()
    if data.y is None:
        raise ValueError("training needs labels")
    N, F = data.num_rows, data.num_features
    B = data.mapper.total_bins
    if group is not None:
        check_group_supported(p, data)
        check_same_mapper(data.mapper, group)
    valids = normalize_valids(valid)
    for vname, vds in valids:
        if getattr(vds, "is_streamed", False):
            raise ValueError(
                f"valid set {vname!r} is streamed: the device eval scores "
                "the resident matrix, so materialize() it (valid sets are "
                "small beside the training set)")
    n_all = N if group is None else group.global_rows
    # the max_depth=-1 policy of leaf-wise growth, as the reference applies
    # it; the booster keeps the effective params
    p = effective_depth_params(p, F, B, n_all)
    obj = get_objective(p)
    K = p.num_outputs
    n_iters = num_trees if num_trees is not None else p.num_trees
    T = n_iters * K                   # tree slots
    M = p.max_nodes
    prev = init_booster
    if prev is not None:
        if prev.params.max_nodes != M or prev.num_outputs != K:
            raise ValueError("init_booster is incompatible: num_leaves/"
                             "max_depth/num_class must match")
        if prev.num_total_trees > T:
            raise ValueError("new num_trees must cover the init_booster's "
                             "iterations")
        check_rf_continuation(prev.params, p)
    # uploaded once per Dataset and device; a StreamedDataset assembles it
    # chunk by chunk from disk
    Xb, y, weight = data.device_arrays(device)
    y_all, w_all = data.y, data.weight
    if group is not None:
        # every rank's labels and weights in rank order: the single
        # process's arrays, so the same init score bit for bit
        y_all = np.concatenate(all_gather_host(data.y, group))
        if data.weight is not None:
            w_all = np.concatenate(all_gather_host(data.weight, group))
    init = np.asarray(obj.init_score(y_all, w_all), np.float32).reshape(-1)
    del y_all, w_all
    if init_booster is not None:
        # the carried base score is part of the model: a continuation on
        # fresh rows must not re-derive it from their labels
        init = np.asarray(init_booster.init_score, np.float32).reshape(-1)
    init_t = torch.from_numpy(init).to(device)
    score = init_t.reshape(1, K).expand(N, K).clone()
    if p.objective == "lambdarank":
        if data.query_offsets is None:
            raise ValueError("lambdarank requires query groups "
                             "(Dataset(..., group=...))")
        # the loop-invariant scatter plan of the lambda pass; a group pads
        # every rank's queries to the widest rank's S
        S = (None if group is None else all_reduce_max_int(
            padded_width(data.query_offsets), group, "rank_plan"))
        plan = PaddingPlan(data.query_offsets, device, S)

        def grads(score):
            return [grad_hess_ranking(obj, score[:, 0], y, weight, plan)]
    else:
        def grads(score):
            return class_grads(obj, score, y, weight)
    # rf: every tree fits the g/h of the constant init score, one pass
    rf_gh = grads(score) if p.boosting == "rf" else None
    # L1-family leaf renewal; the whole gate lives in renew_alpha
    renew_a = renew_alpha(p, weighted=data.weight is not None)
    learn_missing = data.has_missing
    if group is not None:
        # any rank's missing values switch on the missing-right plane on
        # every rank, or the ranks would scan different grids
        learn_missing = bool(np.concatenate(all_gather_host(
            np.array([learn_missing]), group)).any())
    is_cat_feat, bundled_mask = feature_kinds(data.mapper, learn_missing,
                                              device)
    comm = None
    if group is not None:
        # the collective plan a rank runs each iteration, as gauges
        from dryad_tpu_torch.engine.leafperm import bin_itemsize
        from dryad_tpu_torch.obs.comm import export_comm_stats

        comm = comm_stats(p, F, B, K, group.world, num_rows=n_all,
                          gate_rows=group.max_rank_rows,
                          bin_itemsize=bin_itemsize(Xb),
                          has_cat=is_cat_feat is not None)
        export_comm_stats(comm, growth=p.growth)
    # a static bound at or above every tree's depth; traversal is exact for
    # any such bound
    depth_bound = (p.max_depth if p.max_depth > 0
                   else max(p.effective_num_leaves - 1, 1))

    # ---- resume / warm start -------------------------------------------
    out = _empty_out(T, M, device)
    start_iter = 0
    max_depth_prev = 0
    replay = None
    if prev is not None:
        table, value, bitset, _, n_prev = stage_trees(prev,
                                                       prev.num_iterations)
        replay = (table_to(table, device),
                  torch.from_numpy(value).to(device),
                  max(prev.max_depth_seen, 1),
                  None if bitset is None
                  else torch.from_numpy(bitset).to(device))
        score = accumulate(*replay[:2], Xb, init_t, *replay[2:])
        ta = prev.tree_arrays()
        for key in TREE_KEYS:
            # the uint32 bitsets travel as int64
            arr = (ta[key].astype(np.int64) if ta[key].dtype == np.uint32
                   else ta[key])
            out[key][:n_prev * K] = torch.from_numpy(arr).to(
                device=device, dtype=out[key].dtype)
        start_iter = n_prev
        max_depth_prev = prev.max_depth_seen

    # ---- valid sets: scored on the device, the first drives early
    # stopping ---------------------------------------------------------------
    evaluators = [make_evaluator(p.objective, p.metric, vds, device, K,
                                 p.ndcg_at) for _, vds in valids]
    # a host-scored eval fetches the scores anyway: nothing to defer
    sync_eval = (bool(p.early_stopping_rounds) or callback is not None
                 or any(fn.host_only for _, _, fn in evaluators))
    deferred: list[tuple[int, list[torch.Tensor]]] = []
    eval_history: Optional[dict[str, list]] = None
    if init_booster is not None and init_booster.train_state.get(
            "eval_history"):
        # resume keeps the prior segment's deferred history
        eval_history = {k: list(v) for k, v in
                        init_booster.train_state["eval_history"].items()}
    vXbs = [v.device_arrays(device)[0] for _, v in valids]
    if replay is None:
        vscores = [init_t.reshape(1, K).expand(v.num_rows, K).clone()
                   for _, v in valids]
    else:
        vscores = [accumulate(*replay[:2], vXb, init_t, *replay[2:])
                   for vXb in vXbs]
    best_iteration, best_value, stale = -1, None, 0
    if init_booster is not None and p.boosting != "dart":
        # a DART continuation does not inherit a best iteration: its drops
        # rescale trees inside that prefix
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
        """One fetch of every pending eval, then the books in order (under
        the bracket of the checkpoint or final fetch that flushes them)."""
        if not deferred:
            return
        with watch_fetch("eval", deferred[-1][0]), span("train.fetch.eval"):
            fetched = torch.stack([torch.stack(v)
                                   for _, v in deferred]).cpu()
        for (it_d, _), vals in zip(deferred, fetched.tolist()):
            fold_eval_row(it_d, vals)
        deferred.clear()

    # the tree program's identity, as the reference keys it: the params
    # less the run's length and its eval settings, shapes, device, arms
    step_key = (json.dumps(p.replace(num_trees=1, early_stopping_rounds=0,
                                     metric="").to_dict(), sort_keys=True),
                N, F, B, K, device.type, is_cat_feat is not None,
                group is not None)
    ones_rows = torch.ones(N, dtype=torch.bool, device=device)
    ones_feat = torch.ones(F, dtype=torch.bool, device=device)
    cuda = device.type == "cuda"
    tree_seconds = []
    obs = default_registry()
    obs_iter = None         # the iteration gauge, bound at first use
    for it in range(start_iter, n_iters):
        # a checkpoint taken at the early-stop boundary restores stale >=
        # rounds; growing past it would diverge from the stopped run
        if (valids and p.early_stopping_rounds
                and stale >= p.early_stopping_rounds):
            n_iters = it
            break
        if chunk_hook is not None:
            chunk_hook("dispatch", it)
        t0 = time.perf_counter()
        row_mask, feat_mask = sample_masks(
            p, it, n_all, F, None if group is None
            else (group.row_offset, group.row_offset + N))
        bag = (ones_rows if row_mask is None
               else torch.from_numpy(row_mask).to(device))
        fmask = (ones_feat if feat_mask is None
                 else torch.from_numpy(feat_mask).to(device))
        drop = (dart_drop_set(p, it, it) if p.boosting == "dart"
                else np.empty(0, np.int64))
        value_scale = None
        if drop.size:
            # the host's roundings of 1/(k+1) and k/(k+1), as the CPU
            # trainer takes them
            kd = drop.size
            value_scale = np.float32(1.0 / (kd + 1))
            tids = (drop[:, None] * K + np.arange(K)).reshape(-1)
            score_eff, out["value"] = dart_drop(
                out, score, tids, Xb, np.float32(kd / (kd + 1.0)),
                depth_bound, None if is_cat_feat is None
                else out["cat_bitset"])
            gh = grads(score_eff)
            del score_eff
        else:
            gh = rf_gh if rf_gh is not None else grads(score)
        if p.boosting == "goss":
            gh, bag = goss_columns(p, it, gh, bag, group)
        t_grow = time.perf_counter() if obs.enabled else None
        for k, (g, h) in enumerate(gh):
            t = it * K + k
            # the compile boundary of the run's tree program: the first
            # tree is observed (``engine/introspect.py``), later ones pay
            # one memo lookup
            tree = introspect.capture(
                "train.step", (step_key, value_scale is not None),
                grow_any, p, B, Xb, g, h, bag, fmask,
                learn_missing=learn_missing, is_cat_feat=is_cat_feat,
                bundled_mask=bundled_mask, group=group,
                labels={"growth": p.growth, "device": device.type})
            if renew_a is not None:
                # before the score update, the tree table and the valid
                # scores, so all three carry the renewed values
                tree["value"] = renew_values(
                    tree["value"], tree["feature"], tree["row_leaf"], y,
                    score[:, k], bag, renew_a, p.effective_learning_rate, M,
                    group)
            if value_scale is not None:
                tree["value"] = tree["value"] * torch.tensor(
                    value_scale, device=device)
            for key in TREE_KEYS:
                out[key][t] = tree[key]
            out["max_depth"][t] = tree["max_depth"]
            if value_scale is not None:
                continue            # the scores are rebuilt below
            score[:, k] = score[:, k] + tree["value"][tree["row_leaf"]]
            if valids:
                table = table_words(out, t, Xb.shape[1])
                bitset = None if is_cat_feat is None else tree["cat_bitset"]
                for vXb, vs in zip(vXbs, vscores):
                    vs[:, k] = add_tree(table, tree["value"], vXb, vs[:, k],
                                        depth_bound, bitset)
        if t_grow is not None:
            # the host's wall of queueing the K trees (on the card, not
            # their device time: the loop does not synchronize here)
            record_span("train.grow", time.perf_counter() - t_grow)
        if value_scale is not None:
            # the replay-sum over the rescaled table, the function a
            # resumed run rebuilds its scores with (incremental deltas
            # would round differently)
            n_live = (it + 1) * K
            table = table_words(out, slice(0, n_live), Xb.shape[1])
            bitset = (None if is_cat_feat is None
                      else out["cat_bitset"][:n_live])
            score = accumulate(table, out["value"][:n_live], Xb, init_t,
                               depth_bound, bitset)
            vscores = [accumulate(table, out["value"][:n_live], vXb, init_t,
                                  depth_bound, bitset) for vXb in vXbs]

        info: dict = {"iteration": it}
        stop = False
        # evaluate every eval_period-th iteration and always the last, so
        # the tail is never unscored
        if valids and ((it + 1) % p.eval_period == 0 or it + 1 == n_iters):
            # rf scores the averaged model, as predict serves it
            vs_eval = ([rf_average_dev(vs, init_t, it + 1) for vs in vscores]
                       if p.boosting == "rf" else vscores)
            vals_dev = [fn(vs) for vs, (_, _, fn) in zip(vs_eval,
                                                         evaluators)]
            if not sync_eval:
                deferred.append((it, vals_dev))
            else:
                with watch_fetch("eval", it):
                    if chunk_hook is not None:
                        chunk_hook("fetch", it)
                    with span("train.fetch.eval"):
                        # one fetch
                        vals = torch.stack(vals_dev).cpu().tolist()
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
            with watch_fetch("checkpoint", it + 1):
                if chunk_hook is not None:
                    chunk_hook("fetch", it + 1)
                flush_deferred()
                with span("train.fetch.checkpoint"):
                    ckpt = _materialize(p, data.mapper, out, (it + 1) * K,
                                        init, max_depth_prev, best_iteration,
                                        best_value, stale)
            if eval_history is not None:
                ckpt.train_state["eval_history"] = eval_history
            if group is None or group.rank == 0:
                checkpointer.save(ckpt, it + 1)
            if group is not None:
                group.barrier()     # the file exists before any rank goes on
        if cuda:
            # per-iteration wall time; a synchronisation, not a fetch
            torch.cuda.synchronize(device)
        tree_seconds.append(time.perf_counter() - t0)
        if obs.enabled:
            record_span("train.iteration", tree_seconds[-1])
            if obs_iter is None:
                obs_iter = obs.gauge("dryad_train_iteration",
                                     "Last boosting iteration")
            obs_iter.set(it)
        if stop:
            n_iters = it + 1
            break

    with watch_fetch("final", n_iters):
        if chunk_hook is not None:
            chunk_hook("fetch", n_iters)
        flush_deferred()
        with span("train.fetch.final"):
            booster = _materialize(p, data.mapper, out, n_iters * K, init,
                                   max_depth_prev, best_iteration,
                                   best_value, stale)
    if eval_history is not None:
        booster.train_state["eval_history"] = eval_history
    booster.tree_seconds = tree_seconds
    booster.comm_stats = comm
    return booster
