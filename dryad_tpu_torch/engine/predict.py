"""Predict: level-synchronous tree traversal over packed node words, or
over structure-of-arrays node fields where a model's fields overflow them.

The counterpart of ``dryad_tpu/engine/predict.py``'s two arms.
Traversal compares integer bin ids, and the leaf values are added in fp32
in iteration order, each class tree to its own score column, so the raw
scores are bitwise those of the reference given the same model, on any
device.  An rf model's scores are then averaged on the host
(``rf_average``).  DART's drop (``dart_drop``) and its replay-sum
(``accumulate`` over the rescaled table, the function a resumed run
rebuilds its scores with) live here too.

Packed node-word layout (per node, two limbs):

* limb0: left (bits 0..15) | right (bits 16..31)
* limb1: threshold (0..15) | feature (16..27) | default_left (28)
  | is_cat (29) | internal (30)

The reference stores the limbs as uint32.  Torch's uint32 shifts and
compares are thin, so the port keeps the same field layout in int64.

A model with categorical splits also carries each node's (CAT_WORDS,)
bitset of the bins that go left: bin b is bit ``b & 31`` of word
``min(b >> 5, CAT_WORDS - 1)``, read where is_cat (bit 29) is set.  A
model without categorical splits traverses without the bitset.

The structure-of-arrays ("legacy") table is a dict of (..., M) int64
fields (``SOA_KEYS``), taken where a feature id reaches 4096, a threshold
or a child index 65536 (``predict_layout``: ``auto`` packs when every
field fits, ``packed`` raises, ``legacy`` always takes it).  Both arms
compare the same integer values, so they agree bit for bit; every
function below that takes a table takes either.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

PACKED_CHILD_BITS = 16
PACKED_THRESHOLD_BITS = 16
PACKED_FEATURE_BITS = 12


def packed_fallback_reason(feature, threshold, left, right):
    """The first traversal field that overflows its packed width, named,
    or None when everything fits (checked against the actual values)."""
    feature = np.asarray(feature)
    internal = feature >= 0
    if not internal.any():
        return None
    named = (("feature", feature, PACKED_FEATURE_BITS),
             ("threshold", np.asarray(threshold), PACKED_THRESHOLD_BITS),
             ("left", np.asarray(left), PACKED_CHILD_BITS),
             ("right", np.asarray(right), PACKED_CHILD_BITS))
    for name, arr, bits in named:
        lo, hi = int(arr[internal].min()), int(arr[internal].max())
        if lo < 0 or hi >= (1 << bits):
            return (f"{name} range {lo}..{hi} exceeds its "
                    f"{bits}-bit packed width")
    return None


def pack_words(feature: torch.Tensor, threshold: torch.Tensor,
               left: torch.Tensor, right: torch.Tensor,
               default_left: torch.Tensor,
               is_cat: torch.Tensor | None = None) -> torch.Tensor:
    """Per-node traversal fields (..., M) -> (..., M, 2) int64 limbs on
    their device, unchecked (the caller holds every field within its
    width).  Leaf fields are zeroed so the packing depends only on
    traversal content."""
    feature = feature.to(torch.int64)
    internal = feature >= 0
    zero = torch.zeros((), dtype=torch.int64, device=feature.device)

    def field(x):
        return torch.where(internal, x.to(torch.int64), zero)

    flag = internal.to(torch.int64)
    dl = (default_left.to(torch.bool) & internal).to(torch.int64)
    ic = (zero if is_cat is None
          else (is_cat.to(torch.bool) & internal).to(torch.int64))
    limb0 = field(left) | (field(right) << PACKED_CHILD_BITS)
    limb1 = (field(threshold) | (field(feature) << 16) | (dl << 28)
             | (ic << 29) | (flag << 30))
    return torch.stack([limb0, limb1], dim=-1)


def pack_node_words(feature, threshold, left, right, default_left,
                    is_cat) -> np.ndarray:
    """``pack_words`` of numpy fields, each checked against its packed
    width."""
    feature = np.asarray(feature, np.int64)
    internal = feature >= 0
    fields = {"feature": feature, "threshold": np.asarray(threshold),
              "left": np.asarray(left), "right": np.asarray(right)}
    widths = {"feature": PACKED_FEATURE_BITS,
              "threshold": PACKED_THRESHOLD_BITS,
              "left": PACKED_CHILD_BITS, "right": PACKED_CHILD_BITS}
    for name, arr in fields.items():
        arr = np.where(internal, arr, 0)
        if arr.size and (int(arr.min()) < 0
                         or int(arr.max()) >= (1 << widths[name])):
            raise ValueError(
                f"packed predict layout: field {name!r} does not fit "
                f"{widths[name]} bits (max value {int(arr.max())}); use "
                "predict_layout='legacy' for this model")
    t = {k: torch.from_numpy(np.asarray(v, np.int64))
         for k, v in fields.items()}
    return pack_words(t["feature"], t["threshold"], t["left"], t["right"],
                      torch.from_numpy(np.asarray(default_left, bool)),
                      torch.from_numpy(np.asarray(is_cat, bool))).numpy()


def unpack_node_words(words: np.ndarray) -> dict:
    """Inverse of ``pack_node_words`` (leaf fields come back zeroed)."""
    words = np.asarray(words, np.int64)
    limb0, limb1 = words[..., 0], words[..., 1]
    internal = ((limb1 >> 30) & 1) > 0
    return {
        "left": (limb0 & 0xFFFF).astype(np.int32),
        "right": (limb0 >> PACKED_CHILD_BITS).astype(np.int32),
        "threshold": (limb1 & 0xFFFF).astype(np.int32),
        "feature": np.where(internal, (limb1 >> 16) & 0xFFF,
                            -1).astype(np.int32),
        "default_left": ((limb1 >> 28) & 1) > 0,
        "is_cat": ((limb1 >> 29) & 1) > 0,
    }


SOA_KEYS = ("feature", "threshold", "left", "right", "default_left",
            "is_cat")


def soa_table(ta: dict) -> dict:
    """The structure-of-arrays table of tree arrays ``ta`` (numpy, leading
    dims (..., M)): every traversal field as int64 (the flags 0/1)."""
    return {k: np.ascontiguousarray(ta[k], np.int64) for k in SOA_KEYS}


def table_to(table, device):
    """A staged numpy table (packed words or an SoA dict) as tensors on
    ``device``."""
    if isinstance(table, dict):
        return {k: torch.from_numpy(v).to(device) for k, v in table.items()}
    return torch.from_numpy(table).to(device)


def table_slot(table, t):
    """Tree ``t`` (or the slice ``t``) of a staged table."""
    if isinstance(table, dict):
        return {k: v[t] for k, v in table.items()}
    return table[t]


def table_len(table) -> int:
    """Trees in a staged table."""
    if isinstance(table, dict):
        return int(table["feature"].shape[0])
    return int(table.shape[0])


def stage_trees(booster, num_iteration: Optional[int] = None,
                layout: Optional[str] = None):
    """(table, value (n_iter * K, M) f32, bitset (n_iter * K, M,
    CAT_WORDS) int64 or None when no staged tree has a categorical split,
    init (K,) f32, n_iter) for the traversal of the first ``n_iter``
    iterations' trees, K per iteration.  Without ``num_iteration`` a
    booster with a best iteration (early stopping) stops there.

    ``layout`` (default ``booster.params.predict_layout``): ``packed``
    gives the (n_iter * K, M, 2) int64 node words and raises when a field
    overflows them; ``legacy`` the structure-of-arrays dict
    (``soa_table``); ``auto`` packs when every field fits, else SoA."""
    if num_iteration is None:
        num_iteration = (booster.best_iteration
                         if booster.best_iteration > 0
                         else booster.num_iterations)
    n_iter = min(num_iteration, booster.num_iterations)
    T = n_iter * booster.num_outputs
    ta = {k: v[:T] for k, v in booster.tree_arrays().items()}
    if layout is None:
        layout = booster.params.predict_layout
    if layout not in ("auto", "packed", "legacy"):
        raise ValueError("predict_layout must be auto|packed|legacy")
    if layout == "auto":
        layout = ("packed" if packed_fallback_reason(
            ta["feature"], ta["threshold"], ta["left"], ta["right"]) is None
            else "legacy")
    if layout == "packed":
        table = pack_node_words(ta["feature"], ta["threshold"], ta["left"],
                                ta["right"], ta["default_left"],
                                ta["is_cat"])
    else:
        table = soa_table(ta)
    bitset = (ta["cat_bitset"].astype(np.int64) if ta["is_cat"].any()
              else None)
    return (table, np.ascontiguousarray(ta["value"], np.float32), bitset,
            np.asarray(booster.init_score, np.float32), n_iter)


def tree_leaves(table, Xb: torch.Tensor, depth_bound: int,
                bitset: torch.Tensor | None = None) -> torch.Tensor:
    """Leaf node id every row reaches in one tree: ``table`` is its (M, 2)
    int64 node words or its SoA dict of (M,) fields; ``bitset`` (M,
    CAT_WORDS) int64 when the tree may split on a categorical feature.
    ``forest_leaves`` of a one-tree table (its flat ids are the leaf
    ids)."""
    one = ({k: v[None] for k, v in table.items()} if isinstance(table, dict)
           else table[None])
    return forest_leaves(one, Xb, depth_bound,
                         None if bitset is None else bitset[None])[:, 0]


def add_tree(table, value: torch.Tensor, Xb: torch.Tensor,
             score: torch.Tensor, depth_bound: int,
             bitset: torch.Tensor | None = None) -> torch.Tensor:
    """``score + value[leaf]`` of one tree (its table, value (M,)) over
    rows ``Xb``: the fp32 add the boosting loop makes to a valid set's
    scores when the tree is grown (the counterpart of the reference's
    ``_apply_valid_jit``)."""
    return score + value[tree_leaves(table, Xb, depth_bound, bitset)]


def accumulate(table, value: torch.Tensor, Xb: torch.Tensor,
               init: torch.Tensor, depth_bound: int,
               bitset: torch.Tensor | None = None) -> torch.Tensor:
    """Raw scores (N, K) for K = ``init.numel()``: init plus each tree's
    leaf value, tree t adding to column t % K, in fp32 in tree order (the
    reference's summation order per column, and the boosting loop's, so a
    resumed run rebuilds its scores bitwise).  ``table``: packed words or
    an SoA dict, (T, M, ...)."""
    K = init.numel()
    score = init.to(torch.float32).reshape(1, K).expand(
        Xb.shape[0], K).clone()
    for t in range(table_len(table)):
        k = t % K
        score[:, k] = add_tree(table_slot(table, t), value[t], Xb,
                               score[:, k], depth_bound,
                               None if bitset is None else bitset[t])
    return score


def forest_leaves(table, Xb: torch.Tensor, depth_bound: int,
                  bitset: torch.Tensor | None = None) -> torch.Tensor:
    """(N, T) flat node ids ``t * M + leaf`` that every row reaches in each
    of the T trees of a staged table ((T, M, 2) packed words or an SoA
    dict of (T, M) fields; ``bitset`` (T, M, CAT_WORDS)), all trees at
    once: one gather per field per level over the (N, T) node tensor.
    The one copy of the routing rule: ``tree_leaves`` is its T = 1 case."""
    soa = isinstance(table, dict)
    T, M = (table["feature"] if soa else table).shape[:2]
    flat = ({k: v.reshape(T * M) for k, v in table.items()} if soa
            else table.reshape(T * M, 2))
    bflat = None if bitset is None else bitset.reshape(T * M, -1)
    base = torch.arange(T, dtype=torch.int64, device=Xb.device) * M
    node = base.expand(Xb.shape[0], T).clone()
    for _ in range(max(int(depth_bound), 1)):
        if soa:
            f = flat["feature"][node]
            internal = f >= 0
            fc = torch.where(internal, f, 0)
            thr, dl = flat["threshold"][node], flat["default_left"][node] != 0
            left, right = flat["left"][node], flat["right"][node]
        else:
            w = flat[node]                        # (N, T, 2)
            w0, w1 = w[..., 0], w[..., 1]
            internal = ((w1 >> 30) & 1) != 0
            fc = (w1 >> 16) & 0xFFF
            thr, dl = w1 & 0xFFFF, ((w1 >> 28) & 1) != 0
            left, right = w0 & 0xFFFF, w0 >> 16
        bins = Xb.gather(1, fc).to(torch.int64)
        go_left = (bins <= thr) & (dl | (bins != 0))
        if bflat is not None:
            ic = (flat["is_cat"][node] != 0 if soa
                  else ((w1 >> 29) & 1) != 0)
            word = bflat[node, torch.clamp(bins >> 5,
                                           max=bflat.shape[1] - 1)]
            go_left = torch.where(ic, ((word >> (bins & 31)) & 1) != 0,
                                  go_left)
        node = torch.where(internal, base + torch.where(go_left, left, right),
                           node)
    return node


def forest_scores(table, value: torch.Tensor, Xb: torch.Tensor,
                  init: torch.Tensor, depth_bound: int,
                  bitset: torch.Tensor | None = None) -> torch.Tensor:
    """``accumulate`` with all trees traversed at once (``forest_leaves``):
    the leaf values then go into the (N, K) scores by in-order fp32 adds,
    tree t into column t % K, so the result is bitwise ``accumulate``'s
    with ~14 ops a level plus one add a tree, against ``accumulate``'s ~20
    a level a tree (``chip_smoke.py``'s serve phase prints both launch
    counts).  The serving cache's program."""
    T = table_len(table)
    K = init.numel()
    N = Xb.shape[0]
    cols = [init[k].to(torch.float32).expand(N).clone() for k in range(K)]
    if T:
        leaf = forest_leaves(table, Xb, depth_bound, bitset)
        vals = value.reshape(-1)[leaf].t().contiguous()     # (T, N)
        for t in range(T):
            cols[t % K].add_(vals[t])
    return torch.stack(cols, dim=1)


def packed_fits(n_features: int, max_nodes: int) -> bool:
    """Whether every feature id below ``n_features`` and every child index
    below ``max_nodes`` fits its packed width (bin thresholds always do)."""
    return (n_features <= (1 << PACKED_FEATURE_BITS)
            and max_nodes <= (1 << PACKED_CHILD_BITS))


def table_words(out: dict, sl, n_features: int):
    """The traversal table of the slots ``sl`` (an index or a slice) of the
    boosting loop's device tree tables over rows of ``n_features``
    columns: packed words as ``stage_trees`` packs a booster's ((M, 2) for
    one slot, (T, M, 2) for a slice) when the run's shapes fit them
    (``packed_fits``), else the SoA dict of the same slots, so no field is
    ever packed past its width."""
    if not packed_fits(n_features, out["feature"].shape[-1]):
        return {k: out[k][sl].to(torch.int64) for k in SOA_KEYS}
    return pack_words(out["feature"][sl], out["threshold"][sl],
                      out["left"][sl], out["right"][sl],
                      out["default_left"][sl], out["is_cat"][sl])


def dart_drop(out: dict, score: torch.Tensor, tids: np.ndarray,
              Xb: torch.Tensor, factor_drop: np.float32, depth_bound: int,
              bitset: torch.Tensor | None = None):
    """DART's drop of the tree slots ``tids`` (int64, ascending; slot t adds
    to column t % K): returns (score minus their contributions, the value
    table with their rows times ``factor_drop``).  The contributions are
    summed in fp32 in slot order into a zero (N, K) table, then
    subtracted, as the reference's ``_dart_drop_jit`` and CPU trainer do;
    ``factor_drop`` = f32(k / (k + 1)) comes from the host.  ``bitset``
    is the table's (T, M, CAT_WORDS) bitsets when a categorical split can
    occur."""
    K = score.shape[1]
    dcontrib = torch.zeros_like(score)
    for t in tids.tolist():
        c = t % K
        dcontrib[:, c] = add_tree(table_words(out, t, Xb.shape[1]),
                                  out["value"][t], Xb, dcontrib[:, c],
                                  depth_bound,
                                  None if bitset is None else bitset[t])
    value = out["value"].clone()
    idx = torch.from_numpy(tids).to(value.device)
    value[idx] = value[idx] * torch.tensor(factor_drop, device=value.device)
    return score - dcontrib, value


def rf_average(raw, init_score, n_iter: int) -> np.ndarray:
    """The rf transform of raw scores: ``init + (raw - init) * (1/n)`` in
    fp32 with the reciprocal computed on the host, two separate roundings
    (a fused multiply-add would be 1 ulp off).  Shared by predict and,
    through ``rf_average_dev``, the loop's valid-set evals."""
    inv = np.float32(1.0) / np.float32(n_iter)
    init = np.asarray(init_score, np.float32)
    return (init + (np.asarray(raw) - init) * inv).astype(np.float32)


def rf_average_dev(vs: torch.Tensor, init: torch.Tensor,
                   n_iter: int) -> torch.Tensor:
    """``rf_average`` of (N, K) scores on their device: three eager ops,
    so nothing fuses the multiply into the add."""
    inv = torch.tensor(np.float32(1.0) / np.float32(n_iter),
                       device=vs.device)
    return init + (vs - init) * inv


def predict_binned(booster, Xb: np.ndarray, *, device: torch.device,
                   num_iteration: Optional[int] = None) -> np.ndarray:
    """Raw scores (N, K) float32 of pre-binned rows (K = the booster's
    outputs), computed on ``device``; an rf model's are averaged
    (``rf_average``, on the host)."""
    from dryad_tpu_torch.dataset import binned_to_device

    table, value, bitset, init, n_iter = stage_trees(booster, num_iteration)
    raw = accumulate(table_to(table, device),
                     torch.from_numpy(value).to(device),
                     binned_to_device(np.asarray(Xb), device),
                     torch.from_numpy(init).to(device),
                     max(booster.max_depth_seen, 1),
                     None if bitset is None
                     else torch.from_numpy(bitset).to(device))
    if booster.params.boosting == "rf" and n_iter > 0:
        return rf_average(raw.cpu().numpy(), init, n_iter)
    return raw.cpu().numpy()


def visible_cards() -> list[torch.device]:
    """Every visible card, in index order; raises when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass devices=[...] (CPU devices "
            "run the plain PyTorch versions)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


# node ids one ``forest_scores`` call of the sharded predict holds at once
# (rows x trees): each int64 id and its gathered words take ~24 bytes, so
# a call's temporaries stay near 1.5 GB whatever the block's rows
SHARD_NODE_BUDGET = 1 << 26


def predict_binned_sharded(booster, Xb: np.ndarray,
                           num_iteration: Optional[int] = None,
                           devices=None) -> np.ndarray:
    """``predict_binned`` with the rows split over ``devices`` (default:
    every visible card; a device may repeat): contiguous blocks in order,
    one a device, the trees staged once on each distinct device, each
    block's scores by ``forest_scores`` (bitwise ``accumulate``), the
    blocks concatenated and an rf model's averaged after.  Every stage is
    per row and nothing crosses devices but the results, so the answer is
    bitwise the single-device predict's for any split, blocks without
    rows included.  A block goes through ``forest_scores`` in pieces of at
    most ``SHARD_NODE_BUDGET`` (row, tree) ids.  The counterpart of the
    reference's ``predict_binned_sharded(..., mesh=)``."""
    from dryad_tpu_torch.dataset import binned_to_device
    from dryad_tpu_torch.distributed import host_row_range

    devs = ([torch.device(d) for d in devices] if devices is not None
            else visible_cards())
    if not devs:
        raise ValueError("devices must name at least one device")
    table, value, bitset, init, n_iter = stage_trees(booster, num_iteration)
    depth = max(booster.max_depth_seen, 1)
    staged: dict = {}
    for d in devs:
        if d not in staged:
            staged[d] = (table_to(table, d),
                         torch.from_numpy(value).to(d),
                         torch.from_numpy(init).to(d),
                         None if bitset is None
                         else torch.from_numpy(bitset).to(d))
    Xb = np.asarray(Xb)
    step = max(1, SHARD_NODE_BUDGET // max(table_len(table), 1))
    # every block is launched before any result is fetched, so blocks on
    # different cards run at once
    parts = []
    for i, d in enumerate(devs):
        lo, hi = host_row_range(Xb.shape[0], i, len(devs))
        tab, val, ini, bits = staged[d]
        for a in range(lo, hi, step):
            b = min(hi, a + step)
            parts.append(forest_scores(tab, val,
                                       binned_to_device(Xb[a:b], d), ini,
                                       depth, bits))
    K = booster.num_outputs
    raw = (np.concatenate([p.cpu().numpy() for p in parts]) if parts
           else np.zeros((0, K), np.float32))
    if booster.params.boosting == "rf" and n_iter > 0:
        return rf_average(raw, init, n_iter)
    return raw


def predict_leaves(booster, Xb: np.ndarray, *, device: torch.device,
                   num_iteration: Optional[int] = None) -> np.ndarray:
    """(N, T) int32 leaf node ids of pre-binned rows in the first T =
    n_iter * K trees (``pred_leaf``; the ``num_iteration`` and
    ``best_iteration`` rule of the scores), traversed on ``device``."""
    from dryad_tpu_torch.dataset import binned_to_device

    table, _, bitset, _, _ = stage_trees(booster, num_iteration)
    table = table_to(table, device)
    Xd = binned_to_device(np.asarray(Xb), device)
    out = torch.empty((Xd.shape[0], table_len(table)), dtype=torch.int32,
                      device=device)
    for t in range(table_len(table)):
        out[:, t] = tree_leaves(
            table_slot(table, t), Xd, max(booster.max_depth_seen, 1),
            None if bitset is None
            else torch.from_numpy(bitset[t]).to(device))
    return out.cpu().numpy()
