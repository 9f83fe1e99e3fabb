"""Split-gain scan, batched over candidates.

The counterpart of ``dryad_tpu/engine/split.py::find_best_split``.  The
reference vmaps the scan over a level's candidates;
here the candidate axis is a leading batch dimension.  Per-feature prefix
sums, the Newton gain on both sides, a validity mask, and one flat argmax
with first-index tie-breaking (``torch.argmax`` returns the first maximum,
as ``jnp.argmax`` does).

Categorical features take the sorted-subset scan: a categorical column's
bins are ordered by ``g / (h + CAT_SMOOTH)`` (empty bins last, a stable
sort, so the lower bin wins a tie), the prefix sums run in that order, and
the winning prefix becomes the left membership set, returned as a (K, B)
bool mask.

Monotone constraints (LightGBM's "basic" mode) take the reference's arm:
each candidate carries output bounds ``lo``/``hi``; the child outputs are
clamped to them, the gain is the objective reduction ``-(G w + (H + lambda)
w^2 / 2)`` of the clamped outputs (``G^2 / (2 (H + lambda))`` unclamped),
and a +1 (-1) feature splits only where the right output is >= (<=) the
left one.  Without constraints the scan is unchanged.

The feature arm of a process group (``hist_reduce="feature"``) splits the
scan in two: each rank scans the feature slice it owns
(``find_best_split_sliced``: the same arithmetic, from the same
``_scan``, without the final gating, plus a global tie key), the ranks
exchange their packed records (``pack_local_split``), and every rank picks
the same winner (``combine_local_splits``): the largest gain, ties to the
smallest key.  The key is the fused scan's own flat argmax index,
``plane * F * B + f * B + t`` (the missing-left plane first, then feature
major), so the combine reproduces the fused scan's first-max choice bit
for bit; the gating (``allow``, a finite gain above ``min_split_gain``)
then applies once, to the global winner, as in the fused scan.
"""

from __future__ import annotations

import torch

NEG_INF = float("-inf")
CAT_SMOOTH = 10.0


def _scan(hist, G, H, C, *, lambda_l2, min_child_weight, min_data_in_leaf,
          feat_mask, learn_missing, is_cat_feat, bundled_mask, monotone,
          lo, hi):
    """The scan shared by ``find_best_split`` and
    ``find_best_split_sliced``: each candidate's first-max winner over the
    (plane, feature, bin) grid, before any gating.  Returns a dict of (K,)
    tensors: gain, f, t, g_left, h_left, c_left, default_left, and
    cat_raw, the (K, B) left set of a categorical winner (None without
    categorical features)."""
    hg, hh, hc = hist[:, 0], hist[:, 1], hist[:, 2]
    K, F, B = hg.shape
    dev = hist.device
    G3, H3, C3 = G[:, None, None], H[:, None, None], C[:, None, None]
    if is_cat_feat is not None:
        # a categorical column's bins in g/(h + smooth) order, empty last
        ratio = torch.where(hc > 0, hg / (hh + CAT_SMOOTH), float("inf"))
        iota = torch.arange(B, device=dev)
        order = torch.where(is_cat_feat[None, :, None],
                            torch.argsort(ratio, dim=2, stable=True),
                            iota)
        hg = torch.gather(hg, 2, order)
        hh = torch.gather(hh, 2, order)
        hc = torch.gather(hc, 2, order)
    GL = torch.cumsum(hg, dim=2)
    HL = torch.cumsum(hh, dim=2)
    CL = torch.cumsum(hc, dim=2)
    fmask = feat_mask[None, :, None]
    if monotone is not None:
        lo3, hi3 = lo[:, None, None], hi[:, None, None]
        mcol = monotone.to(torch.float32)[None, :, None]

    def gain_of(GLx, HLx, CLx):
        GRx, HRx, CRx = G3 - GLx, H3 - HLx, C3 - CLx
        valid = ((CLx >= min_data_in_leaf) & (CRx >= min_data_in_leaf)
                 & (HLx >= min_child_weight) & (HRx >= min_child_weight)
                 & fmask)
        if monotone is not None:
            # clamped child outputs; unconstrained features pass whatever
            # their (possibly NaN) outputs are
            wl = torch.clamp(-GLx / (HLx + lambda_l2), lo3, hi3)
            wr = torch.clamp(-GRx / (HRx + lambda_l2), lo3, hi3)
            wp = torch.clamp(-G3 / (H3 + lambda_l2), lo3, hi3)
            valid &= (mcol == 0) | (mcol * (wr - wl) >= 0)
            red_l = -(GLx * wl + 0.5 * (HLx + lambda_l2) * wl * wl)
            red_r = -(GRx * wr + 0.5 * (HRx + lambda_l2) * wr * wr)
            red_p = -(G3 * wp + 0.5 * (H3 + lambda_l2) * wp * wp)
            gain = red_l + red_r - red_p
        else:
            parent = G3 * G3 / (H3 + lambda_l2)
            gain = 0.5 * (GLx * GLx / (HLx + lambda_l2)
                          + GRx * GRx / (HRx + lambda_l2) - parent)
        return torch.where(valid, gain, NEG_INF)

    gain = gain_of(GL, HL, CL).reshape(K, F * B)
    rows = torch.arange(K, device=hist.device)
    if learn_missing:
        # second plane: the missing bin (0) goes right, left = bins 1..t.
        # The missing-left plane comes first in the flat argmax, so on data
        # without missing values the tie-break keeps missing-left.
        g0, h0, c0 = hg[:, :, :1], hh[:, :, :1], hc[:, :, :1]
        CL_r = CL - c0
        gain_r = gain_of(GL - g0, HL - h0, CL_r)
        # a right child of only missing rows mirrors plane 0 at t=0
        gain_r = torch.where((C3 - CL_r) > c0, gain_r, NEG_INF)
        # categorical columns learn the missing direction by membership,
        # and a bundle column's bin 0 means "every member at its default"
        for off in (is_cat_feat, bundled_mask):
            if off is not None:
                gain_r = torch.where(off[None, :, None], NEG_INF, gain_r)
        both = torch.cat([gain, gain_r.reshape(K, F * B)], dim=1)
        flat2 = torch.argmax(both, dim=1)
        dleft = flat2 < F * B
        flat = flat2 % (F * B)
        best_gain = both[rows, flat2]
    else:
        flat = torch.argmax(gain, dim=1)
        dleft = torch.ones(K, dtype=torch.bool, device=hist.device)
        best_gain = gain[rows, flat]
    f = flat // B
    t = flat % B
    g_left, h_left, c_left = GL[rows, f, t], HL[rows, f, t], CL[rows, f, t]
    if learn_missing:
        g_left = torch.where(dleft, g_left, g_left - hg[rows, f, 0])
        h_left = torch.where(dleft, h_left, h_left - hh[rows, f, 0])
        c_left = torch.where(dleft, c_left, c_left - hc[rows, f, 0])
    cat_raw = None
    if is_cat_feat is not None:
        # the left set: bins whose rank in the scan order is <= t
        rank = torch.empty_like(order[:, 0]).scatter_(
            1, order[rows, f], iota.expand(K, B))
        cat_raw = (rank <= t[:, None]) & is_cat_feat[f][:, None]
    return {"gain": best_gain, "f": f, "t": t, "g_left": g_left,
            "h_left": h_left, "c_left": c_left, "default_left": dleft,
            "cat_raw": cat_raw}


def find_best_split(hist: torch.Tensor, G: torch.Tensor, H: torch.Tensor,
                    C: torch.Tensor, *, lambda_l2: float,
                    min_child_weight: float, min_data_in_leaf: int,
                    min_split_gain: float, feat_mask: torch.Tensor,
                    allow: torch.Tensor,
                    learn_missing: bool = False,
                    is_cat_feat: torch.Tensor | None = None,
                    bundled_mask: torch.Tensor | None = None,
                    monotone: torch.Tensor | None = None,
                    lo: torch.Tensor | None = None,
                    hi: torch.Tensor | None = None
                    ) -> dict[str, torch.Tensor]:
    """hist (K, 3, F, B) f32; G/H/C/allow (K,); ``is_cat_feat`` (F,) bool
    when any feature is categorical (None skips the sorted-subset scan, so
    numeric runs are unchanged); ``bundled_mask`` (F,) bool, EFB bundle
    columns, kept out of the missing-right plane; ``monotone`` (F,) int32
    in {-1, 0, 1} with the candidates' (K,) f32 output bounds ``lo`` and
    ``hi`` (None: no constraint, the unconstrained scan).  Returns a dict of (K,)
    tensors: gain (-inf where no valid split), feature (-1 then),
    threshold (a bin id, or a categorical prefix length), g_left, h_left,
    c_left, default_left, and cat_mask (K, B) bool, the left set of a
    categorical split (all False otherwise; (K, 1) without categoricals)."""
    r = _scan(hist, G, H, C, lambda_l2=lambda_l2,
              min_child_weight=min_child_weight,
              min_data_in_leaf=min_data_in_leaf, feat_mask=feat_mask,
              learn_missing=learn_missing, is_cat_feat=is_cat_feat,
              bundled_mask=bundled_mask, monotone=monotone, lo=lo, hi=hi)
    return _gated(r["gain"], r["f"], r["t"], r["g_left"], r["h_left"],
                  r["c_left"], r["default_left"], r["cat_raw"], allow=allow,
                  min_split_gain=min_split_gain)


def _gated(best_gain, f, t, g_left, h_left, c_left, dleft, cat_raw, *,
           allow, min_split_gain):
    """The winner's record, gated once: a split needs ``allow`` and a
    finite gain above ``min_split_gain``."""
    ok = allow & torch.isfinite(best_gain) & (best_gain > min_split_gain)
    if cat_raw is not None:
        cat_mask = cat_raw & ok[:, None]
    else:
        cat_mask = torch.zeros((f.shape[0], 1), dtype=torch.bool,
                               device=f.device)
    return {
        "gain": torch.where(ok, best_gain, NEG_INF),
        "feature": torch.where(ok, f, -1),
        "threshold": t,
        "g_left": g_left,
        "h_left": h_left,
        "c_left": c_left,
        "default_left": dleft | ~ok,
        "cat_mask": cat_mask,
    }


def find_best_split_sliced(hist: torch.Tensor, G: torch.Tensor,
                           H: torch.Tensor, C: torch.Tensor, *,
                           feat_offset: int, num_features_total: int,
                           lambda_l2: float, min_child_weight: float,
                           min_data_in_leaf: int, feat_mask: torch.Tensor,
                           learn_missing: bool = False,
                           is_cat_feat: torch.Tensor | None = None,
                           bundled_mask: torch.Tensor | None = None,
                           monotone: torch.Tensor | None = None,
                           lo: torch.Tensor | None = None,
                           hi: torch.Tensor | None = None
                           ) -> dict[str, torch.Tensor]:
    """``find_best_split`` over one rank's feature slice (module doc): hist
    (K, 3, Fs, B) holds the reduced histograms of global features
    ``[feat_offset, feat_offset + Fs)`` (zero past F), and the (Fs,) masks
    are sliced alike.  Returns the raw winner (no gating) as a dict of (K,)
    tensors: gain, key (the global tie key), feature (global), threshold,
    g_left, h_left, c_left, default_left, and cat_mask, the raw (K, B)
    left set (None without categorical features)."""
    r = _scan(hist, G, H, C, lambda_l2=lambda_l2,
              min_child_weight=min_child_weight,
              min_data_in_leaf=min_data_in_leaf, feat_mask=feat_mask,
              learn_missing=learn_missing, is_cat_feat=is_cat_feat,
              bundled_mask=bundled_mask, monotone=monotone, lo=lo, hi=hi)
    B = hist.shape[-1]
    f_global = r["f"] + int(feat_offset)
    span = int(num_features_total) * B
    key = torch.where(r["default_left"], 0, span) + f_global * B + r["t"]
    return {"gain": r["gain"], "key": key, "feature": f_global,
            "threshold": r["t"], "g_left": r["g_left"],
            "h_left": r["h_left"], "c_left": r["c_left"],
            "default_left": r["default_left"], "cat_mask": r["cat_raw"]}


# the packed record of pack_local_split: gain, key, feature, threshold,
# g_left, h_left, c_left, default_left
LOCAL_SPLIT_WORDS = 8
_I32_MAX = 2 ** 31 - 1


def pack_local_split(rec: dict[str, torch.Tensor]) -> torch.Tensor:
    """A sliced scan's record -> (K, 8) int32 words, the reference's
    layout (floats by their bits), so one all-gather carries a level."""
    def fbits(x):
        return x.to(torch.float32).view(torch.int32)

    return torch.stack([
        fbits(rec["gain"]), rec["key"].to(torch.int32),
        rec["feature"].to(torch.int32), rec["threshold"].to(torch.int32),
        fbits(rec["g_left"]), fbits(rec["h_left"]), fbits(rec["c_left"]),
        rec["default_left"].to(torch.int32)], dim=-1)


def combine_local_splits(words: torch.Tensor, cat_rows, *, allow,
                         min_split_gain: float) -> dict[str, torch.Tensor]:
    """The gathered records ``words`` (n, K, 8) of n ranks, and their raw
    categorical rows ``cat_rows`` (n, K, B) bool or None -> the
    ``find_best_split`` result: per candidate the largest gain, ties to
    the smallest key, then gated once (module doc)."""
    gains = words[..., 0].view(torch.float32)
    keys = words[..., 1]
    best_gain = gains.max(0).values
    tie = torch.where(gains == best_gain[None], keys, _I32_MAX)
    win = torch.argmin(tie, dim=0)
    cols = torch.arange(words.shape[1], device=words.device)
    w = words[win, cols]                                   # (K, 8)
    fl = w[:, 4:7].view(torch.float32)
    cat_raw = None if cat_rows is None else cat_rows[win, cols]
    return _gated(best_gain, w[:, 2].to(torch.int64),
                  w[:, 3].to(torch.int64), fl[:, 0], fl[:, 1], fl[:, 2],
                  w[:, 7] != 0, cat_raw, allow=allow,
                  min_split_gain=min_split_gain)
