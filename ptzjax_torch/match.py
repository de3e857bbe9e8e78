"""Descriptor matching, pan-tilt consensus and RANSAC, and slot scatter.
Port of ``ptzjax/match.py``. Both matchers reduce the masked score matrix through
``kernels.match.match_scores`` (the Hopper kernel on the card, its plain
version on the CPU) and take their decisions here.

Descriptors are unit-norm, so squared L2 distance = 2 - 2 * cosine and the
Lowe ratio test ``d1/d2 < ratio`` becomes ``(1 - s1) < ratio^2 (1 - s2)``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ptzjax_torch import _device, _prng
from ptzjax_torch.kernels.match import match_scores

_NEG = -1e9


class MatchResult(NamedTuple):
    """Per-query-row match into the reference set.

    Attributes:
      idx: (Q,) int32 best reference index (0 where invalid).
      ok: (Q,) bool match survived ratio/mutual/gating.
      score: (Q,) fp32 cosine similarity of the best match.
    """

    idx: torch.Tensor
    ok: torch.Tensor
    score: torch.Tensor


def _decide(q_valid, i1, v1, v2, col_best, ratio, min_score, gated) -> MatchResult:
    """Lowe ratio, absolute score floor and (when ``col_best`` is given) the
    mutual-best check on the matcher's per-row reductions; one function for
    the kernel and the plain version."""
    d1 = (1.0 - v1).clamp_min(0.0)
    d2 = (1.0 - v2).clamp_min(1e-12)
    ratio_ok = d1 < ratio * ratio * d2
    if gated:
        # ratio only when a second candidate exists inside the gate
        ratio_ok = torch.where(v2 > _NEG / 2, ratio_ok, torch.ones_like(ratio_ok))
    ok = q_valid & (v1 > min_score) & ratio_ok
    if col_best is not None:
        rows = torch.arange(i1.shape[0], dtype=torch.int32, device=i1.device)
        ok = ok & (col_best[i1] == rows)
    return MatchResult(idx=torch.where(ok, i1, torch.zeros_like(i1)), ok=ok, score=v1)


def match_descriptors(
    d_query, d_ref, q_valid, r_valid, ratio: float = 0.8, mutual: bool = True,
    min_score: float = 0.5,
) -> MatchResult:
    """BF match with Lowe ratio, absolute score floor, and optional
    mutual-best check (d_query (Q, D), d_ref (R, D), unit rows)."""
    i1, v1, v2, col_best = match_scores(d_query, d_ref, q_valid, r_valid, mutual=mutual)
    return _decide(q_valid, i1, v1, v2, col_best, ratio, min_score, gated=False)


def match_gated(
    d_query, xy_query, d_ref, xy_ref_pred, q_valid, r_valid, gate_px: float,
    ratio: float = 0.9, min_score: float = 0.5,
) -> MatchResult:
    """Match with a spatial gate: a query keypoint may only match reference
    entries whose predicted pixel position lies within ``gate_px``."""
    i1, v1, v2, col_best = match_scores(
        d_query, d_ref, q_valid, r_valid, xy_query, xy_ref_pred, gate_px=gate_px
    )
    return _decide(q_valid, i1, v1, v2, col_best, ratio, min_score, gated=True)


def stable_topk_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries, largest first, equal values in index
    order — the tie order of ``jax.lax.top_k``, which callers rely on where
    ties are decided by position."""
    return torch.sort(x, descending=True, stable=True).indices[:k]


def consensus_pan_tilt(
    rays, xy, ok, focal, cx: float, cy: float, inlier_px: float = 6.0,
    focal_correct: bool = True, score=None, max_hypotheses: int = 256,
):
    """Exhaustive pan-tilt consensus: every candidate match votes a (pan,
    tilt), each vote is scored against all matches (with a per-hypothesis
    closed-form focal correction), and the winner's inliers are refit once.
    Above ``max_hypotheses`` candidates the hypothesis axis is cut to the
    best-scoring ok matches. See ``ptzjax/match.py`` for the rationale.

    Returns:
      (inlier_mask (Q,), best_count ()).
    """
    q = rays.shape[0]
    cx, cy = float(cx), float(cy)
    u = torch.atan2(xy[:, 0] - cx, focal)
    pan_i = rays[:, 0] - u
    tilt_i = rays[:, 1] - torch.atan2(-(xy[:, 1] - cy) * torch.cos(u), focal)

    if q > max_hypotheses:
        # deterministic hypothesis cut: ok candidates ranked by match score
        base = torch.zeros_like(pan_i) if score is None else score.to(torch.float32)
        rank = torch.where(ok, base, torch.full_like(base, _NEG))
        hyp_idx = stable_topk_indices(rank, max_hypotheses)       # (H,)
        h_pan, h_tilt, hyp_ok = pan_i[hyp_idx], tilt_i[hyp_idx], ok[hyp_idx]
    else:
        h_pan, h_tilt, hyp_ok = pan_i, tilt_i, ok

    du = rays[None, :, 0] - h_pan[:, None]                   # (H, Q)
    dv = rays[None, :, 1] - h_tilt[:, None]
    tx = torch.tan(du)
    ty = -torch.tan(dv) / torch.cos(du)
    ex = xy[None, :, 0] - (focal * tx + cx)
    ey = xy[None, :, 1] - (focal * ty + cy)
    zero = torch.zeros_like(ex)
    if focal_correct:
        err2 = ex * ex + ey * ey
        coarse = ok[None, :] & (err2 < 9.0 * inlier_px * inlier_px)
        num = torch.where(coarse, tx * ex + ty * ey, zero).sum(1)
        den = torch.where(coarse, tx * tx + ty * ty, zero).sum(1)
        df = num / den.clamp_min(1e-6)                       # (H,)
        ex = ex - df[:, None] * tx
        ey = ey - df[:, None] * ty
    err2 = ex * ex + ey * ey
    inl = ok[None, :] & (err2 < inlier_px * inlier_px)       # (H, Q)
    counts = torch.where(hyp_ok, inl.sum(1), torch.full_like(hyp_ok, -1, dtype=torch.int64))
    best = torch.argmax(counts, dim=0, keepdim=True)   # (1,): no host read

    # refit-and-rescore: one least-squares (pan, tilt, focal) correction over
    # the winner's inliers (closed-form 3x3 solve, as in the reference)
    w = inl[best][0].to(torch.float32)
    bx, by = ex[best][0], ey[best][0]
    btx, bty = tx[best][0], ty[best][0]
    nw = w.sum().clamp_min(1.0)
    a11 = nw
    a22 = nw
    a13 = (w * btx).sum()
    a23 = (w * bty).sum()
    a33 = (w * (btx * btx + bty * bty)).sum() + 1e-6
    b1 = (w * bx).sum()
    b2 = (w * by).sum()
    b3 = (w * (btx * bx + bty * by)).sum()
    a11 = a11 + 1e-6
    a22 = a22 + 1e-6
    a33 = a33 + 1e-6
    det = a11 * (a22 * a33 - a23 * a23) + a13 * (-a22 * a13)
    # bound magnitude but PRESERVE sign (sign(0) treated as +)
    sgn = torch.where(det < 0.0, -1.0, 1.0)
    det = sgn * det.abs().clamp_min(1e-12)
    sol = torch.stack(
        [
            b1 * (a22 * a33 - a23 * a23) + b2 * (a23 * a13) + b3 * (-a22 * a13),
            b1 * (a13 * a23) + b2 * (a11 * a33 - a13 * a13) + b3 * (-a11 * a23),
            b1 * (-a13 * a22) + b2 * (-a11 * a23) + b3 * (a11 * a22),
        ]
    ) / det
    rx = bx - sol[0] - sol[2] * btx
    ry = by - sol[1] - sol[2] * bty
    refined = ok & (rx * rx + ry * ry < inlier_px * inlier_px)
    return refined, refined.sum()


def ransac_pan_tilt(
    rays, xy, ok, focal, cx: float, cy: float, num_hypotheses: int = 64,
    inlier_px: float = 3.0, seed: int = 0,
):
    """Pan-tilt-consistency outlier rejection for 2D <-> ray matches: each
    of ``num_hypotheses`` sampled matches votes a closed-form (pan, tilt)
    (candidate 0's first valid vote where the pick is invalid), every vote
    is scored against all matches, and the best one's inliers are kept.

    The picks are ``jax.random.randint(PRNGKey(seed), (H,), 0, Q)``, the
    reference's draw, computed on the host once per (seed, H, Q) and kept
    on the device.

    Returns:
      (Q,) bool inlier mask (a subset of ``ok``).
    """
    q = rays.shape[0]
    cx, cy = float(cx), float(cy)
    focal = torch.as_tensor(focal, dtype=torch.float32, device=rays.device)
    u = torch.atan2(xy[:, 0] - cx, focal)
    pan_i = rays[:, 0] - u
    tilt_i = rays[:, 1] - torch.atan2(-(xy[:, 1] - cy) * torch.cos(u), focal)

    pick = _device.const(_prng.ransac_picks(seed, num_hypotheses, q), rays.device, torch.int64)
    first_ok = torch.argmax(ok.to(torch.uint8), dim=0, keepdim=True)   # (1,): no host read
    pick = torch.where(ok[pick], pick, first_ok)
    h_pan = pan_i[pick]                                      # (H,)
    h_tilt = tilt_i[pick]

    du = rays[None, :, 0] - h_pan[:, None]                   # (H, Q)
    dv = rays[None, :, 1] - h_tilt[:, None]
    px = focal * torch.tan(du) + cx
    py = -focal * torch.tan(dv) / torch.cos(du) + cy
    err2 = (px - xy[None, :, 0]) ** 2 + (py - xy[None, :, 1]) ** 2
    inl = ok[None, :] & (err2 < inlier_px * inlier_px)       # (H, Q)
    best = torch.argmax(inl.sum(1), dim=0, keepdim=True)
    return inl[best][0]


def scatter_to_slots(result: MatchResult, xy_query, num_slots: int):
    """Query->slot matches as slot-aligned EKF observations.

    Returns:
      (obs (N, 2), obs_mask (N,)); a slot matched by no query gets zeros.
    """
    tgt = torch.where(result.ok, result.idx, torch.full_like(result.idx, num_slots))
    slots = torch.arange(num_slots, dtype=torch.int32, device=tgt.device)
    onehot = tgt[None, :] == slots[:, None]                  # (N, Q)
    hit = onehot.any(1)
    cand = torch.argmax(onehot.to(torch.uint8), dim=1)       # first matching query
    obs = torch.where(hit[:, None], xy_query[cand], torch.zeros_like(xy_query[cand]))
    return obs, hit
