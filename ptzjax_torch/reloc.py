"""Relocalization: recover (pan, tilt, focal) when tracking is lost. Port of
``ptzjax/reloc.py``: the map path (``relocalize``) and the nearest-keyframe
path (``relocalize_keyframes``).

The lost frame's descriptors are matched against the global ray store (or
every keyframe's feature table), a focal-grid sweep lets every
correspondence vote a (pan, tilt) in closed form, the densest vote wins,
and two rounds of gating + Huber-weighted Gauss-Newton refine all three
parameters.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ptzjax_torch import _device
from ptzjax_torch import match as matchlib
from ptzjax_torch.config import SLAMConfig
from ptzjax_torch.geometry import Intrinsics, project_jacobians
from ptzjax_torch.mapstore import KeyframeStore, RayStore


class RelocResult(NamedTuple):
    pose: torch.Tensor             # (3,) recovered (pan, tilt, f)
    inliers: torch.Tensor          # () consensus size after refinement
    success: torch.Tensor          # () bool
    matched_ray_ids: torch.Tensor  # (Q,) int32 ray id per query feature (-1 none)
    matched_ok: torch.Tensor       # (Q,) bool final inlier mask per query


def _vote_pose(f, rays, xy, w, intr: Intrinsics):
    """Masked-median (pan, tilt) vote for each hypothesized focal: f (...,)
    -> poses (..., 3)."""
    f = f[..., None]
    u = torch.atan2(xy[:, 0] - float(intr.cx), f)
    pan_i = rays[:, 0] - u
    tilt_i = rays[:, 1] - torch.atan2(-(xy[:, 1] - float(intr.cy)) * torch.cos(u), f)
    # masked median: sort with invalid pushed to +inf, pick middle of valid
    mid = ((w.sum().clamp_min(1) - 1) // 2).view(1)

    def masked_median(vals):
        sv = torch.sort(torch.where(w, vals, float("inf")), dim=-1).values
        return sv.index_select(-1, mid)[..., 0]

    return torch.stack(
        [masked_median(pan_i), masked_median(tilt_i), f[..., 0].expand(pan_i.shape[:-1])], -1
    )


def _count_inliers(pose, rays, xy, w, intr, tol_px):
    pix, _, _ = project_jacobians(pose, rays, intr)
    err = torch.linalg.vector_norm(pix - xy, dim=-1)
    inl = w & (err < tol_px)
    return inl, inl.sum(-1)


def solve_pose(
    rays, xy, w, intr: Intrinsics, init_pose, iters: int = 20, huber_px: float = 3.0,
    damping: float = 1e-3,
):
    """Huber-weighted damped Gauss-Newton over (pan, tilt, f), a fixed
    number of 3x3 solves (``solve_ex``: a singular system gives non-finite
    numbers instead of raising, as in the reference)."""
    fs = 1e-3  # focal scaling for conditioning, as in BA
    dev = rays.device
    scale = _device.const((1.0, 1.0, 1.0 / fs), dev)
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    col_scale = _device.const((1.0, 1.0, fs), dev)
    wf = w.to(torch.float32)
    pose = init_pose
    for _ in range(iters):
        pix, j_cam, _ = project_jacobians(pose, rays, intr)
        r = pix - xy                                  # (N, 2)
        j = j_cam / col_scale                         # scaled f column
        rn = torch.linalg.vector_norm(r, dim=-1)
        hub = torch.sqrt(
            torch.where(rn > huber_px, huber_px / rn.clamp_min(1e-9), torch.ones_like(rn))
        )
        wgt = (wf * hub)[:, None]
        jw = j * wgt[..., None]
        rw = r * wgt
        h = torch.einsum("nab,nac->bc", jw, jw)
        g = torch.einsum("nab,na->b", jw, rw)
        h = h + damping * torch.diag(torch.diagonal(h)) + 1e-8 * eye3
        step = torch.linalg.solve_ex(h, -g).result * scale
        pose = pose + step
    return pose


def solve_from_correspondences(
    mrays, xy, w, intr: Intrinsics, cfg: SLAMConfig,
    f_range: tuple[float, float] = (800.0, 6000.0), num_f: int = 32, tol_px: float = 8.0,
):
    """Pose from 2D <-> ray correspondences: focal-grid vote, then two rounds
    of gate + Huber-GN refine.

    Returns:
      (pose (3,), inlier_mask (Q,), num_inliers (), success ()).
    """
    dev = mrays.device
    fgrid = torch.exp(
        torch.linspace(math.log(f_range[0]), math.log(f_range[1]), num_f, device=dev)
    ).to(torch.float32)
    poses = _vote_pose(fgrid, mrays, xy, w, intr)              # (F, 3)
    _, counts = _count_inliers(poses, mrays, xy, w, intr, 2 * tol_px)   # (F,)
    best = poses[torch.argmax(counts, dim=0, keepdim=True)][0]

    # refine on the coarse inlier set, then re-gate and refine once more
    inl0, _ = _count_inliers(best, mrays, xy, w, intr, 4 * tol_px)
    pose1 = solve_pose(mrays, xy, inl0, intr, best, iters=cfg.reloc_iters)
    inl1, _ = _count_inliers(pose1, mrays, xy, w, intr, tol_px)
    pose2 = solve_pose(mrays, xy, inl1, intr, pose1, iters=cfg.reloc_iters)
    inl2, n2 = _count_inliers(pose2, mrays, xy, w, intr, tol_px)
    return pose2, inl2, n2, n2 >= cfg.reloc_min_matches


def relocalize(
    desc, xy, valid, ray_store: RayStore, intr: Intrinsics, cfg: SLAMConfig,
    f_range: tuple[float, float] = (800.0, 6000.0), num_f: int = 32, tol_px: float = 8.0,
) -> RelocResult:
    """Full relocalization from a lost frame's features against the map."""
    m = matchlib.match_descriptors(
        desc, ray_store.desc, valid, ray_store.valid, ratio=cfg.ratio_test
    )
    mrays = ray_store.rays[m.idx]                    # (Q, 2)
    pose2, inl2, n2, success = solve_from_correspondences(
        mrays, xy, m.ok, intr, cfg, f_range=f_range, num_f=num_f, tol_px=tol_px
    )
    return RelocResult(
        pose=pose2,
        inliers=n2,
        success=success,
        matched_ray_ids=torch.where(inl2, m.idx, -1),
        matched_ok=inl2,
    )


def relocalize_keyframes(
    desc, xy, valid, kf: KeyframeStore, ray_store: RayStore, intr: Intrinsics,
    cfg: SLAMConfig, f_range: tuple[float, float] = (800.0, 6000.0), num_f: int = 32,
    tol_px: float = 8.0,
) -> RelocResult:
    """Nearest-keyframe relocalization: one (Q, K*F) match against every
    keyframe's features, a per-keyframe vote picks the nearest keyframe, and
    its 2D <-> ray correspondences are refined from that keyframe's stored
    pose; the focal-grid vote replaces the result when it finds more
    inliers."""
    k, f, d = kf.desc.shape
    flat_desc = kf.desc.reshape(k * f, d)
    flat_ok = (kf.feat_valid & kf.valid[:, None] & (kf.ray_ids >= 0)).reshape(-1)
    m = matchlib.match_descriptors(
        desc, flat_desc, valid, flat_ok, ratio=cfg.ratio_test, mutual=False
    )
    kf_of = m.idx // f
    # the reference's drop-mode scatter: misses vote into a padded row k
    votes = torch.zeros(k + 1, dtype=torch.int32, device=desc.device).index_add_(
        0, torch.where(m.ok, kf_of, k).long(), torch.ones_like(kf_of)
    )[:k]
    kbest = torch.argmax(votes, dim=0, keepdim=True)   # (1,): no host read

    ray_ids = kf.ray_ids.reshape(-1)[m.idx]
    ok = m.ok & (kf_of == kbest) & (ray_ids >= 0)
    mrays = ray_store.rays[ray_ids.clamp_min(0)]

    # pose init: the nearest keyframe's stored pose (refine handles the rest)
    init = kf.poses.index_select(0, kbest)[0]
    inl0, _ = _count_inliers(init, mrays, xy, ok, intr, 4 * tol_px)
    pose1 = solve_pose(mrays, xy, inl0, intr, init, iters=cfg.reloc_iters)
    inl1, _ = _count_inliers(pose1, mrays, xy, ok, intr, tol_px)
    pose2 = solve_pose(mrays, xy, inl1, intr, pose1, iters=cfg.reloc_iters)
    inl2, n2 = _count_inliers(pose2, mrays, xy, ok, intr, tol_px)

    # fall back to the focal-grid vote when the keyframe seed fails (e.g. the
    # camera zoomed far between losing and recovering)
    pose_v, inl_v, n_v, _ = solve_from_correspondences(
        mrays, xy, ok, intr, cfg, f_range=f_range, num_f=num_f, tol_px=tol_px
    )
    use_vote = n_v > n2
    pose2 = torch.where(use_vote, pose_v, pose2)
    inl2 = torch.where(use_vote, inl_v, inl2)
    n2 = torch.where(use_vote, n_v, n2)
    return RelocResult(
        pose=pose2,
        inliers=n2,
        success=n2 >= cfg.reloc_min_matches,
        matched_ray_ids=torch.where(inl2, ray_ids, -1),
        matched_ok=inl2,
    )
