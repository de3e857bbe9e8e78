"""Global map: keyframe registry + ray store, and the map -> BA bridge.
Port of ``ptzjax/mapstore.py``.

Every landmark has a global ray id = its row in RayStore; EKF slots and
keyframe feature tables refer to rays by id (-1 = none). All stores are
fixed-capacity padded tensors.

Scatters with a sentinel index: the reference writes through
``.at[idx].set(..., mode="drop")`` with idx = capacity for "no write".
Torch raises on such an index (and device-asserts on CUDA), so each of
those writes goes into a buffer with one extra row that is sliced off.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ptzjax_torch.ba import BAProblem
from ptzjax_torch.config import SLAMConfig


class RayStore(NamedTuple):
    """Global ray landmarks (rows are a free list: ``valid`` marks live rays).

    Attributes:
      rays: (M, 2) current estimates.
      desc: (M, D) representative unit descriptor.
      valid: (M,) bool.
      views: (M,) int32 number of keyframes observing the ray.
      count: () int32 number of live rays (== valid.sum()).
      last_seen: (M,) int32 frame index of the last confirmed observation.
    """

    rays: torch.Tensor
    desc: torch.Tensor
    valid: torch.Tensor
    views: torch.Tensor
    count: torch.Tensor
    last_seen: torch.Tensor


class KeyframeStore(NamedTuple):
    """Keyframe records.

    Attributes:
      poses: (K, 3); frame_idx: (K,) int32; valid: (K,) bool;
      xy: (K, F, 2); desc: (K, F, D); ray_ids: (K, F) int32 (-1 = none);
      feat_valid: (K, F) bool; count: () int32.
    """

    poses: torch.Tensor
    frame_idx: torch.Tensor
    valid: torch.Tensor
    xy: torch.Tensor
    desc: torch.Tensor
    ray_ids: torch.Tensor
    feat_valid: torch.Tensor
    count: torch.Tensor


def set_rows_drop(dst: torch.Tensor, idx: torch.Tensor, values) -> torch.Tensor:
    """``dst.at[idx].set(values, mode="drop")`` for idx in [0, len(dst)]:
    rows with idx == len(dst) are written to a padding row and dropped."""
    m = dst.shape[0]
    buf = torch.cat([dst, dst[:1]])
    if not isinstance(values, torch.Tensor):   # a fill: no host-to-device copy
        values = torch.full(idx.shape, values, dtype=dst.dtype, device=dst.device)
    buf.index_put_((idx.long(),), values.to(dst.dtype))
    return buf[:m]


def add_rows_drop(dst: torch.Tensor, idx: torch.Tensor, value: int) -> torch.Tensor:
    """``dst.at[idx].add(value, mode="drop")`` for idx in [0, len(dst)]."""
    m = dst.shape[0]
    buf = torch.cat([dst, dst[:1]])
    buf.index_add_(0, idx.long(), torch.full(idx.shape, value, dtype=dst.dtype, device=dst.device))
    return buf[:m]


def mark_ids(ids: torch.Tensor, m: int) -> torch.Tensor:
    """(M,) bool: True at every id >= 0 in ``ids``."""
    return set_rows_drop(
        torch.zeros(m, dtype=torch.bool, device=ids.device), torch.where(ids >= 0, ids, m), True
    )


def init_ray_store(cfg: SLAMConfig, device=None) -> RayStore:
    m, d = cfg.max_map_rays, cfg.kf_desc_dim
    return RayStore(
        rays=torch.zeros((m, 2), dtype=torch.float32, device=device),
        desc=torch.zeros((m, d), dtype=torch.float32, device=device),
        valid=torch.zeros(m, dtype=torch.bool, device=device),
        views=torch.zeros(m, dtype=torch.int32, device=device),
        count=torch.tensor(0, dtype=torch.int32, device=device),
        last_seen=torch.zeros(m, dtype=torch.int32, device=device),
    )


def init_keyframe_store(cfg: SLAMConfig, device=None) -> KeyframeStore:
    k, f, d = cfg.max_keyframes, cfg.max_keypoints, cfg.kf_desc_dim
    return KeyframeStore(
        poses=torch.zeros((k, 3), dtype=torch.float32, device=device),
        frame_idx=torch.full((k,), -1, dtype=torch.int32, device=device),
        valid=torch.zeros(k, dtype=torch.bool, device=device),
        xy=torch.zeros((k, f, 2), dtype=torch.float32, device=device),
        desc=torch.zeros((k, f, d), dtype=torch.float32, device=device),
        ray_ids=torch.full((k, f), -1, dtype=torch.int32, device=device),
        feat_valid=torch.zeros((k, f), dtype=torch.bool, device=device),
        count=torch.tensor(0, dtype=torch.int32, device=device),
    )


def add_rays(store: RayStore, rays, desc, mask, frame_idx=0) -> tuple[RayStore, torch.Tensor]:
    """Allocate rows for new rays from the free list (the j-th accepted
    candidate claims the j-th free row).

    Args:
      rays: (B, 2); desc: (B, D); mask: (B,) candidates to allocate.
      frame_idx: current frame (stamps ``last_seen``).

    Returns:
      (store, ids): ids (B,) int32, -1 where not allocated.
    """
    b = rays.shape[0]
    dev = rays.device
    free = ~store.valid
    csf = torch.cumsum(free.to(torch.int64), 0)           # (M,) nondecreasing
    free_rank = csf - 1
    cand_csum = torch.cumsum(mask.to(torch.int64), 0)     # (B,)
    cand_rank = cand_csum - 1
    ok = mask & (cand_rank < csf[-1])
    num_ok = ok.sum()
    row_of_rank = torch.searchsorted(csf, torch.arange(1, b + 1, device=dev))
    ids = torch.where(ok, row_of_rank[cand_rank.clamp(0, b - 1)], -1).to(torch.int32)
    write = free & (free_rank < num_ok)                   # (M,) rows written
    cand_of_row = torch.searchsorted(cand_csum, csf.clamp_min(1))
    src = cand_of_row.clamp(0, b - 1)
    stamp = torch.as_tensor(frame_idx, dtype=torch.int32, device=dev)
    new = RayStore(
        rays=torch.where(write[:, None], rays[src], store.rays),
        desc=torch.where(write[:, None], desc[src], store.desc),
        valid=store.valid | write,
        views=torch.where(write, 0, store.views),
        count=store.count + num_ok.to(torch.int32),
        last_seen=torch.where(write, stamp, store.last_seen),
    )
    return new, ids


def update_rays(
    store: RayStore, ids, rays, mask, frame_idx=None, respect_anchors: bool = False
) -> RayStore:
    """Write refined ray estimates back by id. Non-finite values are never
    written; with ``respect_anchors`` keyframe-observed rays (views > 0) keep
    their values (only BA moves them). ``last_seen`` is stamped for every
    confirmed observation."""
    m = store.rays.shape[0]
    ok = mask & (ids >= 0)
    vmask = ok & torch.isfinite(rays).all(-1)
    if respect_anchors:
        vmask = vmask & (store.views[ids.clamp(0, m - 1)] == 0)
    new_rays = set_rows_drop(store.rays, torch.where(vmask, ids, m), rays)
    if frame_idx is None:
        return store._replace(rays=new_rays)
    stamp = torch.as_tensor(frame_idx, dtype=torch.int32, device=rays.device)
    seen = set_rows_drop(store.last_seen, torch.where(ok, ids, m), stamp)
    return store._replace(rays=new_rays, last_seen=seen)


def cull_rays(store: RayStore, protected_ids, frame_idx, max_age: int) -> RayStore:
    """Retire dead map rays: views == 0, not held by an EKF slot, and unseen
    for more than ``max_age`` frames."""
    m = store.rays.shape[0]
    in_ekf = mark_ids(protected_ids, m)
    stale = (frame_idx - store.last_seen) > max_age
    drop = store.valid & (store.views <= 0) & ~in_ekf & stale
    return store._replace(
        valid=store.valid & ~drop,
        count=store.count - drop.sum().to(torch.int32),
    )


def merge_rays(
    store: RayStore, angle_tol: float, desc_min: float, protected_ids=None
) -> tuple[RayStore, torch.Tensor]:
    """Merge duplicate landmarks: live rays within ``angle_tol`` whose
    descriptors agree (cosine >= ``desc_min``) collapse into the
    lower-indexed ray, in a single canonical pass (only into roots).
    Protected rays may absorb others but are never merged away.

    Returns (store, remap): remap (M,) int32 old id -> surviving id.
    """
    m = store.rays.shape[0]
    dev = store.rays.device
    idx = torch.arange(m, dtype=torch.int32, device=dev)
    live2 = store.valid[:, None] & store.valid[None, :]
    if protected_ids is not None:
        live2 = live2 & ~mark_ids(protected_ids, m)[None, :]  # protected can't be children
    r0, r1 = store.rays[:, 0], store.rays[:, 1]
    d_ang2 = (r0[:, None] - r0[None, :]) ** 2 + (r1[:, None] - r1[None, :]) ** 2
    cos = store.desc @ store.desc.T
    mergeable = (
        live2
        & (d_ang2 < angle_tol * angle_tol)
        & (cos >= desc_min)
        & (idx[:, None] < idx[None, :])      # partner strictly below
    )
    # smallest-index mergeable partner per ray (self if none)
    partner = torch.where(
        mergeable.any(0), torch.argmax(mergeable.to(torch.uint8), dim=0).to(torch.int32), idx
    )
    is_root = partner == idx
    target = torch.where(is_root[partner], partner, idx)  # only merge into roots
    merged = target != idx

    tgt = target.long()
    views = torch.zeros(m, dtype=torch.int32, device=dev).index_add_(
        0, tgt, torch.where(store.valid, store.views, 0)
    )
    seen = torch.maximum(
        store.last_seen,
        torch.zeros(m, dtype=torch.int32, device=dev).scatter_reduce_(
            0, tgt, torch.where(merged, store.last_seen, 0), "amax"
        ),
    )
    keep = store.valid & ~merged
    new = store._replace(
        valid=keep,
        views=torch.where(keep, views, 0),
        count=store.count - (store.valid & merged).sum().to(torch.int32),
        last_seen=seen,
    )
    return new, target


def add_keyframe(
    store: KeyframeStore, pose, frame_idx, xy, desc, ray_ids, feat_valid,
    width: float | None = None, height: float | None = None,
) -> tuple[KeyframeStore, torch.Tensor]:
    """Insert a keyframe; at capacity, evict the most REDUNDANT one (its max
    view overlap with any other keyframe); slot 0 (the BA gauge anchor) is
    never evicted. Without ``width``/``height`` an insert at capacity is
    dropped.

    Returns (store, evicted_slot): the replaced row, or -1.
    """
    k = store.poses.shape[0]
    dev = store.poses.device
    at_cap = store.count >= k
    fill = torch.clamp(store.count, max=k - 1)
    if width is None:
        tgt = torch.where(at_cap, k, fill)
        evicted = torch.tensor(-1, dtype=torch.int32, device=dev)
    else:
        ov = view_overlap(store.poses[:, None, :], store.poses[None, :, :], width, height)
        both = store.valid[:, None] & store.valid[None, :]
        off_diag = ~torch.eye(k, dtype=torch.bool, device=dev)
        redundancy = torch.where(both & off_diag, ov, -1.0).amax(1)
        anchor = torch.arange(k, device=dev) == 0
        redundancy = torch.where(anchor, -float("inf"), redundancy)   # keep the anchor
        evict_slot = torch.argmax(redundancy).to(torch.int32)
        tgt = torch.where(at_cap, evict_slot, fill)
        evicted = torch.where(at_cap, evict_slot, -1).to(torch.int32)
    # one-row write as a select: tgt == k matches no row (the insert drops)
    row = torch.arange(k, device=dev) == tgt
    new = KeyframeStore(
        poses=torch.where(row[:, None], pose[None, :], store.poses),
        frame_idx=torch.where(
            row, torch.as_tensor(frame_idx, dtype=torch.int32, device=dev), store.frame_idx
        ),
        valid=store.valid | row,
        xy=torch.where(row[:, None, None], xy[None], store.xy),
        desc=torch.where(row[:, None, None], desc[None], store.desc),
        ray_ids=torch.where(row[:, None], ray_ids[None].to(torch.int32), store.ray_ids),
        feat_valid=torch.where(row[:, None], feat_valid[None], store.feat_valid),
        count=torch.clamp(store.count + 1, max=k),
    )
    return new, evicted


def view_overlap(pose_a, pose_b, width: float, height: float) -> torch.Tensor:
    """Angular view overlap in [0, 1] between PTZ poses: product of the
    horizontal and vertical interval overlaps, relative to the narrower
    view."""

    def interval_overlap(c1, h1, c2, h2):
        lo = torch.maximum(c1 - h1, c2 - h2)
        hi = torch.minimum(c1 + h1, c2 + h2)
        inter = (hi - lo).clamp_min(0.0)
        return inter / (2 * torch.minimum(h1, h2)).clamp_min(1e-9)

    fa, fb = pose_a[..., 2], pose_b[..., 2]
    ha = torch.atan2(torch.full_like(fa, width / 2), fa)
    hb = torch.atan2(torch.full_like(fb, width / 2), fb)
    va = torch.atan2(torch.full_like(fa, height / 2), fa)
    vb = torch.atan2(torch.full_like(fb, height / 2), fb)
    h_ov = interval_overlap(pose_a[..., 0], ha, pose_b[..., 0], hb)
    v_ov = interval_overlap(pose_a[..., 1], va, pose_b[..., 1], vb)
    return h_ov * v_ov


def max_overlap_with_keyframes(store: KeyframeStore, pose, width: float, height: float):
    """Max view overlap of ``pose`` against all stored keyframes (0 if none)."""
    ov = view_overlap(store.poses, pose[None, :], width, height)
    return torch.where(store.valid, ov, 0.0).amax()


def min_zoom_departure(store: KeyframeStore, pose) -> torch.Tensor:
    """Smallest focal ratio (>= 1) between ``pose`` and any stored keyframe;
    +inf with no valid keyframe."""
    f = pose[2].clamp_min(1e-6)
    fk = store.poses[:, 2].clamp_min(1e-6)
    ratio = torch.maximum(f / fk, fk / f)
    return torch.where(store.valid, ratio, float("inf")).amin()


def build_ba_problem(
    kf: KeyframeStore, rays: RayStore, max_views_per_ray: int, anchor_first: bool = True
) -> BAProblem:
    """Assemble the ray-major BA problem from the keyframe observation
    tables: flatten all observations, stable-sort by ray id, rank each
    within its ray, and write the first ``max_views_per_ray`` ranks into the
    (M, C) table."""
    k, f = kf.ray_ids.shape
    m = rays.rays.shape[0]
    c = max_views_per_ray
    dev = kf.poses.device

    flat_ids = torch.where(
        kf.feat_valid & (kf.ray_ids >= 0) & kf.valid[:, None], kf.ray_ids, m
    ).reshape(-1)
    flat_cam = torch.arange(k, dtype=torch.int32, device=dev)[:, None].expand(k, f).reshape(-1)
    flat_xy = kf.xy.reshape(-1, 2)

    order = torch.argsort(flat_ids, stable=True)          # jnp.argsort is stable
    s_ids = flat_ids[order].contiguous()
    first = torch.searchsorted(s_ids, s_ids, side="left")
    rank = torch.arange(s_ids.shape[0], device=dev) - first
    ok = (s_ids < m) & (rank < c)

    row = torch.where(ok, s_ids, m).long()
    col = torch.where(ok, rank, 0).long()

    def table(values, shape):
        buf = torch.zeros((m + 1, c, *shape), dtype=values.dtype, device=dev)
        buf.index_put_((row, col), values)
        return buf[:m]

    obs_pix = table(flat_xy[order], (2,))
    obs_cam = table(flat_cam[order], ())
    obs_w = table(torch.ones(row.shape, dtype=torch.float32, device=dev), ())

    cam_free = kf.valid.clone()
    if anchor_first:
        cam_free[0] = False
    return BAProblem(
        cams=kf.poses, rays=rays.rays, obs_pix=obs_pix, obs_cam=obs_cam, obs_w=obs_w,
        cam_free=cam_free,
    )


def apply_ba_result(
    kf: KeyframeStore, rays: RayStore, cams, new_rays, obs_w
) -> tuple[KeyframeStore, RayStore]:
    """Write BA-refined poses and rays back into the stores. Rays with no BA
    observation (row weight 0) and invalid keyframes keep their values."""
    observed = obs_w.sum(1) > 0
    return (
        kf._replace(poses=torch.where(kf.valid[:, None], cams, kf.poses)),
        rays._replace(rays=torch.where(observed[:, None], new_rays, rays.rays)),
    )
