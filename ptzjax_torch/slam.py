"""Online PTZ-SLAM loop: tracking, map growth, keyframes, relocalization and
windowed BA, from re-detected or KLT-tracked features; whole-map BA; the
apply step of an external (forest) relocalization. Port of
``ptzjax/slam.py``.

Per-frame flow: predict -> project active slots -> gated descriptor
re-match -> pan-tilt consensus -> joint EKF update -> slot lifecycle (retire,
back-project fresh keypoints into free slots, allocate global ray ids) ->
keyframe policy (insert + windowed BA) or, while lost, relocalization.

The reference selects branches with ``lax.cond`` inside one ``lax.scan``.
On the card the tracking loops (re-detect, KLT and features:
``run_segment_pixels``, ``run_segment_pixels_klt``, ``run_segment`` and
``step``) do the same: each frame is one launch of a CUDA graph whose
conditional nodes pick the branch on the device (``_graphs.py``: the track
step ``_track_step``, the insert ``_insert_step`` and the lost frame
``_relocalize_step``), and a call reads the device once, at its end. The
eager route (the CPU's, and the card's with ``PTZSlam(..., _graphs=False)``)
is a Python loop over frames in which each ``lax.cond`` is a Python ``if``
on a flag read from the device (see ``_frame_step``). All other decisions
stay on the device as selects. On the graph route the steps' stages are
stamped (``_trace.stamp``, which does nothing on the eager route).
"""

from __future__ import annotations

import weakref
from typing import Any, NamedTuple

import torch

from ptzjax_torch import _device, _trace
from ptzjax_torch import ba as balib
from ptzjax_torch import ekf as ekflib
from ptzjax_torch import mapstore
from ptzjax_torch import match as matchlib
from ptzjax_torch import reloc as reloclib
from ptzjax_torch.config import SLAMConfig
from ptzjax_torch.frontend import extract_features, track_features
from ptzjax_torch.geometry import Intrinsics, back_project_pixels, in_view_mask, project_rays


class SlamState(NamedTuple):
    """Full online state (everything fixed-capacity)."""

    ekf: ekflib.EKFState
    slot_desc: torch.Tensor       # (N, D) descriptor per EKF slot
    kf: mapstore.KeyframeStore
    rays: mapstore.RayStore
    lost: torch.Tensor            # () bool
    frame_idx: torch.Tensor       # () int32


class FrameInfo(NamedTuple):
    """Per-frame record. ``event``: 0 = tracked, 1 = relocalization
    attempted, 2 = skipped frame."""

    pose: torch.Tensor
    num_matches: torch.Tensor
    num_used: torch.Tensor
    innovation_rms: torch.Tensor
    lost: torch.Tensor
    num_active_slots: torch.Tensor
    max_kf_overlap: torch.Tensor
    event: torch.Tensor
    keyframe: torch.Tensor
    reloc_success: torch.Tensor


def _scalar(value, dtype, device) -> torch.Tensor:
    return torch.full((), value, dtype=dtype, device=device)


def _count(x: torch.Tensor) -> torch.Tensor:
    return x.sum().to(torch.int32)


class PTZSlam:
    """Host-side orchestrator of the per-frame pipeline.

    Typical use::

        slam = PTZSlam(cfg, intr)                  # on the card
        state = slam.init(xy0, desc0, valid0, pose0)
        state, infos = slam.run_segment_pixels(state, frames)

    Everything runs on ``device``: by default ``torch.device("cuda")``, and
    the constructor raises where there is no CUDA device (no CPU fallback);
    ``device="cpu"`` asks for the CPU. The entry points move their inputs,
    numpy arrays or tensors on any device, to it (``run_segment_pixels``
    one frame at a time).
    """

    def __init__(self, cfg: SLAMConfig, intr: Intrinsics, device=None, _graphs: bool = True):
        self.cfg = cfg
        self.intr = intr
        self.device = _device.resolve(device)
        # On the card the tracking loops (run_segment_pixels,
        # run_segment_pixels_klt, run_segment, step and so process) launch
        # one CUDA graph a frame, which picks the frame's branch on the
        # device (``_graphs.py``); ``_graphs=False`` asks for the eager
        # route there, for the card's parity checks and A/B timings.
        self._graphs = None
        if _graphs and self.device.type == "cuda":
            from ptzjax_torch._graphs import Runner

            self._graphs = Runner(self.device)
        # (weak reference to the ``lost`` tensor of the last state returned,
        # its value): the eager route's next call takes the previous call's
        # read instead of reading the flag again
        self._lost_seen: tuple[weakref.ref, bool] | None = None

    def _lost_of(self, state: SlamState) -> bool:
        """``state.lost`` on the host: known where ``state`` carries the flag
        of the last state this object returned (no step writes into a
        tensor), else read (one device sync)."""
        seen = self._lost_seen
        if seen is not None and seen[0]() is state.lost:
            return seen[1]
        return bool(state.lost)

    def _returned(self, state: SlamState, lost: bool) -> SlamState:
        self._lost_seen = (weakref.ref(state.lost), lost)
        return state

    def init(self, xy, desc, valid, pose0) -> SlamState:
        """First-frame bootstrap from a known pose. Resolves
        ``descriptor_f_ref = -1`` (AUTO) to the bootstrap pose's focal."""
        if self.cfg.descriptor_f_ref < 0:
            self.cfg = self.cfg.replace(descriptor_f_ref=float(pose0[2]))
        cfg = self.cfg
        dev = self.device
        xy, desc, valid = (torch.as_tensor(v, device=dev) for v in (xy, desc, valid))
        state = SlamState(
            ekf=ekflib.init_state(pose0, cfg, device=dev),
            slot_desc=torch.zeros((cfg.max_rays, cfg.kf_desc_dim), dtype=torch.float32, device=dev),
            kf=mapstore.init_keyframe_store(cfg, device=dev),
            rays=mapstore.init_ray_store(cfg, device=dev),
            lost=_scalar(False, torch.bool, dev),
            frame_idx=_scalar(0, torch.int32, dev),
        )
        return self._returned(_bootstrap(state, xy, desc, valid, cfg=cfg, intr=self.intr), False)

    def step(self, state: SlamState, xy, desc, valid) -> tuple[SlamState, FrameInfo]:
        """One frame from features. On the card the frame is one launch of
        the frame graph, as in ``run_segment``."""
        if self._graphs is not None:
            state, info, lost = self._graphs.step(state, xy, desc, valid, cfg=self.cfg, intr=self.intr)
        else:
            state, info, lost = _frame_step(
                state, xy, desc, valid, cfg=self.cfg, intr=self.intr, lost=self._lost_of(state)
            )
        return self._returned(state, lost), info

    def process(self, state: SlamState, xy, desc, valid) -> tuple[SlamState, dict[str, Any]]:
        """One frame from features (tensors or arrays) + its host info dict."""
        state, finfo = self.step(state, *(_device.to_device(v, self.device) for v in (xy, desc, valid)))
        return state, info_to_dict(finfo)

    def run_segment(
        self, state: SlamState, xy_seq, desc_seq, valid_seq, frame_ok=None
    ) -> tuple[SlamState, FrameInfo]:
        """A chunk of frames from features: xy (T, Q, 2), desc (T, Q, D),
        valid (T, Q). ``frame_ok`` (T,) marks real frames (a False frame
        passes the state through).

        On the card each frame is one launch of the frame graph
        (``_graphs.Runner``: the frame's features copied in; the track
        step, the insert and the relocalization picked on the device), and
        the call reads the device once, at its end. The results are bitwise
        the eager route's.

        Returns the final state and the FrameInfo fields stacked over T."""
        xy_seq, desc_seq, valid_seq = (_device.to_device(v, self.device) for v in (xy_seq, desc_seq, valid_seq))
        if self._graphs is not None:
            state, infos, lost = self._graphs.run_segment(
                state, xy_seq, desc_seq, valid_seq, frame_ok, cfg=self.cfg, intr=self.intr
            )
        else:
            state, infos, lost = _run_segment(
                state, xy_seq, desc_seq, valid_seq, frame_ok, cfg=self.cfg, intr=self.intr,
                lost=self._lost_of(state),
            )
        return self._returned(state, lost), infos

    def run_segment_pixels(
        self, state: SlamState, imgs, masks=None, frame_ok=None
    ) -> tuple[SlamState, FrameInfo]:
        """From-pixels chunk: frames (T, H, W) -> detect/describe -> SLAM step,
        frame by frame. ``imgs`` and ``masks`` (T, H, W) bool or None may be
        numpy arrays or tensors on any device: on the card's graph route the
        chunk moves to the device in one asynchronous copy at the start, on
        the eager route each frame when its turn comes. ``frame_ok`` (T,)
        marks real frames (a False frame passes the state through).

        On the card each frame is one launch of the frame graph
        (``_graphs.Runner``: the frontend and the track step, the insert
        and the relocalization picked on the device), and the call reads
        the device once, at its end. The results are bitwise the eager
        route's.

        Returns the final state and the FrameInfo fields stacked over T."""
        if self._graphs is not None:
            state, infos, lost = self._graphs.run_segment_pixels(
                state, imgs, masks, frame_ok, cfg=self.cfg, intr=self.intr
            )
        else:
            state, infos, lost = _run_segment_pixels(
                state, imgs, masks, frame_ok, cfg=self.cfg, intr=self.intr, device=self.device,
                lost=self._lost_of(state),
            )
        return self._returned(state, lost), infos

    def run_segment_pixels_klt(
        self, state: SlamState, imgs, prev_img, prev_xy, prev_valid, frame_ok=None, masks=None,
    ) -> tuple[SlamState, FrameInfo, torch.Tensor, torch.Tensor]:
        """KLT-mode from-pixels chunk: LK flow carries the keypoint table from
        frame to frame, fresh detections refill the dead rows. Seed the carry
        with the previous chunk's last frame and table (``prev_img``,
        ``prev_xy``, ``prev_valid``; for a first chunk, the ``init`` frame
        and its features). ``masks`` (T, H, W) bool restricts the refill
        detections; ``frame_ok`` (T,) marks real frames (a False frame passes
        the state and the carry through). Inputs move to the device as in
        ``run_segment_pixels``.

        On the card each frame is one launch of the frame graph
        (``_graphs.Runner``: the KLT frontend on the carry, the track step,
        the insert and the relocalization picked on the device, and the
        carry moved on), and the call reads the device once, at its end.
        The results are bitwise the eager route's.

        Returns (state, infos stacked over T, last_xy, last_valid): the
        table of the last real frame, to seed the next chunk."""
        if self._graphs is not None:
            state, infos, xy, valid, lost = self._graphs.run_segment_pixels_klt(
                state, imgs, frame_ok, prev_img, prev_xy, prev_valid, masks, cfg=self.cfg, intr=self.intr,
            )
        else:
            state, infos, xy, valid, lost = _run_segment_pixels_klt(
                state, imgs, frame_ok, prev_img, prev_xy, prev_valid, masks,
                cfg=self.cfg, intr=self.intr, device=self.device, lost=self._lost_of(state),
            )
        return self._returned(state, lost), infos, xy, valid

    def bundle_adjust(self, state: SlamState) -> tuple[SlamState, dict[str, Any]]:
        """BA over the whole map (all keyframes, robust when
        ``cfg.ba_huber_px > 0``), written back into the stores. The two costs
        are the one host read."""
        state, cost0, cost1 = _run_ba(state, cfg=self.cfg, intr=self.intr)
        return state, {"ba_cost_before": float(cost0), "ba_cost_after": float(cost1)}

    def apply_reloc_result(self, state: SlamState, xy, desc, valid, res) -> SlamState:
        """Apply a relocalization computed outside the loop (the forest path,
        ``reloc_forest.relocalize_rf``): on success, re-initialize the EKF
        around the recovered pose and seed slots by back-projecting the inlier
        keypoints; on failure, stay lost. The host decides when to call it,
        on a frame it already knows is lost; ``res.success`` is read once."""
        dev = self.device
        xy, desc, valid, pose, inl = (
            torch.as_tensor(v, device=dev) for v in (xy, desc, valid, res.pose, res.matched_ok)
        )
        success = bool(res.success)
        state = _apply_external_reloc(
            state, xy, desc, valid, pose, inl, success, cfg=self.cfg, intr=self.intr
        )
        return self._returned(state, False) if success else state


def _bootstrap(state: SlamState, xy, desc, valid, *, cfg, intr) -> SlamState:
    state, _ = _grow_map(state, xy, desc, valid, cfg=cfg, intr=intr)
    return _insert_keyframe(state, xy, desc, valid, cfg=cfg, intr=intr)


def _grow_map(
    state: SlamState, xy, desc, cand_mask, *, cfg, intr, dedupe=False,
    dedupe_tol=None, dedupe_desc_min=None,
):
    """Insert candidate keypoints as new EKF slots + global rays.

    With ``dedupe=True``, candidates whose back-projected ray lands within
    ``dedupe_tol`` of a live map ray with agreeing descriptor reuse that
    ray's id and value instead of allocating a duplicate.
    """
    new_rays = back_project_pixels(state.ekf.pose, xy, intr)
    q = xy.shape[0]
    dev = xy.device
    reuse_ids = torch.full((q,), -1, dtype=torch.int32, device=dev)
    if dedupe:
        tol = cfg.merge_angle_tol if dedupe_tol is None else dedupe_tol
        dmin = cfg.merge_desc_min if dedupe_desc_min is None else dedupe_desc_min
        store = state.rays
        mcap = store.rays.shape[0]
        d2 = (new_rays[:, None, 0] - store.rays[None, :, 0]) ** 2 + (
            new_rays[:, None, 1] - store.rays[None, :, 1]
        ) ** 2
        cos = desc @ store.desc.T
        # a ray held by an ACTIVE slot must not be re-claimed by a second slot
        act_ids = torch.where(state.ekf.active, state.ekf.ray_ids, -1)
        held = mapstore.mark_ids(act_ids, mcap)
        near_any = store.valid[None, :] & (d2 < tol**2) & (cos >= dmin)
        near = near_any & ~held[None, :]
        has = near.any(1)
        has_any = near_any.any(1)
        nearest = torch.argmin(torch.where(near, d2, float("inf")), dim=1).to(torch.int32)
        # one candidate per reused ray: the lowest-index claimant wins
        iota = torch.arange(q, dtype=torch.int32, device=dev)
        winner = torch.full((mcap + 1,), q, dtype=torch.int32, device=dev).scatter_reduce_(
            0, torch.where(cand_mask & has, nearest, mcap).long(), iota, "amin"
        )[:mcap]
        is_first = winner[nearest] == iota
        reuse_ids = torch.where(cand_mask & has & is_first, nearest, -1)
        # losers are still duplicates of an existing ray: no fresh allocation
        cand_mask = cand_mask & ~has_any
    # only allocate map rows for candidates that will claim a free EKF slot
    num_free = (~state.ekf.active).sum() - (reuse_ids >= 0).sum()
    cand_rank = torch.cumsum(cand_mask.to(torch.int64), 0) - 1
    cand_sel = cand_mask & (cand_rank < num_free)
    rays_store, ids = mapstore.add_rays(
        state.rays, new_rays, desc, cand_sel, frame_idx=state.frame_idx
    )
    ids = torch.where(reuse_ids >= 0, reuse_ids, ids)
    accept = ids >= 0
    ekf_state = ekflib.insert_rays(state.ekf, xy, accept, ids, intr, cfg)
    claim = ekflib.claim_slots(state.ekf.active, accept)
    if dedupe:
        # snap newly claimed slots to the MAP value (for fresh allocations
        # this equals the back-projection they were seeded with)
        snap = claim.newly & (ekf_state.ray_ids >= 0)
        ekf_state = ekf_state._replace(
            rays=torch.where(
                snap[:, None], rays_store.rays[ekf_state.ray_ids.clamp_min(0)], ekf_state.rays
            )
        )
    # record descriptors on the slots that were just claimed
    safe = claim.cand_of_slot.clamp(0, q - 1)
    slot_desc = torch.where(claim.newly[:, None], desc[safe], state.slot_desc)
    return state._replace(ekf=ekf_state, slot_desc=slot_desc, rays=rays_store), accept


def _track_frame(state: SlamState, xy, desc, valid, *, cfg, intr) -> tuple[SlamState, FrameInfo]:
    dev = xy.device
    # 1. predict
    ekf_state = ekflib.predict(state.ekf, cfg)
    pose = ekf_state.pose
    _trace.stamp("predict")

    # 2. project active slots to predicted pixels
    pred_pix = project_rays(pose, ekf_state.rays, intr)
    slot_visible = ekf_state.active & in_view_mask(
        pose, ekf_state.rays, intr, cfg.image_width, cfg.image_height,
        margin=cfg.innovation_gate_px,
    )

    # 3. gated re-match
    m = matchlib.match_gated(
        desc, xy, state.slot_desc, pred_pix, valid, slot_visible,
        gate_px=cfg.track_gate_px, ratio=cfg.track_ratio,
    )
    if cfg.track_consensus:
        # pan-tilt consensus pre-gate, applied only when the winner is a
        # clear majority of the matches
        px = cfg.track_consensus_px if cfg.track_consensus_px > 0 else 3.0 * cfg.sigma_obs + 5.0
        inl, best_count = matchlib.consensus_pan_tilt(
            ekf_state.rays[m.idx], xy, m.ok, pose[2], intr.cx, intr.cy,
            inlier_px=px, score=m.score,
        )
        dominant = best_count * 2 >= m.ok.sum()
        matched_any = m.ok  # pre-consensus: still a SLOT's observation
        m = m._replace(ok=torch.where(dominant, inl, m.ok))
        # consensus rejection is wrong-motion evidence
        consensus_rej = matched_any & ~m.ok
    else:
        matched_any = m.ok
        consensus_rej = torch.zeros_like(m.ok)
    obs, obs_mask = matchlib.scatter_to_slots(m, xy, ekf_state.capacity)
    _trace.stamp("association")

    # 4. joint EKF update + slot lifecycle (count CONSECUTIVE consensus
    # rejections per slot; retire at cfg.max_rejected)
    ekf_state, stats = ekflib.update(ekf_state, obs, obs_mask, intr, cfg)
    n = ekf_state.capacity
    slot_iota = torch.arange(n, dtype=torch.int32, device=dev)
    rejected = (
        torch.where(consensus_rej, m.idx, n)[None, :] == slot_iota[:, None]
    ).any(1) & ekf_state.active
    ekf_state = ekf_state._replace(rej=torch.where(rejected, ekf_state.rej + 1, 0))
    ekf_state = ekflib.retire_lost(ekf_state, cfg)
    state = state._replace(ekf=ekf_state)
    _trace.stamp("update")

    # refresh slot descriptors from gate-confirmed observations
    tgt = torch.where(m.ok, m.idx, n)
    onehot = tgt[None, :] == slot_iota[:, None]           # (N, Q), unique/slot
    cand_of_slot = torch.argmax(onehot.to(torch.uint8), dim=1)
    refresh = stats.used_mask & onehot.any(1)
    slot_desc = torch.where(refresh[:, None], desc[cand_of_slot], state.slot_desc)
    state = state._replace(slot_desc=slot_desc)

    # refresh global ray estimates from the filter, only for gate-confirmed
    # slots and never on a lost frame
    state = state._replace(
        rays=mapstore.update_rays(
            state.rays, ekf_state.ray_ids, ekf_state.rays,
            ekf_state.active & stats.used_mask & ~stats.lost,
            frame_idx=state.frame_idx, respect_anchors=cfg.map_anchor,
        )
    )
    # cull dead rays every frame
    state = state._replace(
        rays=mapstore.cull_rays(state.rays, ekf_state.ray_ids, state.frame_idx, cfg.ray_cull_age)
    )

    # 5. grow: unmatched fresh keypoints become new rays (only when healthy)
    fresh = valid & ~matched_any & ~stats.lost
    state, _ = _grow_map(
        state, xy, desc, fresh, cfg=cfg, intr=intr, dedupe=cfg.map_anchor,
        dedupe_tol=cfg.anchor_snap_tol, dedupe_desc_min=cfg.anchor_snap_desc_min,
    )

    max_ov = mapstore.max_overlap_with_keyframes(state.kf, pose, cfg.image_width, cfg.image_height)
    _trace.stamp("map")
    state = state._replace(lost=stats.lost, frame_idx=state.frame_idx + 1)
    info = FrameInfo(
        pose=state.ekf.pose,
        num_matches=_count(m.ok),
        num_used=stats.num_used.to(torch.int32),
        innovation_rms=stats.innovation_rms,
        lost=stats.lost,
        num_active_slots=_count(state.ekf.active),
        max_kf_overlap=max_ov,
        event=_scalar(0, torch.int32, dev),
        keyframe=_scalar(False, torch.bool, dev),
        reloc_success=_scalar(False, torch.bool, dev),
    )
    return state, info


def _insert_keyframe(state: SlamState, xy, desc, valid, *, cfg, intr) -> SlamState:
    """Store the current frame as a keyframe (features + their ray ids from a
    tightly gated match against the slots), adjust ray view counts for an
    evicted keyframe, cull dead rays, merge duplicates and remap every
    ray-id table."""
    pred_pix = project_rays(state.ekf.pose, state.ekf.rays, intr)
    m = matchlib.match_gated(
        desc, xy, state.slot_desc, pred_pix, valid, state.ekf.active,
        gate_px=cfg.kf_gate_sigma * cfg.sigma_obs + cfg.kf_gate_base_px,
        ratio=cfg.kf_ratio,
    )
    ray_ids = torch.where(m.ok, state.ekf.ray_ids[m.idx], -1)
    feat_valid = valid & m.ok & (ray_ids >= 0)
    kf, evicted = mapstore.add_keyframe(
        state.kf, state.ekf.pose, state.frame_idx, xy, desc, ray_ids,
        feat_valid, width=cfg.image_width, height=cfg.image_height,
    )
    mcap = state.rays.views.shape[0]
    # the evicted keyframe's observations no longer pin their rays
    ev = evicted.clamp(0, state.kf.ray_ids.shape[0] - 1).view(1)   # (1,): no host read
    ev_ids = state.kf.ray_ids[ev][0]
    ev_fv = state.kf.feat_valid[ev][0] & (evicted >= 0)
    views = mapstore.add_rows_drop(state.rays.views, torch.where(ev_fv, ev_ids, mcap), -1)
    views = mapstore.add_rows_drop(views, torch.where(feat_valid, ray_ids, mcap), 1)
    rays = state.rays._replace(views=views)
    _trace.stamp("keyframe")

    rays = mapstore.cull_rays(rays, state.ekf.ray_ids, state.frame_idx, cfg.ray_cull_age)
    rays, remap = mapstore.merge_rays(
        rays, cfg.merge_angle_tol, cfg.merge_desc_min, protected_ids=state.ekf.ray_ids
    )
    kf_ids = torch.where(kf.ray_ids >= 0, remap[kf.ray_ids.clamp(0, mcap - 1)], -1)
    ekf_ids = torch.where(
        state.ekf.ray_ids >= 0, remap[state.ekf.ray_ids.clamp(0, mcap - 1)], -1
    )
    _trace.stamp("merge")
    return state._replace(
        kf=kf._replace(ray_ids=kf_ids), rays=rays, ekf=state.ekf._replace(ray_ids=ekf_ids)
    )


def _reloc_match(state: SlamState, xy, desc, valid, *, cfg, intr) -> reloclib.RelocResult:
    """The lost branch up to its success flag, with no host read: the match
    and the pose solve. ``cfg.reloc_mode`` selects the backend: "map"
    matches the global ray store, "keyframe" does the nearest-keyframe
    lookup."""
    if cfg.reloc_mode == "keyframe":
        return reloclib.relocalize_keyframes(desc, xy, valid, state.kf, state.rays, intr, cfg)
    return reloclib.relocalize(desc, xy, valid, state.rays, intr, cfg)


def _stay_lost(state: SlamState) -> SlamState:
    """The lost branch on failure: the state passes, a frame on."""
    return state._replace(frame_idx=state.frame_idx + 1)


def _reseed(kept: SlamState, xy, desc, res: reloclib.RelocResult, *, cfg, intr) -> SlamState:
    """The lost branch on success, from the stay-lost step's state ``kept``:
    the EKF rebuilt around the recovered pose with the inlier rays at their
    map positions, and the flag cleared."""
    dev = xy.device
    ekf_state = ekflib.init_state(res.pose, cfg)
    # seed slots with the reloc inlier rays at their map positions
    ids = torch.where(res.matched_ok, res.matched_ray_ids, -1)
    ekf_state = ekflib.insert_rays(ekf_state, xy, res.matched_ok, ids, intr, cfg)
    n = ekf_state.capacity
    slot_ray = torch.where(
        (ekf_state.ray_ids >= 0)[:, None],
        kept.rays.rays[ekf_state.ray_ids.clamp_min(0)],
        ekf_state.rays,
    )
    ekf_state = ekf_state._replace(rays=slot_ray)
    # all slots were free pre-insert: the same claim insert_rays used
    claim = ekflib.claim_slots(torch.zeros(n, dtype=torch.bool, device=dev), res.matched_ok)
    safe = claim.cand_of_slot.clamp(0, desc.shape[0] - 1)
    slot_desc = torch.where(claim.newly[:, None], desc[safe], 0.0)
    return kept._replace(ekf=ekf_state, slot_desc=slot_desc, lost=_scalar(False, torch.bool, dev))


def _reloc_info(new_state: SlamState, res: reloclib.RelocResult) -> FrameInfo:
    dev = res.pose.device
    return FrameInfo(
        pose=new_state.ekf.pose,
        num_matches=res.inliers.to(torch.int32),
        num_used=res.inliers.to(torch.int32),
        innovation_rms=_scalar(0.0, torch.float32, dev),
        lost=~res.success,
        num_active_slots=_count(new_state.ekf.active),
        max_kf_overlap=_scalar(1.0, torch.float32, dev),
        event=_scalar(1, torch.int32, dev),
        keyframe=_scalar(False, torch.bool, dev),
        reloc_success=res.success,
    )


def _relocalize(state: SlamState, xy, desc, valid, *, cfg, intr):
    """Recover from lost tracking (``_reloc_match``), then rebuild the EKF
    around the recovered pose with the inlier rays (``_reseed``) or stay
    lost (``_stay_lost``): one host read of the success flag. Returns
    (state, info, success as a host bool)."""
    res = _reloc_match(state, xy, desc, valid, cfg=cfg, intr=intr)
    success = bool(res.success)
    new_state = _stay_lost(state)
    if success:
        new_state = _reseed(new_state, xy, desc, res, cfg=cfg, intr=intr)
    return new_state, _reloc_info(new_state, res), success


def _select(cond: torch.Tensor, a, b):
    """``a`` where ``cond``, else ``b``, leaf by leaf over nested
    NamedTuples of tensors; a leaf that both share passes as it is."""
    if isinstance(a, tuple):
        return type(a)(*(_select(cond, x, y) for x, y in zip(a, b)))
    return a if a is b else torch.where(cond, a, b)


def _relocalize_step(state: SlamState, xy, desc, valid, *, cfg, intr):
    """``_relocalize`` with no host read: both of its branches, the re-seed
    and the stay-lost step, selected on the device by the success flag
    (selects of values both branches computed: bitwise ``_relocalize``).
    On the card ``_graphs`` captures it, with the frame's frontend, as the
    frame graph's lost branch. Returns (state, info, success as a () bool
    tensor)."""
    res = _reloc_match(state, xy, desc, valid, cfg=cfg, intr=intr)
    kept = _stay_lost(state)
    new_state = _select(res.success, _reseed(kept, xy, desc, res, cfg=cfg, intr=intr), kept)
    return new_state, _reloc_info(new_state, res), res.success


def _apply_external_reloc(
    state: SlamState, xy, desc, valid, pose, inlier_mask, success: bool, *, cfg, intr
) -> SlamState:
    """Re-init around an externally recovered pose (forest path): fresh EKF
    at ``pose``, inlier keypoints back-projected into new slots + map rays.
    The map/keyframe stores survive (they are the long-term memory). The
    reference's ``lax.cond`` on ``success`` is a host branch here."""
    if not success:
        return state._replace(frame_idx=state.frame_idx + 1)
    st = state._replace(
        ekf=ekflib.init_state(pose, cfg),
        slot_desc=torch.zeros_like(state.slot_desc),
        lost=_scalar(False, torch.bool, xy.device),
        frame_idx=state.frame_idx + 1,
    )
    # dedupe: repeated forest relocalizations must reuse the map rays they
    # re-observe, not append clones until the store exhausts
    st, _ = _grow_map(st, xy, desc, valid & inlier_mask, cfg=cfg, intr=intr, dedupe=True)
    return st


def _windowed_ba(state: SlamState, *, cfg, intr) -> SlamState:
    """Local BA over the newest ``online_ba_window`` keyframes. The oldest
    in-window keyframe is the frozen gauge; the refined newest pose re-seeds
    the EKF camera only when it disagrees beyond the filter's 3 sigma (and
    then inflates the pose covariance); a gross disagreement trips the drift
    watchdog (declare LOST)."""
    kf = state.kf
    k = kf.poses.shape[0]
    w = min(cfg.online_ba_window, k)
    dev = kf.poses.device

    # newest w keyframes by frame index (the fresh insert ranks first)
    order_key = torch.where(kf.valid, kf.frame_idx, -1)
    top_idx = matchlib.stable_topk_indices(order_key, w)
    sel_valid = kf.valid[top_idx]
    sub = mapstore.KeyframeStore(
        poses=kf.poses[top_idx],
        frame_idx=kf.frame_idx[top_idx],
        valid=sel_valid,
        xy=kf.xy[top_idx],
        desc=kf.desc[top_idx],
        ray_ids=kf.ray_ids[top_idx],
        feat_valid=kf.feat_valid[top_idx] & sel_valid[:, None],
        count=_count(sel_valid),
    )
    prob = mapstore.build_ba_problem(
        sub, state.rays, max_views_per_ray=cfg.online_ba_views, anchor_first=False
    )
    # gauge: freeze the OLDEST VALID in-window keyframe (row n_valid - 1)
    oldest = (sel_valid.sum() - 1).clamp_min(0)
    cam_free = sel_valid & (torch.arange(w, device=dev) != oldest)
    prob = prob._replace(cam_free=cam_free)
    res = balib.run(prob, intr, cfg.replace(ba_iters=cfg.online_ba_iters))

    new_poses = mapstore.set_rows_drop(kf.poses, torch.where(sel_valid, top_idx, k), res.cams)
    # only trust rays the window constrains (>= 2 views)
    constrained = prob.obs_w.sum(1) >= 2
    new_rays = torch.where(constrained[:, None], res.rays, state.rays.rays)

    # covariance-gated drift correction
    ekf = state.ekf
    delta = res.cams[0] - ekf.pose
    p_diag = torch.diagonal(ekf.cov)[0:3].clamp_min(1e-8)
    drifted = (delta * delta > 9.0 * p_diag).any() & torch.isfinite(res.cams[0]).all()
    cam = torch.where(drifted, torch.cat([res.cams[0], ekf.cam[3:6]]), ekf.cam)
    d_state = 6 + 2 * ekf.capacity
    pose_rows = torch.arange(d_state, device=dev) < 3
    prior = torch.cat(
        [_device.const((1e-5, 1e-5, 25.0), dev), torch.zeros(d_state - 3, dtype=torch.float32, device=dev)]
    )
    cov_inflated = torch.where(pose_rows[:, None] | pose_rows[None, :], 0.0, ekf.cov) + torch.diag(prior)
    cov = torch.where(drifted, cov_inflated, ekf.cov)
    # drift watchdog: a disagreement beyond hard absolute bounds means the
    # ray field is corrupted; declare LOST so relocalization re-initializes
    watchdog = drifted & (
        (delta[2].abs() > 30.0) | (delta[0].abs() > 5e-3) | (delta[1].abs() > 5e-3)
    )
    return state._replace(
        kf=kf._replace(poses=new_poses),
        rays=state.rays._replace(rays=new_rays),
        ekf=ekf._replace(cam=cam, cov=cov),
        lost=state.lost | watchdog,
    )


def _track_step(state: SlamState, xy, desc, valid, *, cfg, intr):
    """The device part of a tracked frame, with no host read: ``_track_frame``
    and the keyframe policy's predicates (overlap, zoom, cadence) -- the
    reference's ``do_track`` branch up to its insert ``lax.cond``
    (``ptzjax/slam.py:_frame_step``). On the card ``_graphs`` captures it,
    with the frame's frontend (none in features mode), as the frame graph's
    track branch.

    Returns (state, info with ``keyframe`` = the insert predicate, flags):
    ``flags`` is one (2,) bool tensor, (lost, insert): what the eager route
    reads of the frame, and what the frame graph's insert conditions are
    made from."""
    s2, info = _track_frame(state, xy, desc, valid, cfg=cfg, intr=intr)
    healthy = ~info.lost
    insert = healthy & (info.max_kf_overlap < cfg.keyframe_overlap)
    if cfg.keyframe_zoom_ratio > 1.0:
        # zoom half of the pan/zoom criterion
        insert = insert | (
            healthy & (mapstore.min_zoom_departure(s2.kf, s2.ekf.pose) > cfg.keyframe_zoom_ratio)
        )
    if cfg.keyframe_interval > 0:
        # temporal cadence: never run more than keyframe_interval frames
        # without an insert
        last_kf = torch.where(s2.kf.valid, s2.kf.frame_idx, -1).amax()
        insert = insert | (healthy & ((s2.frame_idx - last_kf) >= cfg.keyframe_interval))
    return s2, info._replace(keyframe=insert), torch.stack([info.lost, insert])


def _ba_follows(state: SlamState, cfg) -> torch.Tensor:
    """() bool: whether the windowed BA follows an insert into ``state``'s
    keyframe store -- ``_keyframe``'s ``kf.count >= 2``, known before the
    insert, which makes the count ``min(count + 1, max_keyframes)``: >= 2
    where the store has two rows and holds a keyframe already."""
    if cfg.online_ba_iters > 0 and state.kf.poses.shape[0] >= 2:
        return state.kf.count >= 1
    return torch.zeros_like(state.kf.count, dtype=torch.bool)


def _insert_step(state: SlamState, xy, desc, valid, *, cfg, intr, ba: bool) -> SlamState:
    """The insert branch for one value of its BA predicate (``ba``, from
    ``_ba_follows``), with no host read: ``_insert_keyframe``, then
    ``_windowed_ba`` where ``ba``. On the card ``_graphs`` captures it as
    the frame graph's insert branch, one for each value of ``ba``."""
    state = _insert_keyframe(state, xy, desc, valid, cfg=cfg, intr=intr)
    if ba:
        state = _windowed_ba(state, cfg=cfg, intr=intr)
        _trace.stamp("ba")
    return state


def _keyframe(state: SlamState, xy, desc, valid, *, cfg, intr) -> tuple[SlamState, bool]:
    """The insert branch: ``_insert_keyframe`` and, with >= 2 keyframes, the
    windowed BA (``_insert_step`` with its predicate read). Returns the
    state and its lost flag as a host bool (the BA's drift watchdog may set
    it). Host reads: ``kf.count >= 2``, and the lost flag after the BA."""
    state = _insert_keyframe(state, xy, desc, valid, cfg=cfg, intr=intr)
    # local BA needs >= 2 keyframes for a meaningful system
    if cfg.online_ba_iters > 0 and bool(state.kf.count >= 2):
        state = _windowed_ba(state, cfg=cfg, intr=intr)
        return state, bool(state.lost)
    return state, False


def _frame_step(state: SlamState, xy, desc, valid, *, cfg, intr, lost: bool):
    """One frame: relocalize while lost, else track and apply the keyframe
    policy (insert + windowed BA).

    ``lost`` is ``state.lost`` as a host bool, which the caller carries from
    the frame before. Returns (state, info, the new state's lost flag as a
    host bool). Host reads (each a device sync): the (lost, insert) flags of
    a tracked frame, once; ``_keyframe``'s two on an insert; the
    relocalization's success flag on a lost frame.

    The split points, where the reference's ``lax.cond``s are, each a
    function with no host read that ``_graphs`` captures: ``_track_step``
    (the tracked frame up to its insert predicate), ``_insert_step`` (the
    insert branch for a value of ``_ba_follows``) and ``_relocalize_step``
    (the lost branch, ``_reloc_match`` then ``_reseed`` or ``_stay_lost``
    selected on the device)."""
    if lost:
        state, info, success = _relocalize(state, xy, desc, valid, cfg=cfg, intr=intr)
        return state, info, not success
    s2, info, flags = _track_step(state, xy, desc, valid, cfg=cfg, intr=intr)
    lost, insert = flags.tolist()
    if insert:
        s2, lost = _keyframe(s2, xy, desc, valid, cfg=cfg, intr=intr)
    return s2, info, lost


def _skip_info(s: SlamState) -> FrameInfo:
    dev = s.ekf.cam.device
    return FrameInfo(
        pose=s.ekf.pose,
        num_matches=_scalar(0, torch.int32, dev),
        num_used=_scalar(0, torch.int32, dev),
        innovation_rms=_scalar(0.0, torch.float32, dev),
        lost=s.lost,
        num_active_slots=_count(s.ekf.active),
        max_kf_overlap=_scalar(1.0, torch.float32, dev),
        event=_scalar(2, torch.int32, dev),  # 2 = padding no-op
        keyframe=_scalar(False, torch.bool, dev),
        reloc_success=_scalar(False, torch.bool, dev),
    )


def _frame_flags(frame_ok, t: int) -> list[bool]:
    """``frame_ok`` as host booleans (one read), all True when None."""
    return [True] * t if frame_ok is None else [bool(v) for v in torch.as_tensor(frame_ok).tolist()]


def _stack(infos: list[FrameInfo]) -> FrameInfo:
    return FrameInfo(*(torch.stack(list(field)) for field in zip(*infos)))


def _run_segment(state: SlamState, xy_seq, desc_seq, valid_seq, frame_ok, *, cfg, intr, lost: bool):
    """Features -> SLAM step, frame by frame; a False ``frame_ok`` frame is a
    no-op. The eager route (the CPU's, and the card's where ``PTZSlam(...,
    _graphs=False)`` asks for it). ``lost`` is ``state.lost`` on the host;
    returns (state, stacked infos, the final state's lost flag)."""
    infos = []
    for i, ok in enumerate(_frame_flags(frame_ok, xy_seq.shape[0])):
        if ok:
            state, info, lost = _frame_step(
                state, xy_seq[i], desc_seq[i], valid_seq[i], cfg=cfg, intr=intr, lost=lost
            )
        else:
            info = _skip_info(state)
        infos.append(info)
    return state, _stack(infos), lost


def _run_segment_pixels(state: SlamState, imgs, masks, frame_ok, *, cfg, intr, device, lost: bool):
    """Raw frames -> features -> SLAM step, frame by frame, each frame (and
    mask) moved to ``device`` in its turn: the eager route (the CPU's, and
    the card's where ``PTZSlam(..., _graphs=False)`` asks for it). The
    descriptor scale uses the LIVE focal estimate, sanitized: a non-finite
    or non-positive focal falls back to the bootstrap f_ref. ``lost`` as in
    ``_run_segment``."""
    t = imgs.shape[0]
    ok = _frame_flags(frame_ok, t)
    infos = []
    for i in range(t):
        if not ok[i]:
            infos.append(_skip_info(state))
            continue
        mask = None if masks is None else torch.as_tensor(masks[i], device=device)
        xy, desc, valid = extract_features(
            torch.as_tensor(imgs[i], device=device), cfg, mask=mask, focal=_safe_focal(state, cfg)
        )
        state, info, lost = _frame_step(state, xy, desc, valid, cfg=cfg, intr=intr, lost=lost)
        infos.append(info)
    return state, _stack(infos), lost


def _safe_focal(state: SlamState, cfg) -> torch.Tensor:
    """The live focal estimate for descriptor scaling, sanitized: a
    non-finite or non-positive focal falls back to the bootstrap f_ref."""
    f_ref = cfg.descriptor_f_ref if cfg.descriptor_f_ref > 0 else 1000.0
    f_est = state.ekf.pose[2]
    return torch.where(torch.isfinite(f_est) & (f_est > 1.0), f_est, f_ref)


def _run_segment_pixels_klt(
    state: SlamState, imgs, frame_ok, prev_img, prev_xy, prev_valid, masks, *, cfg, intr, device,
    lost: bool,
):
    """KLT mode, frame by frame: the previous frame and keypoint table ride
    the carry; ``track_features`` moves the table, refills it and describes
    it; a False ``frame_ok`` frame passes state and carry through. The
    eager route (the CPU's, and the card's where ``PTZSlam(...,
    _graphs=False)`` asks for it). ``lost`` as in ``_run_segment``."""
    ok = _frame_flags(frame_ok, imgs.shape[0])
    pimg, pxy, pvalid = (torch.as_tensor(v, device=device) for v in (prev_img, prev_xy, prev_valid))
    infos = []
    for i in range(len(ok)):
        if not ok[i]:
            infos.append(_skip_info(state))
            continue
        img = torch.as_tensor(imgs[i], device=device)
        mask = None if masks is None else torch.as_tensor(masks[i], device=device)
        xy, desc, valid, _ = track_features(
            pimg, img, pxy, pvalid, cfg, mask=mask, focal=_safe_focal(state, cfg)
        )
        state, info, lost = _frame_step(state, xy, desc, valid, cfg=cfg, intr=intr, lost=lost)
        infos.append(info)
        pimg, pxy, pvalid = img, xy, valid
    return state, _stack(infos), pxy, pvalid, lost


def _run_ba(state: SlamState, *, cfg, intr):
    """Whole-map BA: every keyframe, the first one frozen as the gauge;
    Huber IRLS when ``cfg.ba_huber_px > 0``. Returns (state, initial cost,
    final cost)."""
    prob = mapstore.build_ba_problem(state.kf, state.rays, max_views_per_ray=cfg.ba_max_views_per_ray)
    if cfg.ba_huber_px > 0:
        res = balib.run_robust(prob, intr, cfg)
    else:
        res = balib.run(prob, intr, cfg)
    kf, rays = mapstore.apply_ba_result(state.kf, state.rays, res.cams, res.rays, prob.obs_w)
    return state._replace(kf=kf, rays=rays), res.initial_cost, res.cost


def _info_dict(h: FrameInfo, k: int | None) -> dict[str, Any]:
    at = (lambda v: v) if k is None else (lambda v: v[k])
    return {
        "event": "track" if int(at(h.event)) == 0 else "reloc",
        "pose": at(h.pose),
        "num_matches": int(at(h.num_matches)),
        "num_used": int(at(h.num_used)),
        "innovation_rms": float(at(h.innovation_rms)),
        "lost": bool(at(h.lost)),
        "active_slots": int(at(h.num_active_slots)),
        "max_kf_overlap": float(at(h.max_kf_overlap)),
        "keyframe": bool(at(h.keyframe)),
        "reloc_success": bool(at(h.reloc_success)),
        "reloc_inliers": int(at(h.num_used)),
    }


def info_to_dict(finfo: FrameInfo) -> dict[str, Any]:
    """One frame's FrameInfo as a host dict."""
    return _info_dict(FrameInfo(*(v.cpu().numpy() for v in finfo)), None)


def infos_to_dicts(infos: FrameInfo, frame0: int = 1) -> list[dict[str, Any]]:
    """Stacked FrameInfo -> per-frame host dicts."""
    h = FrameInfo(*(v.cpu().numpy() for v in infos))
    return [{"frame": frame0 + k, **_info_dict(h, k)} for k in range(len(h.pose))]
