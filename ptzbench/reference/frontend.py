"""Image frontend: raw frames -> fixed-capacity features. Port of
``ptzjax/frontend.py``: the re-detect step (Harris detector + upright-SIFT
descriptor), its batch form ``extract_sequence``, and the KLT step (LK flow,
refill detection, descriptors), all dispatching to the hand-written kernels
for a CUDA image."""

from __future__ import annotations

import warnings

import torch

from ptzbench.reference import _device
from ptzbench.reference.config import SLAMConfig
from ptzbench.reference.kernels.descriptor import describe_keypoints
from ptzbench.reference.kernels.detect import detect_keypoints
from ptzbench.reference.kernels.flow import lk_track
from ptzbench.reference.mapstore import set_rows_drop


def _desc_scale(cfg: SLAMConfig, focal) -> torch.Tensor | None:
    """Per-frame descriptor sample spacing from the current focal estimate
    (zoom normalization). None when disabled or no focal is given.

    ``descriptor_f_ref = -1`` (AUTO) must be resolved before this point;
    ``PTZSlam.init`` does it from the bootstrap pose. Reaching the sentinel
    with a live focal warns and disables the normalization."""
    if focal is None:
        return None
    if cfg.descriptor_f_ref < 0:
        warnings.warn(
            "descriptor_f_ref=-1 (AUTO) reached the frontend unresolved: "
            "zoom normalization is DISABLED for this call. Resolve it "
            "first (cfg.replace(descriptor_f_ref=<init focal>)) or drive "
            "the loop through PTZSlam.init, which resolves AUTO from the "
            "bootstrap pose.",
            stacklevel=2,
        )
        return None
    if cfg.descriptor_f_ref == 0:
        return None
    return torch.as_tensor(focal, dtype=torch.float32) / cfg.descriptor_f_ref


def extract_features(
    img: torch.Tensor,
    cfg: SLAMConfig,
    mask: torch.Tensor | None = None,
    focal: torch.Tensor | None = None,
):
    """Detect + describe one grayscale frame.

    Args:
      img: (H, W) float grayscale.
      mask: optional (H, W) bool, True where detection is allowed.
      focal: optional current focal-length estimate; with
        cfg.descriptor_f_ref set, descriptors sample at f/f_ref spacing.

    Returns:
      (xy (K, 2), desc (K, D), valid (K,)) with K = cfg.max_keypoints.
    """
    kp = detect_keypoints(
        img,
        max_keypoints=cfg.max_keypoints,
        threshold=cfg.detector_threshold,
        mask=mask,
    )
    desc = describe_keypoints(img, kp.xy, kp.valid, scale=_desc_scale(cfg, focal))
    return kp.xy, desc, kp.valid


def track_features(
    img_prev,
    img_next,
    xy,
    valid,
    cfg: SLAMConfig,
    mask=None,
    focal: torch.Tensor | None = None,
    device=None,
):
    """KLT-mode frontend step: track the keypoint table into the next frame
    with LK, refill the dead rows with fresh detections, and describe every
    row at its new position.

    Args:
      img_prev, img_next: (H, W) float grayscale frames.
      xy: (K, 2) keypoint table from the previous frame; valid: (K,) bool.
      mask: optional (H, W) bool, True where the refill may detect.
      focal: optional current focal estimate (descriptor zoom scale).
      device: where to run; by default the device of ``img_prev`` if it is
        a tensor, else the card (raising where there is none).

    Returns:
      (xy (K, 2), desc (K, D), valid (K,), tracked (K,)): ``tracked`` marks
      rows that survived the flow (not freshly detected, not dead).
    """
    dev = _device.resolve(device, img_prev)
    img_prev, img_next, xy, valid = (
        torch.as_tensor(v, device=dev) for v in (img_prev, img_next, xy, valid)
    )
    if mask is not None:
        mask = torch.as_tensor(mask, device=dev)
    k = xy.shape[0]
    res = lk_track(
        img_prev, img_next, xy, valid,
        levels=cfg.flow_levels, patch=cfg.flow_patch, iters=cfg.flow_iters,
        fb_tol=cfg.track_gate_px / 4.0,
    )
    tracked = res.tracked

    # refill: detect on the next frame, drop detections that landed on a
    # surviving track (min-distance suppression), pack into free rows
    kp = detect_keypoints(img_next, max_keypoints=k, threshold=cfg.detector_threshold, mask=mask)
    d2 = ((kp.xy[:, None, :] - res.xy[None, :, :]) ** 2).sum(-1)
    near_track = (d2 < cfg.min_refill_dist_px**2) & tracked[None, :]
    fresh = kp.valid & ~near_track.any(1)

    # the r-th fresh detection claims the r-th free row; the reference's
    # drop-mode scatters to the sentinel row k go to one padding row
    free = ~tracked
    iota = torch.arange(k, dtype=torch.int64, device=dev)
    free_rank = torch.cumsum(free.to(torch.int64), 0) - 1
    slot_of_rank = set_rows_drop(
        torch.full((k,), k, dtype=torch.int64, device=dev), torch.where(free, free_rank, k), iota
    )
    fresh_rank = torch.cumsum(fresh.to(torch.int64), 0) - 1
    fresh_ok = fresh & (fresh_rank < free.sum())
    target = torch.where(fresh_ok, slot_of_rank[fresh_rank.clamp(0, k - 1)], k)

    new_xy = set_rows_drop(res.xy, target, kp.xy)
    new_valid = set_rows_drop(tracked, target, True)
    desc = describe_keypoints(img_next, new_xy, new_valid, scale=_desc_scale(cfg, focal))
    return new_xy, desc, new_valid, tracked


def extract_sequence(imgs, cfg: SLAMConfig, masks=None, device=None):
    """``extract_features`` over a (T, H, W) stack, one frame at a time
    (each frame moves to the device in its turn), stacked: (xy (T, K, 2),
    desc (T, K, D), valid (T, K)). ``device``: by default the device of
    ``imgs`` if it is a tensor, else the card."""
    dev = _device.resolve(device, imgs)
    out = [
        extract_features(
            torch.as_tensor(imgs[k], device=dev), cfg,
            mask=None if masks is None else torch.as_tensor(masks[k], device=dev),
        )
        for k in range(len(imgs))
    ]
    return tuple(torch.stack(list(v)) for v in zip(*out))
