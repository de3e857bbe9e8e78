"""The reference's entry points: bootstrap, and the re-detect and KLT
loops over a segment of frames, frame by frame on the eager route of the
plain copy, in float32 with TF32 off (or on, for the control)."""

from __future__ import annotations

import contextlib

import torch

from ptzbench.reference import ekf as ekflib
from ptzbench.reference import mapstore
from ptzbench.reference.config import SLAMConfig
from ptzbench.reference.frontend import extract_features
from ptzbench.reference.geometry import Intrinsics
from ptzbench.reference.slam import (
    FrameInfo, SlamState, _bootstrap, _run_segment_pixels, _run_segment_pixels_klt, _scalar,
)


@contextlib.contextmanager
def precision(tf32: bool = False):
    """float32 matrix products and convolutions with TF32 off (the
    reference), or on (the control), put back on exit."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def make_config(fields: dict) -> SLAMConfig:
    """The reference's ``SLAMConfig`` from a configuration's fields."""
    return SLAMConfig(**fields)


def make_intrinsics(width: int, height: int) -> Intrinsics:
    return Intrinsics.create(width / 2.0, height / 2.0)


def init(cfg: SLAMConfig, intr: Intrinsics, img0: torch.Tensor, pose0) -> tuple[SlamState, tuple]:
    """The bootstrap on frame 0 at its known pose: (state, frame 0's (xy,
    desc, valid)). ``cfg.descriptor_f_ref`` must be resolved (> 0 or 0)."""
    dev = img0.device
    focal = torch.as_tensor(float(pose0[2]), dtype=torch.float32, device=dev)
    xy, desc, valid = extract_features(img0.to(torch.float32), cfg, focal=focal)
    state = SlamState(
        ekf=ekflib.init_state(pose0, cfg, device=dev),
        slot_desc=torch.zeros((cfg.max_rays, cfg.kf_desc_dim), dtype=torch.float32, device=dev),
        kf=mapstore.init_keyframe_store(cfg, device=dev),
        rays=mapstore.init_ray_store(cfg, device=dev),
        lost=_scalar(False, torch.bool, dev),
        frame_idx=_scalar(0, torch.int32, dev),
    )
    return _bootstrap(state, xy, desc, valid, cfg=cfg, intr=intr), (xy, desc, valid)


def run_redetect(state: SlamState, imgs: torch.Tensor, cfg: SLAMConfig, intr: Intrinsics):
    """Re-detect mode over (T, H, W) frames: (state, FrameInfo stacked over T)."""
    state, infos, _ = _run_segment_pixels(
        state, imgs, None, None, cfg=cfg, intr=intr, device=imgs.device, lost=bool(state.lost),
    )
    return state, infos


def run_klt(state: SlamState, imgs: torch.Tensor, carry, cfg: SLAMConfig, intr: Intrinsics):
    """KLT mode over (T, H, W) frames from the carry (previous image, xy,
    valid): (state, FrameInfo stacked over T, (last image, xy, valid))."""
    prev_img, prev_xy, prev_valid = carry
    state, infos, xy, valid, _ = _run_segment_pixels_klt(
        state, imgs, None, prev_img, prev_xy, prev_valid, None,
        cfg=cfg, intr=intr, device=imgs.device, lost=bool(state.lost),
    )
    return state, infos, (imgs[-1], xy, valid)


__all__ = ["FrameInfo", "SlamState", "init", "make_config", "make_intrinsics", "precision", "run_klt", "run_redetect"]
