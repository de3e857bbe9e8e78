"""Evaluation: trajectory accuracy and reprojection error. Port of
``ptzjax/eval.py`` (its timer and trace exporter are not ported: the
benchmark, ``ptzbench/``, times the port, and ``_trace`` traces it).

Per-frame |delta pan| / |delta tilt| / |delta f| against ground truth, and
the reprojection RMSE over a shared ray set.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ptzjax_torch import _device
from ptzjax_torch.geometry import Intrinsics, back_project_pixels, in_view_mask, project_rays


class TrajectoryErrors(NamedTuple):
    """Summary statistics of a tracked trajectory against ground truth;
    angles in degrees, focal in pixels."""

    pan_mae_deg: float
    tilt_mae_deg: float
    focal_mae_px: float
    pan_rmse_deg: float
    tilt_rmse_deg: float
    focal_rmse_px: float
    num_frames: int

    def as_dict(self) -> dict[str, Any]:
        return dict(self._asdict())


def trajectory_errors(pred: np.ndarray, gt: np.ndarray) -> TrajectoryErrors:
    """Per-frame (pan, tilt, f) error summary. pred/gt: (T, 3), radians."""
    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    d = pred - gt
    d_deg = np.rad2deg(d[:, :2])
    return TrajectoryErrors(
        pan_mae_deg=float(np.abs(d_deg[:, 0]).mean()),
        tilt_mae_deg=float(np.abs(d_deg[:, 1]).mean()),
        focal_mae_px=float(np.abs(d[:, 2]).mean()),
        pan_rmse_deg=float(np.sqrt((d_deg[:, 0] ** 2).mean())),
        tilt_rmse_deg=float(np.sqrt((d_deg[:, 1] ** 2).mean())),
        focal_rmse_px=float(np.sqrt((d[:, 2] ** 2).mean())),
        num_frames=len(pred),
    )


def reprojection_rmse(
    pred,
    gt,
    intr: Intrinsics,
    width: float,
    height: float,
    rays=None,
    grid: int = 12,
    device=None,
) -> float:
    """RMSE of the pixel displacement between predicted and ground-truth
    cameras over a shared ray set. With ``rays`` None, each frame uses a
    ``grid`` x ``grid`` grid of pixels back-projected through its GT camera.

    Runs on ``device``: by default the card (raising where there is none);
    ``device="cpu"`` asks for the CPU."""
    dev = _device.resolve(device)
    pred_t = torch.as_tensor(np.asarray(pred, np.float32), device=dev)
    gt_t = torch.as_tensor(np.asarray(gt, np.float32), device=dev)
    if rays is None:
        xs = torch.linspace(0.05 * width, 0.95 * width, grid, device=dev)
        ys = torch.linspace(0.05 * height, 0.95 * height, grid, device=dev)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        pix = torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)            # (G, 2)
        rays_t = back_project_pixels(gt_t, pix, intr)                      # (T, G, 2)
    else:
        rays_t = torch.as_tensor(np.asarray(rays, np.float32), device=dev)
        rays_t = rays_t[None].expand(gt_t.shape[0], *rays_t.shape)
    a = project_rays(pred_t, rays_t, intr)
    b = project_rays(gt_t, rays_t, intr)
    ok = in_view_mask(gt_t, rays_t, intr, width, height, margin=1.0)
    e2 = ((a - b) ** 2).sum(-1)
    per_frame = torch.sqrt(torch.where(ok, e2, 0.0).sum(-1) / ok.sum(-1).clamp_min(1))
    return float(torch.sqrt((per_frame**2).mean()))


def evaluate_run(infos, gt_cameras, intr: Intrinsics, width: float, height: float) -> dict[str, Any]:
    """The post-run report of a stacked ``FrameInfo`` (from ``run_segment``,
    ``run_segment_pixels`` or ``run_segment_pixels_klt``): trajectory
    errors, reprojection RMSE (on the device of the infos), and the lost,
    relocalization and keyframe counts. A JSON-ready dict."""
    dev = infos.pose.device
    h = type(infos)(*(v.cpu().numpy() for v in infos))
    pose = h.pose
    gt = np.asarray(gt_cameras)[-len(pose):]
    errs = trajectory_errors(pose, gt)
    return {
        **errs.as_dict(),
        "reprojection_rmse_px": reprojection_rmse(pose, gt, intr, width, height, device=dev),
        "frames_lost": int(h.lost.sum()),
        "reloc_attempts": int((h.event == 1).sum()),
        "reloc_successes": int(h.reloc_success.sum()),
        "keyframes_inserted": int(h.keyframe.sum()),
        "mean_matches": float(h.num_matches.mean()),
        "mean_active_slots": float(h.num_active_slots.mean()),
    }
