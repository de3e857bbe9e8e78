"""The homography-EKF baseline the full SLAM system is compared against.
Port of ``ptzjax/baselines.py``.

A map-free visual-odometry tracker: each frame is matched against the
previous frame only, the previous frame's matched keypoints are
back-projected through the previous estimate into rays, and the frame's
3-DoF pose is solved from those rays (RANSAC pan-tilt vote + Huber
Gauss-Newton). A 6-dim constant-velocity EKF (pose + velocities, no
landmark block) smooths the per-frame solves. Every measurement is chained
to the previous estimate, so error integrates over time: the drift the
keyframe map removes (``tests/test_torch_baselines.py``).

The matcher is ``match.match_descriptors`` (ungated, mutual), kernel C on
the card. The reference's ``lax.scan`` is a loop with no host read: on the
card each frame is the replay of one CUDA graph of ``_frame``
(``_graphs.VOGraph``), on the CPU a Python loop; the per-frame infos stay
on the device and are stacked once at the end.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ptzjax_torch import _device
from ptzjax_torch import match as matchlib
from ptzjax_torch.config import SLAMConfig
from ptzjax_torch.geometry import Intrinsics, back_project_pixels
from ptzjax_torch.reloc import solve_pose


class VOState(NamedTuple):
    """Carry of the frame-to-frame loop."""

    cam: torch.Tensor        # (6,) pose + velocity
    cov: torch.Tensor        # (6, 6)
    xy: torch.Tensor         # (K, 2) previous frame keypoints
    desc: torch.Tensor       # (K, D) previous frame descriptors
    valid: torch.Tensor      # (K,) previous frame validity


class VOInfo(NamedTuple):
    pose: torch.Tensor       # (3,)
    num_inliers: torch.Tensor
    updated: torch.Tensor    # bool: measurement accepted


def _process_noise(cfg: SLAMConfig, device) -> torch.Tensor:
    """(6,) diagonal of the constant-velocity process noise (fp32 products,
    as in the reference), kept on the device."""
    accel = np.array([cfg.sigma_pan**2, cfg.sigma_tilt**2, cfg.sigma_focal**2], np.float32)
    return _device.const(tuple(float(v) for v in np.concatenate([accel * cfg.dt**2, accel])), device)


def _predict(cam: torch.Tensor, cov: torch.Tensor, cfg: SLAMConfig):
    cam = torch.cat([cam[0:3] + cfg.dt * cam[3:6], cam[3:6]])
    cov = torch.cat([cov[0:3] + cfg.dt * cov[3:6], cov[3:6]])
    cov = torch.cat([cov[:, 0:3] + cfg.dt * cov[:, 3:6], cov[:, 3:6]], 1)
    return cam, cov + torch.diag(_process_noise(cfg, cam.device))


def _frame(state: VOState, xy, desc, valid, *, intr: Intrinsics, cfg: SLAMConfig):
    cam, cov = _predict(state.cam, state.cov, cfg)
    pose_pred = cam[:3]
    dev = cam.device

    # associate against the PREVIOUS frame only (no map, no keyframes)
    m = matchlib.match_descriptors(desc, state.desc, valid, state.valid, ratio=cfg.ratio_test)
    # rays of the matched previous keypoints through the previous estimate:
    # this chaining is what integrates error frame over frame (drift)
    rays_prev = back_project_pixels(state.cam[:3], state.xy[m.idx.long()], intr)
    inl = matchlib.ransac_pan_tilt(
        rays_prev, xy, m.ok, pose_pred[2], intr.cx, intr.cy,
        num_hypotheses=cfg.ransac_iters, inlier_px=3 * cfg.ransac_inlier_px,
    )
    n_inl = inl.sum().to(torch.int32)
    z = solve_pose(rays_prev, xy, inl, intr, pose_pred, iters=10)

    # 6-dim EKF update with the solved pose as the measurement, z = [I 0] x;
    # the measurement noise shrinks with the inlier count
    scale = cfg.sigma_obs / torch.sqrt(n_inl.clamp_min(1).to(torch.float32))
    inv_f = 1.0 / pose_pred[2]
    r = torch.diag((torch.stack([inv_f, inv_f, torch.ones_like(inv_f)]) * scale) ** 2)
    s = cov[0:3, 0:3] + r
    k_gain = torch.linalg.solve_ex(s.T, cov[:, 0:3].T).result.T      # (6, 3)
    ok = n_inl >= cfg.min_inliers
    innov = torch.where(ok, z - pose_pred, 0.0)
    cam = cam + k_gain @ innov
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    okf = ok.to(torch.float32)
    ikh = eye6 - okf * (k_gain @ eye6[0:3])
    cov = ikh @ cov @ ikh.T + okf * (k_gain @ r @ k_gain.T)
    cov = 0.5 * (cov + cov.T)

    new = VOState(cam=cam, cov=cov, xy=xy, desc=desc, valid=valid)
    return new, VOInfo(pose=cam[:3], num_inliers=n_inl, updated=ok)


def init_vo(pose0, xy0, desc0, valid0, cfg: SLAMConfig, device=None) -> VOState:
    """The carry at frame 0: the known pose (nearly exactly known), zero
    velocity with the init prior, and frame 0's features. ``device``: by
    default the device of ``xy0`` if it is a tensor, else the card."""
    dev = _device.resolve(device, xy0)
    pose0 = torch.as_tensor(pose0, dtype=torch.float32, device=dev)
    diag = (1e-6, 1e-6, 1e-6, cfg.init_vel_std**2, cfg.init_vel_std**2, cfg.init_vel_std_f**2)
    return VOState(
        cam=torch.cat([pose0, torch.zeros(3, dtype=torch.float32, device=dev)]),
        cov=torch.diag(_device.const(diag, dev)),
        xy=torch.as_tensor(xy0, device=dev),
        desc=torch.as_tensor(desc0, device=dev),
        valid=torch.as_tensor(valid0, device=dev),
    )


def track_homography_ekf(
    state: VOState, xy_seq, desc_seq, valid_seq, *, intr: Intrinsics, cfg: SLAMConfig,
    _graphs: bool = True,
) -> tuple[VOState, VOInfo]:
    """Run the baseline over a whole sequence, frame by frame, on the
    device of ``state``. On the card every frame after the first is the
    replay of one CUDA graph, captured at the call's first frame
    (``_graphs.VOGraph``); ``_graphs=False`` asks for the eager loop there,
    for parity checks and A/B timings. The results are bitwise the same.

    Args:
      xy_seq: (T, K, 2); desc_seq: (T, K, D); valid_seq: (T, K); numpy
        arrays or tensors on any device.

    Returns:
      (final carry, per-frame VOInfo stacked over T).
    """
    dev = state.cam.device
    xy_seq, desc_seq, valid_seq = (_device.to_device(v, dev) for v in (xy_seq, desc_seq, valid_seq))
    if _graphs and dev.type == "cuda":
        from ptzjax_torch._graphs import VOGraph

        return VOGraph(state, cfg=cfg, intr=intr).run(state, xy_seq, desc_seq, valid_seq)
    infos = []
    for i in range(xy_seq.shape[0]):
        state, info = _frame(state, xy_seq[i], desc_seq[i], valid_seq[i], intr=intr, cfg=cfg)
        infos.append(info)
    return state, VOInfo(*(torch.stack(list(field)) for field in zip(*infos)))
