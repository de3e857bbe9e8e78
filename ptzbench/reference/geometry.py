"""PTZ camera geometry: the 3-DoF pan/tilt/focal camera over 2-DoF ray
landmarks. Port of ``ptzjax/geometry.py``.

Projection of ray (theta, phi) under camera (p, t, f)::

    u = theta - p ;  v = phi - t
    x = f * tan(u) + cx
    y = -f * tan(v) / cos(u) + cy

All functions are plain torch on tensors, vectorized over leading batch
dimensions, fp32. Angles are radians; focal length is in pixels. ``u, v``
are clamped to +/- ``ANGLE_CLIP`` before ``tan`` so masked-out lanes stay
finite.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# Maximum |angle difference| fed to tan(); ~85.9 degrees.
ANGLE_CLIP = 1.5


class Intrinsics(NamedTuple):
    """Per-sequence shared camera constants. Leaves are host numpy values,
    as in the reference: they enter device code as Python scalars.

    Attributes:
      cx, cy: principal point (pixels).
      center: camera center ``C`` in world coordinates, shape (3,).
      base_rotation: world -> camera-base rotation ``Rb``, shape (3, 3).
    """

    cx: np.ndarray
    cy: np.ndarray
    center: np.ndarray
    base_rotation: np.ndarray

    @staticmethod
    def create(cx, cy, center=None, base_rotation=None, dtype=None):
        dtype = np.float32 if dtype is None else np.dtype(dtype)
        if center is None:
            center = np.zeros((3,), dtype)
        if base_rotation is None:
            base_rotation = np.eye(3, dtype=dtype)
        return Intrinsics(
            cx=np.asarray(cx, dtype),
            cy=np.asarray(cy, dtype),
            center=np.asarray(center, dtype),
            base_rotation=np.asarray(base_rotation, dtype),
        )


def clip_angle(a: torch.Tensor) -> torch.Tensor:
    """Clamp an angle difference before tan(); keeps masked lanes finite."""
    return a.clamp(-ANGLE_CLIP, ANGLE_CLIP)


def project_rays(camera: torch.Tensor, rays: torch.Tensor, intr: Intrinsics) -> torch.Tensor:
    """Project (..., N, 2) rays to (..., N, 2) pixels under (..., 3) cameras."""
    pan = camera[..., 0:1]
    tilt = camera[..., 1:2]
    f = camera[..., 2:3]
    u = clip_angle(rays[..., 0] - pan)
    v = clip_angle(rays[..., 1] - tilt)
    x = f * torch.tan(u) + float(intr.cx)
    y = -f * torch.tan(v) / torch.cos(u) + float(intr.cy)
    return torch.stack([x, y], dim=-1)


def back_project_pixels(
    camera: torch.Tensor, pixels: torch.Tensor, intr: Intrinsics
) -> torch.Tensor:
    """Back-project (..., N, 2) pixels to (..., N, 2) rays (theta, phi);
    inverse of `project_rays` inside the angle clip."""
    pan = camera[..., 0:1]
    tilt = camera[..., 1:2]
    f = camera[..., 2:3]
    x = pixels[..., 0]
    y = pixels[..., 1]
    u = torch.atan2(x - float(intr.cx), f)
    theta = pan + u
    phi = tilt + torch.atan2(-(y - float(intr.cy)) * torch.cos(u), f)
    return torch.stack([theta, phi], dim=-1)


def project_jacobians(
    camera: torch.Tensor, rays: torch.Tensor, intr: Intrinsics
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Closed-form projection + Jacobians wrt camera and ray parameters.

    Returns:
      (pix, J_cam, J_ray):
        pix:   (..., N, 2) projected pixels,
        J_cam: (..., N, 2, 3) d(x,y)/d(pan,tilt,f),
        J_ray: (..., N, 2, 2) d(x,y)/d(theta,phi) = -J_cam[..., :2].
    """
    pan = camera[..., 0:1]
    tilt = camera[..., 1:2]
    f = camera[..., 2:3]
    u = clip_angle(rays[..., 0] - pan)
    v = clip_angle(rays[..., 1] - tilt)
    tu = torch.tan(u)
    tv = torch.tan(v)
    su = 1.0 / torch.cos(u)  # sec(u)
    sv = 1.0 / torch.cos(v)  # sec(v)

    x = f * tu + float(intr.cx)
    y = -f * tv * su + float(intr.cy)
    pix = torch.stack([x, y], dim=-1)

    zero = torch.zeros_like(tu)
    dx_dp = -f * su * su
    dx_dt = zero
    dx_df = tu
    dy_dp = f * tv * su * tu
    dy_dt = f * sv * sv * su
    dy_df = -tv * su
    j_cam = torch.stack(
        [
            torch.stack([dx_dp, dx_dt, dx_df], dim=-1),
            torch.stack([dy_dp, dy_dt, dy_df], dim=-1),
        ],
        dim=-2,
    )
    j_ray = -j_cam[..., :2]
    return pix, j_cam, j_ray


def in_view_mask(
    camera: torch.Tensor,
    rays: torch.Tensor,
    intr: Intrinsics,
    width: float,
    height: float,
    margin: float = 0.0,
) -> torch.Tensor:
    """Rays whose projection lands inside the image (within ``margin``) and
    inside the tan() validity region."""
    pan = camera[..., 0:1]
    tilt = camera[..., 1:2]
    u = rays[..., 0] - pan
    v = rays[..., 1] - tilt
    ok_angle = (u.abs() < ANGLE_CLIP) & (v.abs() < ANGLE_CLIP)
    pix = project_rays(camera, rays, intr)
    x, y = pix[..., 0], pix[..., 1]
    ok_img = (x >= -margin) & (x < width + margin) & (y >= -margin) & (y < height + margin)
    return ok_angle & ok_img


def residuals(
    camera: torch.Tensor,
    rays: torch.Tensor,
    observations: torch.Tensor,
    intr: Intrinsics,
) -> torch.Tensor:
    """Reprojection residuals r = project(camera, rays) - observations."""
    return project_rays(camera, rays, intr) - observations
