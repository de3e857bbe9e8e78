"""The benchmark's frames, made on the device from the seed.

``trajectory`` is the soak's periodic camera path (``ptzjax_torch/soak.py``,
after ``benchmarks/soak.py``) with its amplitudes and periods as data and a
phase. ``make_panorama`` and ``render`` rewrite ``ptzjax_torch/synth.py``'s
``make_panorama`` / ``render_image`` in torch, so that a run makes its
texture and renders its frames on the card in a few large calls instead of
on host threads: the same multi-octave smoothed-noise texture in ray-angle
space (its normals from a ``torch.Generator`` on the device, so not the
numpy texture of the same seed) and the same exact back-projection and
bilinear sampling. ``host_stack`` renders a stack of poses and keeps it in
pinned host memory, as a capture or decode pipeline hands frames over.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# synth.make_panorama's defaults
THETA_RANGE = (-1.0, 1.0)
PHI_RANGE = (-0.4, 0.25)
TEXELS_PER_RAD = 2500.0
OCTAVES = 4
RENDER_BATCH = 24   # frames rendered per device call


def trajectory(path: dict, stack: int, phase: int = 0) -> np.ndarray:
    """(stack, 3) float32 (pan, tilt, focal) at path times ``phase`` ..
    ``phase + stack - 1``: each of pan, tilt and focal is its constant plus
    sum(a * sin(2 pi t / period)) over its [a, period] pairs. With periods
    that divide ``stack`` the path repeats every ``stack`` frames."""
    t = np.arange(phase, phase + stack, dtype=np.float64)

    def wave(c, terms):
        return c + sum(a * np.sin(2 * np.pi * t / p) for a, p in terms)

    return np.stack(
        [wave(path["pan0"], path["pan"]), wave(path["tilt0"], path["tilt"]), wave(path["f0"], path["f"])], -1
    ).astype(np.float32)


class Panorama(NamedTuple):
    """(PH, PW) float32 texture on the device, and the angle of texel (0, 0)
    and radians per texel along theta and phi."""

    tex: torch.Tensor
    theta0: float
    phi0: float
    dtheta: float
    dphi: float


def make_panorama(seed: int, device, texels_per_rad: float = TEXELS_PER_RAD) -> Panorama:
    """Multi-octave smoothed noise (features of 8, 16, 32 and 64 texels,
    octave o weighted 1 / (o + 1)), normalized to zero mean and unit std,
    from normals drawn by a ``torch.Generator`` on ``device`` seeded with
    ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    pw = int((THETA_RANGE[1] - THETA_RANGE[0]) * texels_per_rad)
    ph = int((PHI_RANGE[1] - PHI_RANGE[0]) * texels_per_rad)
    tex = torch.zeros((ph, pw), dtype=torch.float32, device=device)
    for o in range(OCTAVES):
        step = 1 << (o + 3)
        base = torch.randn((ph // step + 2, pw // step + 2), generator=gen, device=device)
        yy = torch.arange(ph, device=device, dtype=torch.float64) / step
        xx = torch.arange(pw, device=device, dtype=torch.float64) / step
        y0, x0 = yy.long(), xx.long()
        fy = (yy - y0).to(torch.float32)[:, None]
        fx = (xx - x0).to(torch.float32)[None, :]
        rows0, rows1 = base[y0], base[y0 + 1]
        tex += (
            rows0[:, x0] * (1 - fy) * (1 - fx) + rows0[:, x0 + 1] * (1 - fy) * fx
            + rows1[:, x0] * fy * (1 - fx) + rows1[:, x0 + 1] * fy * fx
        ) / (o + 1)
    tex = (tex - tex.mean()) / (tex.std() + 1e-9)
    return Panorama(
        tex, THETA_RANGE[0], PHI_RANGE[0],
        (THETA_RANGE[1] - THETA_RANGE[0]) / pw, (PHI_RANGE[1] - PHI_RANGE[0]) / ph,
    )


def render(pano: Panorama, cams: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """(T, height, width) float32 frames of the panorama under the (T, 3)
    cameras (pan, tilt, focal), principal point at the image centre:
    every pixel back-projected to its ray (float64) and the texture sampled
    bilinearly (float32), as ``synth.render_image``."""
    dev = pano.tex.device
    cam = cams.to(device=dev, dtype=torch.float64)
    x = torch.arange(width, device=dev, dtype=torch.float64) - width / 2.0
    y = torch.arange(height, device=dev, dtype=torch.float64) - height / 2.0
    f = cam[:, 2, None]
    u = torch.atan2(x[None, :], f)                                        # (T, W)
    theta = cam[:, 0, None] + u                                           # (T, W)
    phi = cam[:, 1, None, None] + torch.atan2(-y[None, :, None] * torch.cos(u)[:, None, :], f[:, :, None])
    ph, pw = pano.tex.shape
    tx = ((theta - pano.theta0) / pano.dtheta).clamp(0, pw - 2)[:, None, :].expand_as(phi)
    ty = ((phi - pano.phi0) / pano.dphi).clamp(0, ph - 2)
    x0, y0 = tx.long(), ty.long()
    fx, fy = (tx - x0).to(torch.float32), (ty - y0).to(torch.float32)
    flat = pano.tex.reshape(-1)
    at = y0 * pw + x0
    return (
        flat[at] * (1 - fy) * (1 - fx) + flat[at + 1] * (1 - fy) * fx
        + flat[at + pw] * fy * (1 - fx) + flat[at + pw + 1] * fy * fx
    )


def host_stack(pano: Panorama, cams: np.ndarray, width: int, height: int, pin: bool = True) -> torch.Tensor:
    """The frames of ``cams`` rendered on the panorama's device, in
    ``RENDER_BATCH`` frames a call, into one (T, height, width) float32
    host tensor (pinned where ``pin``)."""
    out = torch.empty((len(cams), height, width), dtype=torch.float32, pin_memory=pin)
    cams_t = torch.as_tensor(cams)
    for i in range(0, len(cams), RENDER_BATCH):
        out[i:i + RENDER_BATCH].copy_(render(pano, cams_t[i:i + RENDER_BATCH], width, height))
    return out
