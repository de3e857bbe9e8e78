"""Keypoint detection: Harris response + 3x3 NMS + top-k keypoint table.

Port of ``ptzjax/kernels/detect.py``. The plain torch functions here define
the semantics and run on the CPU; ``detect_keypoints`` gets its maps (the
suppressed response with mask and border, the subpixel offsets and the
floor) from ``kernels/harris_nms.py:detect_maps``, one hand-written kernel
for a CUDA image, and adds the top-k.

Smoothing is written as shifted sums, as in the reference, not as a
``conv2d``: a float32 convolution would go through cuDNN in TF32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ptzjax_torch import _device

_NEG = -1e30


class KeypointTable(NamedTuple):
    """Fixed-capacity detector output.

    Attributes:
      xy: (K, 2) fp32 pixel coordinates (x, y), subpixel-refined.
      score: (K,) fp32 response at the keypoint.
      valid: (K,) bool.
    """

    xy: torch.Tensor
    score: torch.Tensor
    valid: torch.Tensor


def _edge(n: int, lo: int, hi: int, device) -> torch.Tensor:
    """Indices of an edge-padded axis: clamp(-lo .. n + hi - 1)."""
    return torch.arange(-lo, n + hi, device=device).clamp(0, n - 1)


def _smooth5(x: torch.Tensor) -> torch.Tensor:
    """Separable 5-tap binomial smoothing (approx Gaussian sigma~1), edge
    padded, vertical pass first."""
    k = (1 / 16.0, 4 / 16.0, 6 / 16.0, 4 / 16.0, 1 / 16.0)
    h, w = x.shape
    a = x[_edge(h, 2, 2, x.device)]
    out = torch.zeros_like(x)
    for i in range(5):
        out = out + k[i] * a[i : i + h]
    a = out[:, _edge(w, 2, 2, x.device)]
    out = torch.zeros_like(x)
    for i in range(5):
        out = out + k[i] * a[:, i : i + w]
    return out


def _gradients(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Central-difference gradients with edge replication."""
    h, w = img.shape
    p = img[_edge(h, 1, 1, img.device)][:, _edge(w, 1, 1, img.device)]
    ix = 0.5 * (p[1:-1, 2:] - p[1:-1, :-2])
    iy = 0.5 * (p[2:, 1:-1] - p[:-2, 1:-1])
    return ix, iy


def harris_response(img: torch.Tensor, k: float = 0.04) -> torch.Tensor:
    """Harris corner response R = det(M) - k tr(M)^2 on a (H, W) image.

    M is the 5x5-binomial-smoothed gradient structure tensor.
    """
    ix, iy = _gradients(img.to(torch.float32))
    ixx = _smooth5(ix * ix)
    iyy = _smooth5(iy * iy)
    ixy = _smooth5(ix * iy)
    det = ixx * iyy - ixy * ixy
    tr = ixx + iyy
    return det - k * tr * tr


def _nms3(resp: torch.Tensor) -> torch.Tensor:
    """Keep a value only where it is the strict max of its 3x3 neighbourhood
    (ties broken toward the top-left by the >= / > split, so a plateau yields
    exactly one winner); -1e30 elsewhere and outside the image."""
    p = torch.nn.functional.pad(resp, (1, 1, 1, 1), value=_NEG)
    neigh_prev = torch.stack(
        [p[:-2, :-2], p[:-2, 1:-1], p[:-2, 2:], p[1:-1, :-2]]
    ).amax(0)
    neigh_next = torch.stack(
        [p[1:-1, 2:], p[2:, :-2], p[2:, 1:-1], p[2:, 2:]]
    ).amax(0)
    keep = (resp > neigh_prev) & (resp >= neigh_next)
    return torch.where(keep, resp, torch.full_like(resp, _NEG))


def _subpixel(resp: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor):
    """Quadratic 1D fits along x and y through the NMS winners."""
    h, w = resp.shape
    yc = ys.clamp(1, h - 2)
    xc = xs.clamp(1, w - 2)
    c = resp[yc, xc]
    dx = 0.5 * (resp[yc, xc + 1] - resp[yc, xc - 1])
    dxx = resp[yc, xc + 1] + resp[yc, xc - 1] - 2.0 * c
    dy = 0.5 * (resp[yc + 1, xc] - resp[yc - 1, xc])
    dyy = resp[yc + 1, xc] + resp[yc - 1, xc] - 2.0 * c
    zero = torch.zeros_like(c)
    off_x = torch.where(dxx.abs() > 1e-12, -dx / dxx, zero)
    off_y = torch.where(dyy.abs() > 1e-12, -dy / dyy, zero)
    return off_x.clamp(-0.5, 0.5), off_y.clamp(-0.5, 0.5)


def detect_keypoints(
    img: torch.Tensor,
    max_keypoints: int,
    threshold: float = 1e-4,
    mask: torch.Tensor | None = None,
    border: int = 8,
) -> KeypointTable:
    """Detect up to ``max_keypoints`` Harris corners.

    Candidate selection is always the exact ``torch.topk(sorted=True)``. The
    reference defaults to ``lax.approx_max_k``, a TPU-only approximation
    that is exact on the CPU, which is what the parity tests compare with
    (``exact_topk=True``).

    Args:
      img: (H, W) grayscale, any float dtype (values ~[0, 1]).
      threshold: response floor relative to the image's max response.
      mask: optional (H, W) bool, True where detection is ALLOWED.
      border: pixels to ignore at the image edge.

    Returns:
      KeypointTable sorted by descending score.
    """
    from ptzjax_torch.kernels.harris_nms import detect_maps

    w = img.shape[1]
    # the suppressed, masked and bordered response, the subpixel offsets at
    # its survivors and the floor, in one kernel on the card
    sup, off, floor = detect_maps(img.to(torch.float32).contiguous(), mask, border, threshold)
    score, idx = torch.topk(sup.reshape(-1), max_keypoints, sorted=True)
    valid = score > floor
    # a valid entry is a survivor (floor > 0), so its offsets are defined;
    # an invalid entry's may be garbage, and the where below discards them
    xy = torch.stack([idx % w, idx // w], dim=-1).to(torch.float32) + off.reshape(-1, 2).index_select(0, idx)
    zero = _device.const((0.0,), img.device)   # a scalar 0.0 would be filled on the device each call
    return KeypointTable(
        xy=torch.where(valid[:, None], xy, zero),
        score=torch.where(valid, score, zero),
        valid=valid,
    )
