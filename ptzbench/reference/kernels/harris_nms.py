"""Keypoint detection maps in plain torch: the Harris response, 3x3 NMS,
mask, border, subpixel offsets and the response floor. A frozen copy of
the plain version in ``ptzjax_torch/kernels/harris_nms.py``, which the
port's kernel A (``csrc/harris_nms.cu``) is held to.
"""

from __future__ import annotations



import torch

from ptzbench.reference.kernels.detect import _NEG, _nms3, _subpixel, harris_response


def detect_maps_plain(
    img: torch.Tensor, mask: torch.Tensor | None = None, border: int = 8,
    threshold: float = 1e-4, k: float = 0.04,
):
    """(sup, off, floor) with plain torch ops: the kernel's specification.
    ``off`` is 0 off the survivors."""
    h, w = img.shape
    resp = harris_response(img, k)
    sup = _nms3(resp)
    neg = torch.full_like(sup, _NEG)
    if mask is not None:
        sup = torch.where(mask, sup, neg)
    yy = torch.arange(h, device=img.device)[:, None]
    xx = torch.arange(w, device=img.device)[None, :]
    inb = (yy >= border) & (yy < h - border) & (xx >= border) & (xx < w - border)
    sup = torch.where(inb, sup, neg)
    keep = sup > _NEG
    off = torch.zeros((h, w, 2), dtype=torch.float32, device=img.device)
    if h >= 3 and w >= 3:   # smaller images have no interior pixel to fit at
        off_x, off_y = _subpixel(resp, yy.expand(h, w).reshape(-1), xx.expand(h, w).reshape(-1))
        off = torch.where(keep[..., None], torch.stack([off_x, off_y], -1).reshape(h, w, 2), off)
    floor = (threshold * sup.max().clamp_min(1e-20)).reshape(1)
    return sup, off, floor


def detect_maps(
    img: torch.Tensor, mask: torch.Tensor | None = None, border: int = 8,
    threshold: float = 1e-4, k: float = 0.04,
):
    """(sup (H, W), off (H, W, 2), floor (1,)): ``detect_maps_plain`` on any
    device."""
    return detect_maps_plain(img, mask, border, threshold, k)
