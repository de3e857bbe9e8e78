"""Keypoint detection maps: the Hopper kernel and its plain version.

Replaces the TPU kernel ``ptzjax/kernels/detect_pallas.py:harris_nms_pallas``
and the full-frame passes that follow it in ``detect_keypoints`` with one
launch of ``csrc/harris_nms.cu``. ``detect_maps`` returns everything the
top-k needs: the suppressed, masked and bordered response ``sup``, the
subpixel offsets ``off`` at its survivors and the response ``floor``. On
the card it is bound by bytes (the image read, ``sup`` written, 8 B per
survivor): each warp of the kernel computes a 56-column strip over a run
of rows with the whole stencil in registers, so the response never reaches
device memory. ``plan`` and ``warp_tiles`` give its grid in pure Python.
The kernel's note says how its borders and rounding match the plain
version.

``detect_maps`` takes the plain version for a tensor on the CPU and launches
the kernel for a CUDA tensor; it never falls back from one to the other.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ptzjax_torch.kernels import _build
from ptzjax_torch.kernels.detect import _NEG, _nms3, _subpixel, harris_response

launches = 0   # kernel launches since the last reset (plain calls not counted)
masked_launches = 0   # the launches among them that carried a detection mask

STRIP = 56   # output columns per warp (csrc/harris_nms.cu)
RUN = 8      # output rows per warp
WARPS = 4    # warps per CTA
# (device index, stream) -> (ticket counter, per-CTA maxima), grown when a
# grid needs more: the counter is zeroed when made and the kernel leaves it
# at 0
_workspace: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


class Plan(NamedTuple):
    """The kernel's grid: ``strips`` x ``runs`` warps, each owning ``STRIP``
    columns and ``RUN`` rows, ``WARPS`` to a CTA."""

    strips: int
    runs: int
    ctas: int


def plan(h: int, w: int) -> Plan:
    """The grid for an (h, w) image, as ``ptz_harris_nms`` computes it."""
    strips, runs = -(-w // STRIP), -(-h // RUN)
    return Plan(strips, runs, -(-strips * runs // WARPS))


def warp_tiles(h: int, w: int):
    """Yield (warp, output rows, output columns) for every warp of the grid
    that writes: ``range`` objects, as the kernel bounds them."""
    p = plan(h, w)
    for g in range(min(p.ctas * WARPS, p.strips * p.runs)):
        x0, y0 = g % p.strips * STRIP, g // p.strips * RUN
        yield g, range(y0, min(h, y0 + RUN)), range(x0, min(w, x0 + STRIP))


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


def _check(name, x, shape, dtype, device):
    if x.device != device or x.dtype != dtype or tuple(x.shape) != shape:
        raise ValueError(
            f"detect_maps: {name} must be {dtype} {shape} on {device}, got "
            f"{x.dtype} {tuple(x.shape)} on {x.device}"
        )
    if not x.is_contiguous():
        raise ValueError(f"detect_maps: {name} must be contiguous")


def _scratch(dev, stream: int, ctas: int):
    """This stream's (counter, per-CTA maxima), grown to ``ctas``."""
    key = (dev.index, stream)
    counter, maxima = _workspace.get(key, (None, None))
    if counter is None:
        counter = torch.zeros(1, dtype=torch.int32, device=dev)
    if maxima is None or maxima.numel() < ctas:
        maxima = torch.empty(ctas, dtype=torch.float32, device=dev)
    _workspace[key] = counter, maxima
    return counter, maxima


def detect_maps(
    img: torch.Tensor, mask: torch.Tensor | None = None, border: int = 8,
    threshold: float = 1e-4, k: float = 0.04,
):
    """(sup (H, W), off (H, W, 2), floor (1,)), fp32, for an (H, W) fp32
    image and an optional (H, W) bool mask (True where detection is
    allowed).

    ``sup`` holds the 3x3 NMS survivors of the Harris response that lie at
    least ``border`` pixels inside the image and are allowed by the mask,
    and -1e30 elsewhere. ``off`` holds the subpixel offsets (off_x, off_y)
    at every survivor; elsewhere the kernel leaves it unspecified. ``floor``
    is ``threshold * max(sup.max(), 1e-20)``. The kernel needs
    ``border >= 1``.
    """
    if img.device.type == "cpu":
        return detect_maps_plain(img, mask, border, threshold, k)
    dev = img.device
    if dev.type != "cuda":
        raise ValueError(f"detect_maps: unsupported device {dev}")
    if img.dim() != 2:
        raise ValueError(f"detect_maps: need a 2-D image, got {tuple(img.shape)}")
    h, w = img.shape
    if h < 1 or w < 1:
        raise ValueError(f"detect_maps: empty image {tuple(img.shape)}")
    if border < 1:
        raise ValueError(f"detect_maps: the kernel needs border >= 1, got {border}")
    if 2 * h * w >= 2**31:
        raise ValueError(f"detect_maps: image {tuple(img.shape)} too large for 32-bit offsets")
    _check("img", img, (h, w), torch.float32, dev)
    if mask is not None:
        _check("mask", mask, (h, w), torch.bool, dev)
    p = plan(h, w)
    sup = torch.empty_like(img)
    off = torch.empty((h, w, 2), dtype=torch.float32, device=dev)
    floor = torch.empty(1, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    counter, maxima = _scratch(dev, stream, p.ctas)
    lib = _build.load()
    err = lib.ptz_harris_nms(
        img.data_ptr(), None if mask is None else mask.data_ptr(), sup.data_ptr(),
        off.data_ptr(), maxima.data_ptr(), counter.data_ptr(), floor.data_ptr(),
        h, w, int(border), float(threshold), float(k), dev.index, stream,
    )
    _build.check(err, "detect_maps")
    global launches, masked_launches
    launches += 1
    masked_launches += mask is not None
    return sup, off, floor
