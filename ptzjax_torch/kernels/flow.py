"""Pyramidal Lucas-Kanade optical flow at fixed-capacity keypoint tables.
Port of ``ptzjax/kernels/flow.py`` (the KLT frontend mode).

Design, as in the reference:
  * pyramid: ``levels`` blur-then-2x-mean-pool downsamples.
  * per level, coarse to fine: iterative LK. The template patch and its
    spatial-gradient normal matrix G (2x2 per keypoint) come from the
    previous frame and stay fixed; each Newton step resamples the next
    frame at the current guess, forms the image-difference vector b and
    applies the closed-form 2x2 solve. All K keypoints advance together.
  * validity: the G min-eigenvalue (Shi-Tomasi), in-bounds, residual bound
    and the anchored forward-backward check.

On the card ``lk_track`` is two launches of kernel E (``csrc/lk_flow.cu``):
``build_pyramids`` builds both frames' pyramids in one (a CTA a tile of the
top levels, recomputing its halo from level 0 in shared memory), and
``lk_pyramids`` runs every level, the backward check and the tests in the
other (a CTA of four warps a keypoint, its windows in shared memory, the
Newton loop next to them). The plain versions (``build_pyramid_plain``, the
torch blur and pool; ``lk_pyramids_plain``) gather one integer-aligned
window per keypoint and level through ``kernels/window_gather.py`` and
sample inside it with bilinear selection-matrix products, two batched
``torch.bmm`` a step in fp32 (the reference asks for bf16x3 on its TPU; the
port computes in full fp32, TF32 off). They are what runs on the CPU, and on
the card only where a caller asks for them (``lk_track(..., plain=True)``,
for the card's parity checks).

The Newton loop runs a fixed number of iterations (no early exit, no host
read): ``iters`` at level 0 and for the backward check, ``max(3, iters //
2)`` above.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ptzjax_torch import _device
from ptzjax_torch.kernels import _build
from ptzjax_torch.kernels.window_gather import gather_windows

launches = 0           # kernel E's LK launches since the last reset (plain calls not counted)
pyramid_launches = 0   # kernel E's pyramid launches since the last reset

MAX_PATCH = 15     # csrc/lk_flow.cu's kMaxPatch: the largest patch the kernel takes
MAX_LEVELS = 8     # csrc/lk_flow.cu's kMaxLevels
WARPS_PER_CTA = 4  # the warps of a keypoint's CTA (csrc/lk_flow.cu's kThreads / 32)
PYRAMID_LEVELS_A_LAUNCH = 3   # levels a pyramid launch builds (csrc/lk_flow.cu's kPyrBuild)


class FlowResult(NamedTuple):
    """Tracked keypoints in the next frame.

    Attributes:
      xy: (K, 2) tracked (x, y) positions (the input position where not
        tracked).
      tracked: (K,) bool: input-valid, textured, converged in-bounds.
      residual: (K,) mean |I_next - I_prev| over the window at convergence,
        normalized by the template window's std.
    """

    xy: torch.Tensor
    tracked: torch.Tensor
    residual: torch.Tensor


def _edge_pad(img: torch.Tensor, pad: int) -> torch.Tensor:
    """``jnp.pad(img, pad, mode="edge")`` as a clamped-index gather."""
    h, w = img.shape
    rows = torch.arange(-pad, h + pad, device=img.device).clamp(0, h - 1)
    cols = torch.arange(-pad, w + pad, device=img.device).clamp(0, w - 1)
    return img[rows][:, cols].contiguous()


def _binomial5(a: torch.Tensor) -> torch.Tensor:
    """Separable 5-tap binomial blur (1 4 6 4 1)/16, edge-padded, along
    axis 0 then axis 1. The taps are summed in the reference's order
    (Python's ``sum``, from 0)."""
    k = (1 / 16.0, 4 / 16.0, 6 / 16.0, 4 / 16.0, 1 / 16.0)

    def conv(x, axis):
        x = x.movedim(axis, -1)
        n = x.shape[-1]
        xp = x[..., torch.arange(-2, n + 2, device=x.device).clamp(0, n - 1)]
        out = sum(k[i] * xp[..., i : i + n] for i in range(5))
        return out.movedim(-1, axis)

    return conv(conv(a, 0), 1)


def build_pyramid_plain(img: torch.Tensor, levels: int) -> list[torch.Tensor]:
    """Blur-then-2x-subsample pyramid, level 0 = full resolution, in torch:
    the pyramid launch's specification. Every level contiguous (kernel E
    reads them by pointer)."""
    img = img.to(torch.float32).contiguous()
    pyr = [img]
    for _ in range(1, levels):
        a = _binomial5(pyr[-1])
        h, w = a.shape
        a = a[: h - h % 2, : w - w % 2]
        pyr.append(a.reshape(h // 2, 2, w // 2, 2).mean(dim=(1, 3)))
    return pyr


def pyramid_plan(h: int, w: int, levels: int) -> list[tuple[int, int]]:
    """The pyramid launches for an (h, w) frame: (first level built, levels
    built) for each, ``PYRAMID_LEVELS_A_LAUNCH`` levels a launch from level
    1 on (each a grid of 32 x 32 tiles of its first level, a z-slice a
    frame); raises where a level would be empty."""
    if not 1 <= levels <= MAX_LEVELS:
        raise ValueError(f"build_pyramid: the kernel takes 1 to {MAX_LEVELS} levels, got {levels}")
    if h >> (levels - 1) < 1 or w >> (levels - 1) < 1:
        raise ValueError(f"build_pyramid: a {h}x{w} image has no {levels}-level pyramid")
    return [
        (base + 1, min(PYRAMID_LEVELS_A_LAUNCH, levels - 1 - base))
        for base in range(0, levels - 1, PYRAMID_LEVELS_A_LAUNCH)
    ]


def build_pyramids(imgs, levels: int) -> list[list[torch.Tensor]]:
    """The pyramids of one or two (H, W) frames of one shape: for CUDA
    frames levels 1..levels-1 of both in one launch of kernel E's pyramid
    kernel (one a ``PYRAMID_LEVELS_A_LAUNCH`` levels), every level a view of
    one allocation; the plain version for CPU frames."""
    global pyramid_launches
    imgs = [img.to(torch.float32).contiguous() for img in imgs]
    dev = imgs[0].device
    if dev.type == "cpu":
        return [build_pyramid_plain(img, levels) for img in imgs]
    if dev.type != "cuda":
        raise ValueError(f"build_pyramid: unsupported device {dev}")
    if not 1 <= len(imgs) <= 2 or imgs[0].dim() != 2 or any(
        img.shape != imgs[0].shape or img.device != dev for img in imgs
    ):
        raise ValueError(f"build_pyramid: one or two 2-D frames of one shape on one device, got "
                         f"{[(tuple(i.shape), str(i.device)) for i in imgs]}")
    h, w = imgs[0].shape
    steps = pyramid_plan(h, w, levels)
    sizes = [(h >> lvl, w >> lvl) for lvl in range(levels)]
    per_frame = sum(a * b for a, b in sizes[1:])
    buf = torch.empty((len(imgs) * per_frame,), dtype=torch.float32, device=dev)
    pyrs, at = [], 0
    for img in imgs:
        pyr = [img]
        for a, b in sizes[1:]:
            pyr.append(buf[at : at + a * b].view(a, b))
            at += a * b
        pyrs.append(pyr)
    lib = _build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for first, n in steps:
        ptrs = ctypes.c_void_p * len(imgs)
        outs = ctypes.c_void_p * (len(imgs) * n)
        dims = ctypes.c_int * (n + 1)
        err = lib.ptz_pyramid(
            ptrs(*(pyr[first - 1].data_ptr() for pyr in pyrs)),
            outs(*(pyr[first + k].data_ptr() for pyr in pyrs for k in range(n))),
            dims(*(sizes[first - 1 + k][0] for k in range(n + 1))),
            dims(*(sizes[first - 1 + k][1] for k in range(n + 1))),
            len(imgs), n, dev.index, stream,
        )
        _build.check(err, "build_pyramid")
        pyramid_launches += 1
    return pyrs


def build_pyramid(img: torch.Tensor, levels: int) -> list[torch.Tensor]:
    """Blur-then-2x-subsample pyramid, level 0 = full resolution; every
    level contiguous (kernel E reads them by pointer): ``build_pyramids`` of
    one frame."""
    return build_pyramids([img], levels)[0]


def _gather(pimg: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor, size: int) -> torch.Tensor:
    """(K, size, size) windows ``pimg[ys:ys+size, xs:xs+size]``: kernel B on
    the card, its plain gather on the CPU."""
    return gather_windows(pimg, ys.to(torch.int32).contiguous(), xs.to(torch.int32).contiguous(), size - 1)


def _patch_starts(img: torch.Tensor, xy: torch.Tensor, patch: int):
    """The edge-padded image, the int32 starts of the (patch+1)-side windows
    ``_sample_patches`` blends, and the fractional offsets (K, 1, 1)."""
    h, w = img.shape
    c = patch // 2
    win = patch + 1
    pad = c + 1
    pimg = _edge_pad(img, pad)
    y0 = torch.floor(xy[:, 1]).to(torch.int32)
    x0 = torch.floor(xy[:, 0]).to(torch.int32)
    fy = (xy[:, 1] - y0).clamp(0.0, 1.0)[:, None, None]
    fx = (xy[:, 0] - x0).clamp(0.0, 1.0)[:, None, None]
    ys = (y0 - c + pad).clamp(0, h + 2 * pad - win)
    xs = (x0 - c + pad).clamp(0, w + 2 * pad - win)
    return pimg, ys, xs, fy, fx


def _sample_patches(img: torch.Tensor, xy: torch.Tensor, patch: int) -> torch.Tensor:
    """(K, patch, patch) bilinear patches centered on subpixel ``xy``: sample
    p of a patch sits at xy + (p - (patch-1)/2) (odd patch sizes; the
    selection-matrix sampler in ``_lk_level`` uses the same convention)."""
    pimg, ys, xs, fy, fx = _patch_starts(img, xy, patch)
    windows = _gather(pimg, ys, xs, patch + 1)           # (K, patch+1, patch+1)
    return (
        windows[:, :-1, :-1] * (1 - fy) * (1 - fx)
        + windows[:, :-1, 1:] * (1 - fy) * fx
        + windows[:, 1:, :-1] * fy * (1 - fx)
        + windows[:, 1:, 1:] * fy * fx
    )                                                    # (K, patch, patch)


# in-level displacement budget (px) the per-keypoint search window covers
_DISP = 5


def _search_starts(img: torch.Tensor, xy: torch.Tensor, win: int, anchor_off: int):
    """The image edge-padded by ``win`` and the int32 starts of the
    ``_extract_windows`` windows: pixel (anchor_off, anchor_off) of a window
    sits at round(xy) (half to even, as ``jnp.round``)."""
    h, w = img.shape
    pimg = _edge_pad(img, win)
    y0 = torch.round(xy[:, 1]).to(torch.int32) - anchor_off
    x0 = torch.round(xy[:, 0]).to(torch.int32) - anchor_off
    ys = (y0 + win).clamp(0, h + win)
    xs = (x0 + win).clamp(0, w + win)
    return pimg, ys, xs


def _extract_windows(img: torch.Tensor, xy: torch.Tensor, win: int, anchor_off: int):
    """(K, win, win) integer-aligned search windows (``_search_starts``).
    Returns (windows, anchor), anchor the image position of window pixel
    (0, 0)."""
    pimg, ys, xs = _search_starts(img, xy, win, anchor_off)
    windows = _gather(pimg, ys, xs, win)
    anchor = torch.stack([xs - win, ys - win], -1).to(torch.float32)   # (K, 2)
    return windows, anchor


def _sel_weights(pos: torch.Tensor, patch: int, win: int) -> torch.Tensor:
    """(K, patch, win) bilinear selection matrices: row p samples window
    coordinate pos + p, clamped to the window (edge behaviour)."""
    dev = pos.device
    p = torch.arange(patch, dtype=torch.float32, device=dev)[None, :, None]
    wco = torch.arange(win, dtype=torch.float32, device=dev)[None, None, :]
    t = (pos[:, None, None] + p).clamp(0.0, win - 1.0)
    return (1.0 - (t - wco).abs()).clamp(0.0, 1.0)


def _lk_level(prev, nxt, xy_prev, guess, patch: int, iters: int):
    """One pyramid level of iterative LK for all keypoints. The next frame's
    windows are gathered once; every Newton step samples inside them with
    selection-matrix products.

    Returns (refined guess (K, 2), min_eig (K,), residual (K,)).
    """
    # template + fixed spatial gradients from the previous frame
    tmpl_w = _sample_patches(prev, xy_prev, patch + 2)   # (K, P+2, P+2)
    tmpl = tmpl_w[:, 1:-1, 1:-1]
    gx = 0.5 * (tmpl_w[:, 1:-1, 2:] - tmpl_w[:, 1:-1, :-2])
    gy = 0.5 * (tmpl_w[:, 2:, 1:-1] - tmpl_w[:, :-2, 1:-1])
    gxx = (gx * gx).sum(dim=(1, 2))
    gxy = (gx * gy).sum(dim=(1, 2))
    gyy = (gy * gy).sum(dim=(1, 2))
    det = gxx * gyy - gxy * gxy
    tr = gxx + gyy
    min_eig = 0.5 * (tr - torch.sqrt((tr * tr - 4.0 * det).clamp_min(0.0)))
    min_eig = min_eig / (patch * patch)  # per pixel, like cv2's minEigThreshold
    inv_det = torch.where(det > 1e-12, 1.0 / det.clamp_min(1e-12), 0.0)

    # next-frame windows around the initial guess, wide enough for the
    # whole in-level search (_DISP px each way)
    win = patch + 2 * _DISP + 1
    windows, anchor = _extract_windows(nxt, guess, win, _DISP + patch // 2)

    def sample(g):
        # corner of the patch in window coordinates (fractional); the
        # reference's "kpw,kwv,kqv->kpq" as two products in a fixed order
        corner = g - anchor - (patch - 1) / 2.0          # (K, 2) x, y
        sy = _sel_weights(corner[:, 1], patch, win)      # (K, P, W)
        sx = _sel_weights(corner[:, 0], patch, win)
        return torch.bmm(torch.bmm(sy, windows), sx.transpose(1, 2))   # (K, P, P)

    for _ in range(iters):
        di = tmpl - sample(guess)
        bx = (di * gx).sum(dim=(1, 2))
        by = (di * gy).sum(dim=(1, 2))
        dx = inv_det * (gyy * bx - gxy * by)
        dy = inv_det * (gxx * by - gxy * bx)
        guess = guess + torch.stack([dx, dy], -1)
    # residual normalized by the template's contrast (population std)
    tstd = tmpl.std(dim=(1, 2), correction=0)
    resid = (tmpl - sample(guess)).abs().mean(dim=(1, 2))
    resid = resid / tstd.clamp_min(1e-6)
    return guess, min_eig, resid


def _lk_forward(prev_pyr, next_pyr, xy, patch: int, iters: int):
    """Coarse-to-fine LK through prebuilt pyramids; returns (xy_next,
    min_eig at level 0, residual at level 0). Levels above 0 run
    ``max(3, iters // 2)`` Newton steps, level 0 the full ``iters``."""
    levels = len(prev_pyr)
    guess = xy / 2.0 ** (levels - 1)
    min_eig = resid = None
    coarse_iters = max(3, iters // 2)
    for lvl in range(levels - 1, -1, -1):
        s = 2.0**lvl
        guess, min_eig, resid = _lk_level(
            prev_pyr[lvl], next_pyr[lvl], xy / s, guess, patch,
            iters if lvl == 0 else coarse_iters,
        )
        if lvl > 0:
            guess = guess * 2.0
    return guess, min_eig, resid


def plan(num: int, levels: int, patch: int, h: int, w: int) -> int:
    """Kernel E's LK CTAs for ``num`` keypoints on an (h, w) image, one a
    keypoint (``WARPS_PER_CTA`` warps each); raises for
    what the kernel does not take: a patch that is even or above
    ``MAX_PATCH``, levels outside 1..``MAX_LEVELS``, a pyramid whose top
    level would be empty."""
    if not 1 <= levels <= MAX_LEVELS:
        raise ValueError(f"lk_track: the kernel takes 1 to {MAX_LEVELS} levels, got {levels}")
    if patch % 2 == 0 or not 1 <= patch <= MAX_PATCH:
        raise ValueError(f"lk_track: the kernel takes an odd patch of 1 to {MAX_PATCH}, got {patch}")
    if h >> (levels - 1) < 1 or w >> (levels - 1) < 1:
        raise ValueError(f"lk_track: a {h}x{w} image has no {levels}-level pyramid")
    return num


def lk_pyramids_plain(
    prev_pyr, next_pyr, xy, valid, *, patch: int, iters: int, min_eig: float,
    max_residual: float, fb_check: bool, fb_tol: float, border: float,
) -> FlowResult:
    """``lk_track`` through prebuilt pyramids with plain torch ops (and kernel
    B's window gathers on the card): kernel E's specification."""
    new_xy, eig, resid = _lk_forward(prev_pyr, next_pyr, xy, patch, iters)

    h, w = next_pyr[0].shape
    ok = (
        valid
        & (eig > min_eig)
        & (resid < max_residual)
        & (new_xy[:, 0] >= border)
        & (new_xy[:, 0] <= w - 1 - border)
        & (new_xy[:, 1] >= border)
        & (new_xy[:, 1] <= h - 1 - border)
        & torch.isfinite(new_xy).all(-1)
    )
    if fb_check:
        # backward CHECK, not a backward search: one full-resolution level
        # with its window anchored at the original xy (template from
        # img_next at new_xy, searched in img_prev)
        back_xy, _, _ = _lk_level(next_pyr[0], prev_pyr[0], new_xy, xy, patch, iters)
        ok = ok & (torch.linalg.vector_norm(back_xy - xy, dim=-1) < fb_tol)

    new_xy = torch.where(ok[:, None], new_xy, xy)
    return FlowResult(xy=new_xy, tracked=ok, residual=resid)


def lk_pyramids(
    prev_pyr, next_pyr, xy, valid, *, patch: int, iters: int, min_eig: float,
    max_residual: float, fb_check: bool, fb_tol: float, border: float,
) -> FlowResult:
    """``lk_track`` through prebuilt pyramids (lists of (H_l, W_l) fp32
    levels, the same shapes for both frames): one launch of kernel E for
    CUDA tensors, the plain version for CPU tensors."""
    opts = dict(
        patch=patch, iters=iters, min_eig=min_eig, max_residual=max_residual,
        fb_check=fb_check, fb_tol=fb_tol, border=border,
    )
    dev = xy.device
    if dev.type == "cpu":
        return lk_pyramids_plain(prev_pyr, next_pyr, xy, valid, **opts)
    if dev.type != "cuda":
        raise ValueError(f"lk_track: unsupported device {dev}")
    levels = len(prev_pyr)
    h, w = next_pyr[0].shape
    ctas = plan(xy.shape[0], levels, patch, h, w)
    if len(next_pyr) != levels or any(a.shape != b.shape for a, b in zip(prev_pyr, next_pyr)):
        raise ValueError("lk_track: the two frames' pyramids differ in shape")
    for img in (*prev_pyr, *next_pyr):
        if img.device != dev or img.dtype != torch.float32 or not img.is_contiguous():
            raise ValueError(f"lk_track: pyramid levels must be contiguous float32 on {dev}")
    xy = xy.to(torch.float32).contiguous()
    valid = valid.to(device=dev, dtype=torch.bool).contiguous()
    if xy.shape != (valid.shape[0], 2):
        raise ValueError(f"lk_track: xy {tuple(xy.shape)} and valid {tuple(valid.shape)}")
    num = xy.shape[0]
    out_xy = torch.empty_like(xy)
    tracked = torch.empty((num,), dtype=torch.bool, device=dev)
    residual = torch.empty((num,), dtype=torch.float32, device=dev)
    if ctas == 0:
        return FlowResult(xy=out_xy, tracked=tracked, residual=residual)
    ptrs = ctypes.c_void_p * levels
    dims = ctypes.c_int * levels
    lib = _build.load()
    err = lib.ptz_lk_flow(
        ptrs(*(a.data_ptr() for a in prev_pyr)), ptrs(*(a.data_ptr() for a in next_pyr)),
        dims(*(a.shape[0] for a in next_pyr)), dims(*(a.shape[1] for a in next_pyr)), levels,
        xy.data_ptr(), valid.data_ptr(), out_xy.data_ptr(), tracked.data_ptr(), residual.data_ptr(),
        num, patch, iters, max(3, iters // 2), min_eig, max_residual, border,
        w - 1 - border, h - 1 - border, fb_tol, int(fb_check), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "lk_track")
    global launches
    launches += 1
    return FlowResult(xy=out_xy, tracked=tracked, residual=residual)


def lk_track(
    img_prev,
    img_next,
    xy,
    valid,
    *,
    levels: int = 4,
    patch: int = 13,
    iters: int = 8,
    min_eig: float = 1e-3,
    max_residual: float = 0.5,
    fb_check: bool = True,
    fb_tol: float = 1.0,
    border: float = 2.0,
    device=None,
    plain: bool = False,
) -> FlowResult:
    """Track keypoints from ``img_prev`` to ``img_next``.

    Args:
      img_prev, img_next: (H, W) float grayscale frames.
      xy: (K, 2) keypoint positions (x, y) in ``img_prev``.
      valid: (K,) bool input mask.
      levels: pyramid levels.
      patch: LK window side (odd).
      iters: Newton iterations per level.
      min_eig: Shi-Tomasi per-pixel min-eigenvalue threshold.
      max_residual: reject tracks whose mean abs window error exceeds this
        fraction of the template's own std.
      fb_check: also run the anchored backward check and reject round trips
        longer than ``fb_tol`` px.
      border: reject tracks within this many pixels of the image edge.
      device: where to run; by default the device of ``img_prev`` if it is
        a tensor, else the card (raising where there is none).
      plain: on the card, run the plain versions instead of kernel E's two
        launches (for the card's parity checks; the main path never asks
        for it).

    Returns:
      FlowResult with the same capacity K, on that device.
    """
    dev = _device.resolve(device, img_prev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"lk_track: unsupported device {dev}")
    img_prev, img_next, xy, valid = (
        torch.as_tensor(v, device=dev) for v in (img_prev, img_next, xy, valid)
    )
    xy = xy.to(torch.float32)
    opts = dict(
        patch=patch, iters=iters, min_eig=min_eig, max_residual=max_residual,
        fb_check=fb_check, fb_tol=fb_tol, border=border,
    )
    if plain:
        prev_pyr, next_pyr = (build_pyramid_plain(img, levels) for img in (img_prev, img_next))
        return lk_pyramids_plain(prev_pyr, next_pyr, xy, valid, **opts)
    if dev.type == "cuda":   # refuse what the LK launch does not take before the pyramid launch
        plan(xy.shape[0], levels, patch, *img_prev.shape[-2:])
    prev_pyr, next_pyr = build_pyramids([img_prev, img_next], levels)
    return lk_pyramids(prev_pyr, next_pyr, xy, valid, **opts)
