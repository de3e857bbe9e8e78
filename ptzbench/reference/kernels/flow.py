"""Pyramidal Lucas-Kanade tracking in plain torch. A frozen copy of the
plain versions in ``ptzjax_torch/kernels/flow.py`` (``build_pyramid_plain``,
``lk_pyramids_plain``), which the port's kernel E (``csrc/lk_flow.cu``) is
held to.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ptzbench.reference import _device
from ptzbench.reference.kernels.window_gather import gather_windows


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


def build_pyramids(imgs, levels: int) -> list[list[torch.Tensor]]:
    """``build_pyramid_plain`` of each frame."""
    return [build_pyramid_plain(img.to(torch.float32).contiguous(), levels) for img in imgs]


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


def lk_track(
    img_prev, img_next, xy, valid, *, levels: int = 4, patch: int = 13, iters: int = 8,
    min_eig: float = 1e-3, max_residual: float = 0.5, fb_check: bool = True,
    fb_tol: float = 1.0, border: float = 2.0, device=None,
) -> FlowResult:
    """Track keypoints from ``img_prev`` to ``img_next`` with the plain
    pyramids and ``lk_pyramids_plain`` (see the port's ``lk_track`` for the
    arguments)."""
    dev = _device.resolve(device, img_prev)
    img_prev, img_next, xy, valid = (
        torch.as_tensor(v, device=dev) for v in (img_prev, img_next, xy, valid)
    )
    prev_pyr, next_pyr = build_pyramids([img_prev, img_next], levels)
    return lk_pyramids_plain(
        prev_pyr, next_pyr, xy.to(torch.float32), valid, patch=patch, iters=iters, min_eig=min_eig,
        max_residual=max_residual, fb_check=fb_check, fb_tol=fb_tol, border=border,
    )
