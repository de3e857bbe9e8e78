"""The yardstick of the kernels' roofline shares: the H100's peaks and the
bytes and fp32 operations each of the port's kernels needs, from its
shapes or, where the work depends on the data, from the cell's own frames
through the plain reference. A frozen copy of ``chip_smoke.py``'s
``bound``, ``lk_work``, ``pyramid_work`` and ``describe_work`` and of its
counts for kernels A, C and D (``harris_nms_phase``, ``matcher_phase``,
``cholesky_phase``), with the reference's functions in place of the
port's.

A share is the least time the card could take for the launches, the larger
of their bytes at ``PEAK_BYTES`` and their operations at ``PEAK_FP32``,
over the launches' device time in the trace. Peaks: NVIDIA's H100 SXM data
sheet at its 700 W power limit; a run prints the card's own limit beside
its numbers.
"""

from __future__ import annotations

import torch

from ptzbench.reference.kernels import descriptor as kd
from ptzbench.reference.kernels import flow as fl

PEAK_BYTES = 3.35e12   # H100 SXM HBM3, bytes/s
PEAK_FP32 = 67e12      # H100 SXM fp32 outside the tensor cores, flop/s


def bound_s(nbytes: float, ops: float) -> float:
    """The least seconds the card could take to move ``nbytes`` and do
    ``ops`` fp32 operations."""
    return max(nbytes / PEAK_BYTES, ops / PEAK_FP32)


def share_pct(works: list[tuple[float, float]], device_s: float) -> float | None:
    """100 x the summed bounds of ``works`` ((bytes, ops) a launch) over
    ``device_s``, their device time; None where there is nothing to read."""
    if not works or device_s <= 0:
        return None
    return 100.0 * sum(bound_s(b, o) for b, o in works) / device_s


def harris_nms_work(h: int, w: int, masked: bool = False) -> tuple[float, float]:
    """Kernel A on an (h, w) frame: the image read and ``sup`` written once
    (and the mask read), the floor; 78 fp32 operations a pixel (2
    differences and 2 scalings, 3 products, 2 x 3 five-tap passes of 5
    multiplies and 4 adds, 7 for the response, 10 for the NMS). The 8 B
    and 14 operations of each survivor's fit are left out (some thousands
    of survivors: under 1% of either)."""
    return 8 * h * w + (h * w if masked else 0) + 4, 78 * h * w


def match_work(q: int, r: int, d: int, gated: bool, mutual: bool) -> tuple[float, float]:
    """Kernel C on Q query and R reference rows of D floats: 2 Q R D
    operations; the descriptors, validity (and positions) read once, the
    per-row (and per-column) results written once."""
    nbytes = 4 * (q + r) * d + (q + r) + (8 * (q + r) if gated else 0) + 12 * q + (4 * r if mutual else 0)
    return nbytes, 2 * q * r * d


def cholesky_work(n: int) -> tuple[float, float]:
    """Kernel D on an (n, n) matrix: n^3 / 3 operations; the lower triangle
    read and the factor written once, and the info flag."""
    return 4 * (n * (n + 1) // 2 + n * n) + 4, n**3 / 3


def pyramid_work(h: int, w: int, levels: int, frames: int) -> tuple[float, float]:
    """Kernel E's pyramid launch on ``frames`` (h, w) frames at ``levels``
    levels. Bytes: level 0 read once and levels 1..levels-1 written once,
    4 B a pixel. Operations, for each level built from the one below: the
    vertical blur at the 2 h_l+1 rows the pool reads and every column, 9 a
    value, the horizontal blur at the 2 h_l+1 x 2 w_l+1 pooled pixels, 9
    each, and the pool, 4 an output."""
    sizes = [(h >> lvl, w >> lvl) for lvl in range(levels)]
    nbytes = 4 * (h * w + sum(a * b for a, b in sizes[1:]))
    ops = sum(
        9 * 2 * hn * wl + 9 * 4 * hn * wn + 4 * hn * wn
        for (_, wl), (hn, wn) in zip(sizes, sizes[1:])
    )
    return frames * nbytes, frames * ops


def _window_pixels(img: torch.Tensor, tops: torch.Tensor, lefts: torch.Tensor, side: int) -> torch.Tensor:
    """Flat indices of the pixels of ``img`` that side x side windows at
    image (top, left), rows and columns clamped into the image, cover."""
    h, w = img.shape
    r = torch.arange(side, device=img.device)
    rows = (tops.long()[:, None] + r).clamp(0, h - 1)
    cols = (lefts.long()[:, None] + r).clamp(0, w - 1)
    return (rows[:, :, None] * w + cols[:, None, :]).reshape(-1)


def lk_work(prev_pyr, next_pyr, xy, valid, patch, iters, min_eig, max_residual, fb_check, border, **_) -> tuple[float, float]:
    """Kernel E's LK launch for these inputs. Bytes: the pixels its
    windows cover in each level of each frame, each read once (the windows
    follow the guesses the plain route's own steps give), 9 B of position
    and flag read and 13 B of results written a keypoint. Operations, for
    each pass over a keypoint (every level for a finite position, the
    backward check where the forward tests passed): the template blend,
    (patch + 2)^2 x 11, the gradients, G and the std, patch^2 x 14, 12 a
    sample and Newton step and 10 a sample for the residual."""
    levels = len(prev_pyr)
    finite = torch.isfinite(xy).all(-1)
    xs = xy[finite]
    pixels: dict = {}
    guess = xs / 2.0 ** (levels - 1)
    side_s, anchor = patch + 2 * fl._DISP + 1, fl._DISP + patch // 2
    pad_t = (patch + 2) // 2 + 1
    coarse = max(3, iters // 2)
    steps = 0
    for lvl in range(levels - 1, -1, -1):
        at = xs / 2.0**lvl
        _, ys_t, xs_t, _, _ = fl._patch_starts(prev_pyr[lvl], at, patch + 2)
        pixels.setdefault(("prev", lvl), []).append(_window_pixels(prev_pyr[lvl], ys_t - pad_t, xs_t - pad_t, patch + 3))
        _, ys_s, xs_s = fl._search_starts(next_pyr[lvl], guess, side_s, anchor)
        pixels.setdefault(("next", lvl), []).append(_window_pixels(next_pyr[lvl], ys_s - side_s, xs_s - side_s, side_s))
        n_it = iters if lvl == 0 else coarse
        guess, eig, resid = fl._lk_level(prev_pyr[lvl], next_pyr[lvl], at, guess, patch, n_it)
        steps += n_it
        if lvl > 0:
            guess = guess * 2.0
    h, w = next_pyr[0].shape
    ok = (
        valid[finite] & (eig > min_eig) & (resid < max_residual) & (guess[:, 0] >= border)
        & (guess[:, 0] <= w - 1 - border) & (guess[:, 1] >= border) & (guess[:, 1] <= h - 1 - border)
        & torch.isfinite(guess).all(-1)
    )
    n_fb = int(ok.sum()) if fb_check else 0
    if n_fb:
        _, ys_t, xs_t, _, _ = fl._patch_starts(next_pyr[0], guess[ok], patch + 2)
        pixels[("next", 0)].append(_window_pixels(next_pyr[0], ys_t - pad_t, xs_t - pad_t, patch + 3))
        _, ys_s, xs_s = fl._search_starts(prev_pyr[0], xs[ok], side_s, anchor)
        pixels[("prev", 0)].append(_window_pixels(prev_pyr[0], ys_s - side_s, xs_s - side_s, side_s))
    covered = sum(torch.unique(torch.cat(v)).numel() for v in pixels.values())
    nbytes = 4 * covered + 22 * xy.shape[0]
    per_pass = (patch + 2) ** 2 * 11 + patch**2 * 14
    ops = (
        int(finite.sum()) * (levels * per_pass + patch**2 * (12 * steps + 10 * levels))
        + n_fb * (per_pass + patch**2 * (12 * iters + 10))
    )
    return nbytes, ops


def describe_reads(h: int, w: int, xy: torch.Tensor, scale) -> tuple[torch.Tensor, torch.Tensor]:
    """The image pixels each row's descriptor depends on: (flat indices (K,
    n) of the (h, w) image, blended-sample mask of the aligned window). The
    gradients read every aligned sample of the 18 x 18 grid but its 4
    corners; with a scale, a sample reads the blended window at the
    resample's nonzero taps; a blended sample reads its 2 x 2 window
    pixels."""
    side = kd.PATCH + 2
    grid = torch.ones(side, side)
    grid[0, 0] = grid[0, -1] = grid[-1, 0] = grid[-1, -1] = 0.0
    if scale is None:
        win, blended = side, grid > 0
    else:
        win = kd.SCALED_WIN
        s = torch.as_tensor(scale, dtype=torch.float32).cpu().clamp(1.0 / kd.MAX_SCALE, kd.MAX_SCALE)
        taps = (kd._resample_matrix(s, side, win) != 0).to(torch.float32)
        blended = taps.T @ grid @ taps > 0
    raw = torch.zeros(win + 1, win + 1, dtype=torch.bool)
    for dy in (0, 1):
        for dx in (0, 1):
            raw[dy : dy + win, dx : dx + win] |= blended
    rows, cols = kd._window_pixels(h, w, xy, win)
    return (rows[:, :, None] * w + cols[:, None, :])[:, raw.to(rows.device)], blended


def describe_work(img: torch.Tensor, xy: torch.Tensor, valid: torch.Tensor, scale) -> tuple[float, float]:
    """Kernel F on these inputs, from the samples the descriptor depends on
    (``describe_reads``). Bytes: those pixels of the valid rows, each image
    pixel once, the scale, 9 B of position and flag read and 512 B of
    descriptor written a keypoint. Operations, a valid keypoint: 11 a
    needed blended sample; with a scale, 3 a tap pair of the separable
    resample; 16 a patch pixel for its gradient, magnitude, orientation and
    bins; the histogram's nonzero terms, 3 each, and 4 a pixel for its
    orientation weights; 10 a bin for the normalization."""
    side, pix = kd.PATCH + 2, kd.PATCH * kd.PATCH
    h, w = img.shape
    pixels, blended = describe_reads(h, w, xy[valid], scale)
    resample = 0 if scale is None else (int(blended.any(1).sum()) * side + side * side) * 3
    covered = torch.unique(pixels.reshape(-1)).numel()
    num, n_valid = xy.shape[0], int(valid.sum())
    nonzero = int((kd._spatial_weights(img.device) != 0).sum())
    nbytes = 4 * covered + (0 if scale is None else 4) + num * (9 + 4 * kd.DESC_DIM)
    per_kp = 11 * int(blended.sum()) + resample + 16 * pix + 3 * 2 * nonzero + 4 * pix + 10 * kd.DESC_DIM
    return nbytes, n_valid * per_kp
