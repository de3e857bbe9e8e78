"""Frame visualization: keypoints, matches, reprojected map rays. A jax-free
copy of ``ptzjax/viz.py``: pure numpy in, (H, W, 3) uint8 out, PNG through
matplotlib (imported only when a file is written); no device work.
"""

from __future__ import annotations

import numpy as np

# categorical palette (see plots.py): keypoints=blue, matches=aqua,
# reprojections=orange, rejected/lost=red
_KP = (42, 120, 214)
_MATCH = (27, 175, 122)
_PROJ = (235, 104, 52)
_BAD = (227, 73, 72)


def _to_rgb(img: np.ndarray) -> np.ndarray:
    """Grayscale (H, W) float/uint8 -> (H, W, 3) uint8."""
    img = np.asarray(img)
    if img.ndim == 3:
        out = img.astype(np.float64)
    else:
        out = np.repeat(img.astype(np.float64)[..., None], 3, axis=-1)
    lo, hi = out.min(), out.max()
    if hi > lo:
        out = (out - lo) / (hi - lo) * 255.0
    return out.astype(np.uint8)


def _disk(canvas: np.ndarray, x: float, y: float, r: int, color) -> None:
    h, w = canvas.shape[:2]
    xi, yi = int(round(x)), int(round(y))
    if not (0 <= xi < w and 0 <= yi < h):
        return
    y0, y1 = max(0, yi - r), min(h, yi + r + 1)
    x0, x1 = max(0, xi - r), min(w, xi + r + 1)
    yy, xx = np.mgrid[y0:y1, x0:x1]
    mask = (yy - yi) ** 2 + (xx - xi) ** 2 <= r * r
    canvas[y0:y1, x0:x1][mask] = color


def _line(canvas: np.ndarray, a, b, color) -> None:
    h, w = canvas.shape[:2]
    n = int(max(abs(b[0] - a[0]), abs(b[1] - a[1]), 1)) + 1
    xs = np.linspace(a[0], b[0], n).round().astype(int)
    ys = np.linspace(a[1], b[1], n).round().astype(int)
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    canvas[ys[ok], xs[ok]] = color


def draw_keypoints(
    img: np.ndarray,
    xy: np.ndarray,
    valid: np.ndarray | None = None,
    radius: int = 3,
    color=_KP,
) -> np.ndarray:
    """Render keypoints as filled disks. Returns an (H, W, 3) uint8 image."""
    canvas = _to_rgb(img)
    xy = np.asarray(xy)
    valid = np.ones(len(xy), bool) if valid is None else np.asarray(valid, bool)
    for (x, y), ok in zip(xy, valid):
        if ok:
            _disk(canvas, x, y, radius, color)
    return canvas


def draw_matches(
    img_a: np.ndarray,
    xy_a: np.ndarray,
    img_b: np.ndarray,
    xy_b: np.ndarray,
    ok: np.ndarray,
    max_draw: int = 200,
) -> np.ndarray:
    """Side-by-side match visualization (the classic cv2.drawMatches view):
    frames stacked horizontally, a line per surviving match."""
    a, b = _to_rgb(img_a), _to_rgb(img_b)
    h = max(a.shape[0], b.shape[0])
    canvas = np.zeros((h, a.shape[1] + b.shape[1], 3), np.uint8)
    canvas[: a.shape[0], : a.shape[1]] = a
    canvas[: b.shape[0], a.shape[1] :] = b
    off = a.shape[1]
    idx = np.flatnonzero(np.asarray(ok, bool))[:max_draw]
    for i in idx:
        pa = (float(xy_a[i][0]), float(xy_a[i][1]))
        pb = (float(xy_b[i][0]) + off, float(xy_b[i][1]))
        _line(canvas, pa, pb, _MATCH)
        _disk(canvas, *pa, 2, _KP)
        _disk(canvas, *pb, 2, _KP)
    return canvas


def draw_tracking(
    img: np.ndarray,
    obs_xy: np.ndarray,
    pred_xy: np.ndarray,
    used: np.ndarray,
    offered: np.ndarray | None = None,
) -> np.ndarray:
    """Tracking diagnostics for one frame: observed keypoints (blue), the
    filter's predicted positions (orange), innovation segments between them
    (aqua when used, red when gated out)."""
    canvas = _to_rgb(img)
    used = np.asarray(used, bool)
    offered = used if offered is None else np.asarray(offered, bool)
    for i in np.flatnonzero(offered):
        po = (float(obs_xy[i][0]), float(obs_xy[i][1]))
        pp = (float(pred_xy[i][0]), float(pred_xy[i][1]))
        _line(canvas, po, pp, _MATCH if used[i] else _BAD)
        _disk(canvas, *po, 2, _KP)
        _disk(canvas, *pp, 2, _PROJ)
    return canvas


def save_png(path: str, img: np.ndarray) -> str:
    """Write an (H, W[, 3]) image as PNG (matplotlib backend, no cv2 dep)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.imsave(path, np.asarray(img))
    return path
