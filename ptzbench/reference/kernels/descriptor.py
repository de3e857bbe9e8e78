"""Upright SIFT-like descriptors in plain torch. A frozen copy of the plain
version in ``ptzjax_torch/kernels/descriptor.py``, which the port's kernel
F (``csrc/describe.cu``) is held to.
"""

from __future__ import annotations

import functools
import math

import torch

from ptzbench.reference.kernels.window_gather import gather_windows


PATCH = 16          # patch side (pixels)
CELLS = 4           # spatial cells per side
ORI_BINS = 8
DESC_DIM = CELLS * CELLS * ORI_BINS  # 128

# scaled-sampling window (PTZ zoom normalization): big enough to resample a
# (PATCH+2)-sample grid at spacing up to MAX_SCALE from its center
MAX_SCALE = 2.5
SCALED_WIN = 46


def _patch_grid(device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Sample offsets relative to the keypoint: PATCH x PATCH centered."""
    c = (PATCH - 1) / 2.0
    off = torch.arange(PATCH, dtype=torch.float32, device=device) - c
    dy, dx = torch.meshgrid(off, off, indexing="ij")
    return dy.reshape(-1), dx.reshape(-1)  # (P*P,)


@functools.lru_cache(maxsize=None)
def _spatial_weights(device=None) -> torch.Tensor:
    """(P*P, CELLS*CELLS) bilinear cell weights x Gaussian window, computed
    once per device (the reference's jit folds it into a constant); callers
    only read it."""
    dy, dx = _patch_grid(device)
    sigma = PATCH / 2.0
    gauss = torch.exp(-(dx * dx + dy * dy) / (2.0 * sigma * sigma))
    # cell coordinate in [ -0.5, CELLS-0.5 ]
    cell = (torch.stack([dy, dx], -1) + PATCH / 2.0) / (PATCH / CELLS) - 0.5
    w = []
    for cy in range(CELLS):
        for cx in range(CELLS):
            wy = (1.0 - (cell[:, 0] - cy).abs()).clamp(0.0, 1.0)
            wx = (1.0 - (cell[:, 1] - cx).abs()).clamp(0.0, 1.0)
            w.append(wy * wx)
    return (torch.stack(w, -1) * gauss[:, None]).contiguous()  # (P*P, C*C)


def _starts(xy: torch.Tensor, h: int, w: int, win: int):
    """int32 starts of the (win+1)-side windows in the image edge-padded by
    win // 2 + 1, and the fractional offsets (K, 1, 1)."""
    half = win // 2
    pad = half + 1
    y0 = torch.floor(xy[:, 1] + 0.5).to(torch.int32)
    x0 = torch.floor(xy[:, 0] + 0.5).to(torch.int32)
    fy = (xy[:, 1] + 0.5 - y0).clamp(0.0, 1.0)[:, None, None]
    fx = (xy[:, 0] + 0.5 - x0).clamp(0.0, 1.0)[:, None, None]
    # sub row i samples y + (i - (win-1)/2): symmetric half-integer grid
    ys = (y0 - half + pad).clamp(0, h + 2 * pad - win - 1).to(torch.int32)
    xs = (x0 - half + pad).clamp(0, w + 2 * pad - win - 1).to(torch.int32)
    return ys, xs, fy, fx


def _window_starts(img: torch.Tensor, xy: torch.Tensor, win: int):
    """Edge-padded image, int32 window starts and fractional offsets."""
    h, w = img.shape
    pad = win // 2 + 1
    rows = torch.arange(-pad, h + pad, device=img.device).clamp(0, h - 1)
    cols = torch.arange(-pad, w + pad, device=img.device).clamp(0, w - 1)
    pimg = img[rows][:, cols].contiguous()
    return (pimg, *_starts(xy, h, w, win))


def _window_pixels(h: int, w: int, xy: torch.Tensor, win: int):
    """Kernel F's read of the unpadded (h, w) image: the image rows and the
    image columns, (K, win+1) each, of every keypoint's window; the padded
    gather's pixels, its padding written as clamped indices."""
    pad = win // 2 + 1
    ys, xs, _, _ = _starts(xy, h, w, win)
    r = torch.arange(win + 1, device=xy.device)
    rows = (ys.long()[:, None] - pad + r).clamp(0, h - 1)
    cols = (xs.long()[:, None] - pad + r).clamp(0, w - 1)
    return rows, cols


def _blend(patches, fy, fx, win: int) -> torch.Tensor:
    """4-shift bilinear blend over (K, >=win+1, >=win+1) patches: every
    sample of one keypoint shares the same fractional offset."""
    return (
        patches[:, :win, :win] * (1 - fy) * (1 - fx)
        + patches[:, :win, 1 : win + 1] * (1 - fy) * fx
        + patches[:, 1 : win + 1, :win] * fy * (1 - fx)
        + patches[:, 1 : win + 1, 1 : win + 1] * fy * fx
    )                                                    # (K, win, win)


def _extract_aligned(img: torch.Tensor, xy: torch.Tensor, win: int) -> torch.Tensor:
    """Per-keypoint (win, win) windows, subpixel-aligned to the keypoint."""
    pimg, ys, xs, fy, fx = _window_starts(img, xy, win)
    patches = gather_windows(pimg, ys, xs, win)          # (K, win+1, win+1)
    return _blend(patches, fy, fx, win)


def _resample_matrix(scale: torch.Tensor, n_out: int, win: int) -> torch.Tensor:
    """(n_out, win) shared bilinear resampling weights: output sample i sits
    at (i - (n_out-1)/2) * scale from the window center."""
    dev = scale.device
    off = (torch.arange(n_out, dtype=torch.float32, device=dev) - (n_out - 1) / 2.0) * scale
    pos = off + (win - 1) / 2.0                          # (n_out,)
    j = torch.arange(win, dtype=torch.float32, device=dev)
    return (1.0 - (pos[:, None] - j[None, :]).abs()).clamp(0.0, 1.0)


def _aligned_samples(img: torch.Tensor, xy: torch.Tensor, scale) -> torch.Tensor:
    """(K, P+2, P+2) samples on each keypoint's grid: the blended
    (P+2)-window, or with a scale the blended SCALED_WIN-window resampled at
    that spacing."""
    if scale is None:
        return _extract_aligned(img, xy, PATCH + 2)
    s = torch.as_tensor(scale, dtype=torch.float32, device=img.device).clamp(
        1.0 / MAX_SCALE, MAX_SCALE
    )
    windows = _extract_aligned(img, xy, SCALED_WIN)      # (K, W, W)
    r = _resample_matrix(s, PATCH + 2, SCALED_WIN)       # (P+2, W)
    return torch.einsum("iw,kwv,jv->kij", r, windows, r)


def _orientation_bins(sub: torch.Tensor):
    """Central-difference gradients inside the aligned samples: (mag (K,
    P*P), ori_w (K, P*P, ORI_BINS)), the orientation split linearly across
    its two nearest bins."""
    gxs = 0.5 * (sub[:, 1:-1, 2:] - sub[:, 1:-1, :-2])   # (K, P, P)
    gys = 0.5 * (sub[:, 2:, 1:-1] - sub[:, :-2, 1:-1])
    gxs = gxs.reshape(-1, PATCH * PATCH)                 # (K, P2)
    gys = gys.reshape(-1, PATCH * PATCH)
    mag = torch.sqrt(gxs * gxs + gys * gys + 1e-12)
    ori = torch.atan2(gys, gxs)               # [-pi, pi]

    b = (ori / (2.0 * math.pi) + 0.5) * ORI_BINS  # [0, 8]
    b0 = torch.floor(b)
    fb = b - b0
    b0i = torch.remainder(b0.to(torch.int32), ORI_BINS)
    b1i = torch.remainder(b0i + 1, ORI_BINS)
    bins = torch.arange(ORI_BINS, dtype=torch.int32, device=sub.device)
    onehot0 = (b0i[..., None] == bins).to(torch.float32)
    onehot1 = (b1i[..., None] == bins).to(torch.float32)
    return mag, onehot0 * (1.0 - fb)[..., None] + onehot1 * fb[..., None]


def _normalize(desc: torch.Tensor) -> torch.Tensor:
    """SIFT normalization: L2 -> clip 0.2 -> L2."""
    desc = desc / torch.linalg.vector_norm(desc, dim=-1, keepdim=True).clamp_min(1e-9)
    desc = desc.clamp_max(0.2)
    return desc / torch.linalg.vector_norm(desc, dim=-1, keepdim=True).clamp_min(1e-9)


def describe_keypoints_plain(
    img: torch.Tensor, xy: torch.Tensor, valid: torch.Tensor, scale=None
) -> torch.Tensor:
    """``describe_keypoints`` with plain torch ops (and kernel B's window
    gathers on the card): kernel F's specification."""
    mag, ori_w = _orientation_bins(_aligned_samples(img, xy, scale))
    spatial = _spatial_weights(img.device)    # (P2, C2)
    # hist[k, c, o] = sum_p mag[k,p] * spatial[p,c] * ori_w[k,p,o]
    hist = torch.einsum("kp,pc,kpo->kco", mag, spatial, ori_w)
    desc = _normalize(hist.reshape(-1, DESC_DIM))
    return torch.where(valid[:, None], desc, torch.zeros_like(desc))


def describe_keypoints(
    img: torch.Tensor,
    xy: torch.Tensor,
    valid: torch.Tensor,
    scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """(K, 128) unit-norm upright-SIFT descriptors: ``describe_keypoints_plain``
    on any device (zeros where invalid)."""
    return describe_keypoints_plain(img.to(torch.float32), xy, valid, scale)
