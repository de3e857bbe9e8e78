"""Batched per-keypoint window gather in plain torch. A frozen copy of the
plain version in ``ptzjax_torch/kernels/window_gather.py``.
"""

from __future__ import annotations

import torch


def gather_windows_plain(
    padded: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor, win: int
) -> torch.Tensor:
    """``padded[ys[k] : ys[k]+win+1, xs[k] : xs[k]+win+1]`` for every k, with
    the starts clamped into the image (``jax.lax.dynamic_slice`` semantics)."""
    side = win + 1
    hp, wp = padded.shape
    r = torch.arange(side, device=padded.device)
    y = ys.long().clamp(0, hp - side)[:, None] + r          # (K, side)
    x = xs.long().clamp(0, wp - side)[:, None] + r
    return padded[y[:, :, None], x[:, None, :]]


def gather_windows(
    padded: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor, win: int
) -> torch.Tensor:
    """``gather_windows_plain`` on any device."""
    return gather_windows_plain(padded, ys, xs, win)
