"""Descriptor matching scores in plain torch: best and second-best
similarity per query row, and the best query per reference column. A
frozen copy of the plain version in ``ptzjax_torch/kernels/match.py``,
which the port's kernel C (``csrc/match.cu``) is held to.
"""

from __future__ import annotations

import torch


_NEG = -1e9


def match_scores_plain(
    d_query, d_ref, q_valid, r_valid, xy_query=None, xy_ref_pred=None,
    gate_px=None, mutual: bool = True,
):
    """(i1, v1, v2, col_best) with plain torch ops: the kernel's
    specification. ``col_best`` is None unless ``mutual``."""
    s = d_query @ d_ref.T
    s = torch.where(q_valid[:, None] & r_valid[None, :], s, torch.full_like(s, _NEG))
    if gate_px is not None:
        d2 = ((xy_query[:, None, :] - xy_ref_pred[None, :, :]) ** 2).sum(-1)
        s = torch.where(d2 <= gate_px * gate_px, s, torch.full_like(s, _NEG))
    i1 = torch.argmax(s, dim=1)
    v1 = torch.gather(s, 1, i1[:, None])[:, 0]
    cols = torch.arange(s.shape[1], device=s.device)
    v2 = torch.where(cols[None, :] == i1[:, None], torch.full_like(s, _NEG), s).amax(1)
    col_best = torch.argmax(s, dim=0).to(torch.int32) if mutual else None
    return i1.to(torch.int32), v1, v2, col_best


def match_scores(
    d_query, d_ref, q_valid, r_valid, xy_query=None, xy_ref_pred=None,
    gate_px=None, mutual: bool = True,
):
    """``match_scores_plain`` on any device."""
    return match_scores_plain(d_query, d_ref, q_valid, r_valid, xy_query, xy_ref_pred, gate_px, mutual)
