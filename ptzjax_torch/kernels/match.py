"""Fused descriptor matcher: the Hopper kernel and its plain version.

Replaces the TPU kernel ``ptzjax/kernels/match.py:match_pallas`` with
``csrc/match.cu``. Both versions return the O(Q + R) reductions of the
masked (Q, R) score matrix: per query row the argmax ``i1``, the best score
``v1`` and the second score ``v2`` (the row max with column ``i1`` masked),
and, with ``mutual``, per reference column the argmax over rows
``col_best``. Ties go to the first index, as ``torch.argmax`` and
``jnp.argmax`` decide. The plain version builds the score matrix and passes
over it three more times; the kernel never writes it to global memory (its
note says how it splits and merges the work). The decisions built on these
vectors live in ``ptzjax_torch/match.py`` and are shared by both versions.

``match_scores`` takes the plain version for tensors on the CPU and
launches the kernel for CUDA tensors; it never falls back from one to the
other.
"""

from __future__ import annotations

import numpy as np
import torch

from ptzjax_torch.kernels import _build

launches = 0   # kernel launches since the last reset (plain calls not counted)

_NEG = -1e9
_QB = 32            # query rows per CTA (csrc/match.cu)
_TR = 64            # reference rows per tile
_CTA_TARGET = 264   # two CTAs per SM of an H100 (132 SMs)


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


def _check(name, x, shape, dtype, device):
    if x.device != device or x.dtype != dtype or tuple(x.shape) != shape:
        raise ValueError(
            f"match_scores: {name} must be {dtype} {shape} on {device}, got "
            f"{x.dtype} {tuple(x.shape)} on {x.device}"
        )
    if not x.is_contiguous():
        raise ValueError(f"match_scores: {name} must be contiguous")


def _chunk(q: int, r: int) -> int:
    """Reference columns per CTA: a multiple of the 64-row tile, chosen so
    that the (query block, chunk) grid has about ``_CTA_TARGET`` CTAs."""
    n_qb = -(-q // _QB)
    tiles = -(-r // _TR)
    want = max(1, -(-_CTA_TARGET // n_qb))
    return _TR * -(-tiles // min(want, tiles))


def match_scores(
    d_query, d_ref, q_valid, r_valid, xy_query=None, xy_ref_pred=None,
    gate_px=None, mutual: bool = True,
):
    """(i1 (Q,) int32, v1 (Q,), v2 (Q,), col_best (R,) int32 or None) for
    unit fp32 descriptors d_query (Q, D), d_ref (R, D), bool validity
    (Q,), (R,), and, when ``gate_px`` is given, pixel positions xy_query
    (Q, 2) and xy_ref_pred (R, 2)."""
    if d_query.device.type == "cpu":
        return match_scores_plain(
            d_query, d_ref, q_valid, r_valid, xy_query, xy_ref_pred, gate_px, mutual
        )
    dev = d_query.device
    if dev.type != "cuda":
        raise ValueError(f"match_scores: unsupported device {dev}")
    if d_query.dim() != 2 or d_ref.dim() != 2:
        raise ValueError("match_scores: descriptors must be 2-D")
    q, d = d_query.shape
    r = d_ref.shape[0]
    if r < 1 or d < 1:
        raise ValueError(f"match_scores: need R >= 1 and D >= 1, got R={r}, D={d}")
    _check("d_query", d_query, (q, d), torch.float32, dev)
    _check("d_ref", d_ref, (r, d), torch.float32, dev)
    _check("q_valid", q_valid, (q,), torch.bool, dev)
    _check("r_valid", r_valid, (r,), torch.bool, dev)
    gated = gate_px is not None
    if gated:
        _check("xy_query", xy_query, (q, 2), torch.float32, dev)
        _check("xy_ref_pred", xy_ref_pred, (r, 2), torch.float32, dev)
    i1 = torch.empty(q, dtype=torch.int32, device=dev)
    v1 = torch.empty(q, dtype=torch.float32, device=dev)
    v2 = torch.empty(q, dtype=torch.float32, device=dev)
    if q == 0:
        col = torch.zeros(r, dtype=torch.int32, device=dev) if mutual else None
        return i1, v1, v2, col
    chunk = _chunk(q, r)
    n_chunks = -(-r // chunk)
    row_f = torch.empty((2, n_chunks, q), dtype=torch.float32, device=dev)
    row_i = torch.empty((n_chunks, q), dtype=torch.int32, device=dev)
    if mutual:
        n_qb = -(-q // _QB)
        col_f = torch.empty((n_qb, r), dtype=torch.float32, device=dev)
        col_i = torch.empty((n_qb, r), dtype=torch.int32, device=dev)
        col_best = torch.empty(r, dtype=torch.int32, device=dev)
    else:
        col_f = col_i = col_best = None
    # torch compares the float32 distance against the float32 of gate^2
    gate2 = float(np.float32(gate_px * gate_px)) if gated else 0.0

    def ptr(x):
        return None if x is None else x.data_ptr()

    lib = _build.load()
    err = lib.ptz_match(
        d_query.data_ptr(), d_ref.data_ptr(), q_valid.data_ptr(), r_valid.data_ptr(),
        ptr(xy_query if gated else None), ptr(xy_ref_pred if gated else None),
        gate2, int(gated), q, r, d, int(mutual), chunk,
        row_f.data_ptr(), row_i.data_ptr(), ptr(col_f), ptr(col_i),
        i1.data_ptr(), v1.data_ptr(), v2.data_ptr(), ptr(col_best),
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "match_scores")
    global launches
    launches += 1
    return i1, v1, v2, col_best
