"""Fused descriptor matcher: the Hopper kernel and its plain version.

Replaces the TPU kernel ``ptzjax/kernels/match.py:match_pallas`` with
``csrc/match.cu``. Both versions return the O(Q + R) reductions of the
masked (Q, R) score matrix: per query row the argmax ``i1``, the best score
``v1`` and the second score ``v2`` (the row max with column ``i1`` masked),
and, with ``mutual``, per reference column the argmax over rows
``col_best``. Ties go to the first index, as ``torch.argmax`` and
``jnp.argmax`` decide. The plain version builds the score matrix and passes
over it three more times; the kernel never writes it to global memory. It
is one launch: a grid of (64-query block) x (reference chunk) CTAs, each
scoring 64 x 128 tiles, whose partials the last CTA of each block and chunk
merges (its note says how). ``grid`` plans that grid and ``cta_tiles``
lists what each CTA scores, in pure Python, so the CPU tests check that
every (query, column) pair is scored exactly once. The decisions built on
these vectors live in ``ptzjax_torch/match.py`` and are shared by both
versions.

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
QB = 64             # query rows per CTA (csrc/match.cu)
TR = 128            # reference rows per tile
_CTA_TARGET = 264   # two CTAs per SM of an H100 (132 SMs)
# (device index, stream) -> (counters, scratch), grown when a grid needs
# more: the counters are zeroed when made and the kernel leaves them at 0;
# the scratch holds the partials
_workspace: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


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


def grid(q: int, r: int) -> tuple[int, int, int]:
    """(query blocks, chunk, chunks) of the kernel's grid for Q x R: the
    chunk is a multiple of the 128-row tile, chosen so that the grid has
    about ``_CTA_TARGET`` CTAs (one wave of 2 CTAs per SM) where R allows,
    and one CTA per tile where it does not."""
    n_qb = -(-q // QB)
    tiles = -(-r // TR)
    want = max(1, -(-_CTA_TARGET // n_qb))
    chunk = TR * -(-tiles // min(want, tiles))
    return n_qb, chunk, -(-r // chunk)


def cta_tiles(q: int, r: int):
    """Yield ((query block, chunk), rows, columns) for every tile each CTA
    scores: ``range`` objects, as the kernel's loops bound them."""
    n_qb, chunk, n_chunks = grid(q, r)
    for qb in range(n_qb):
        rows = range(qb * QB, min(q, qb * QB + QB))
        for ch in range(n_chunks):
            c_end = min(r, ch * chunk + chunk)
            for c0 in range(ch * chunk, c_end, TR):
                yield (qb, ch), rows, range(c0, min(c_end, c0 + TR))


def _scratch(dev, stream: int, n_counters: int, floats: int):
    """This stream's (counters, scratch), grown to the sizes asked for."""
    key = (dev.index, stream)
    counters, scratch = _workspace.get(key, (None, None))
    if counters is None or counters.numel() < n_counters:
        counters = torch.zeros(n_counters, dtype=torch.int32, device=dev)
    if scratch is None or scratch.numel() < floats:
        scratch = torch.empty(floats, dtype=torch.float32, device=dev)
    _workspace[key] = counters, scratch
    return counters, scratch


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
    n_qb, chunk, n_chunks = grid(q, r)
    n_col = n_qb * r if mutual else 0
    stream = torch.cuda.current_stream(dev).cuda_stream
    counters, scratch = _scratch(dev, stream, n_qb + n_chunks, 3 * n_chunks * q + 2 * n_col)
    # scratch: v1 and v2 row partials, i1 row partials, column values, rows
    base = scratch.data_ptr()
    row_f, row_i = base, base + 8 * n_chunks * q
    col_f = row_i + 4 * n_chunks * q if mutual else None
    col_i = col_f + 4 * n_col if mutual else None
    col_best = torch.empty(r, dtype=torch.int32, device=dev) if mutual else None
    # torch compares the float32 distance against the float32 of gate^2
    gate2 = float(np.float32(gate_px * gate_px)) if gated else 0.0

    def ptr(x):
        return None if x is None else x.data_ptr()

    lib = _build.load()
    err = lib.ptz_match(
        d_query.data_ptr(), d_ref.data_ptr(), q_valid.data_ptr(), r_valid.data_ptr(),
        ptr(xy_query if gated else None), ptr(xy_ref_pred if gated else None),
        gate2, int(gated), q, r, d, int(mutual), chunk,
        row_f, row_i, col_f, col_i, counters.data_ptr(),
        i1.data_ptr(), v1.data_ptr(), v2.data_ptr(), ptr(col_best), dev.index, stream,
    )
    _build.check(err, "match_scores")
    global launches
    launches += 1
    return i1, v1, v2, col_best
