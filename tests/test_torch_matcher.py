"""Kernel C on the CPU: the port's matcher (``match_scores_plain`` + the
shared decisions) against the TPU kernel ``ptzjax.kernels.match.match_pallas``
in interpret mode, ungated with the mutual check, gated, one-way, and on
planted ties, all-invalid rows and a single reference row. ``ok`` and
``idx`` must be equal and ``score`` within 1e-5 (the two packages sum the
dot products in different orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptzjax.kernels.match import match_pallas
from ptzjax_torch import match as tmatch
from ptzjax_torch.kernels import match as tkm
from tests._torch_port import n, t

torch.set_num_threads(2)


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _data(q=70, r=150, dim=64, seed=0):
    """tests/test_kernels.py's matcher data: queries are noisy copies of a
    permutation of the reference rows."""
    rng = np.random.default_rng(seed)
    dr = _unit(rng.normal(size=(r, dim)))
    perm = rng.permutation(r)[:q]
    dq = _unit(dr[perm] + 0.1 * rng.normal(size=(q, dim)))
    return dq, dr, rng.random(q) > 0.1, rng.random(r) > 0.1, perm


def _tied(q=90, r=200, dim=32, seed=4):
    """Exact duplicate reference rows (matched by exact copies and by noisy
    queries), duplicate query rows, and all-invalid query rows."""
    dq, dr, qv, rv, perm = _data(q, r, dim, seed)
    dr[[7, 40, 41, 150]] = dr[3]              # four copies of row 3
    dr[99] = dr[12]
    dq[0] = dr[3]                             # exact hit on a tied row
    dq[1] = dr[12]
    dq[2] = _unit(dr[3] + 0.05)               # noisy hit on a tied row
    dq[30] = dq[31] = dq[32]                  # duplicate queries: one column best
    qv[[5, 6, 60]] = False                    # all-invalid rows
    rv[[3, 7, 40, 41, 150, 12, 99]] = True
    return dq, dr, qv, rv


def _assert_same(got, ref):
    np.testing.assert_array_equal(n(got.ok), n(ref.ok))
    np.testing.assert_array_equal(n(got.idx), n(ref.idx))
    np.testing.assert_allclose(n(got.score), n(ref.score), atol=1e-5)


@pytest.mark.parametrize("mutual", [True, False])
def test_ungated_matches_tpu_kernel(mutual):
    dq, dr, qv, rv, _ = _data(q=300, r=700, seed=1)
    ref = match_pallas(*map(jnp.asarray, (dq, dr, qv, rv)), ratio=0.8, mutual=mutual, interpret=True)
    got = tmatch.match_descriptors(t(dq), t(dr), t(qv), t(rv), ratio=0.8, mutual=mutual)
    assert n(ref.ok).sum() > 100
    _assert_same(got, ref)


def test_gated_matches_tpu_kernel():
    dq, dr, qv, rv, perm = _data(seed=2)
    rng = np.random.default_rng(3)
    xr = rng.uniform(0, 500, (dr.shape[0], 2)).astype(np.float32)
    xq = (xr[perm] + rng.normal(0, 5, (dq.shape[0], 2))).astype(np.float32)
    xq[::9] += 40.0                           # some queries outside every gate
    ref = match_pallas(
        *map(jnp.asarray, (dq, dr, qv, rv)), xy_query=jnp.asarray(xq),
        xy_ref_pred=jnp.asarray(xr), gate_px=30.0, ratio=0.9, interpret=True,
    )
    got = tmatch.match_gated(t(dq), t(xq), t(dr), t(xr), t(qv), t(rv), gate_px=30.0, ratio=0.9)
    assert n(ref.ok).sum() > 20
    _assert_same(got, ref)


@pytest.mark.parametrize("mutual", [True, False])
def test_ties_invalid_rows_and_one_reference_match_tpu_kernel(mutual):
    dq, dr, qv, rv = _tied()
    ref = match_pallas(*map(jnp.asarray, (dq, dr, qv, rv)), ratio=0.8, mutual=mutual, interpret=True)
    got = tmatch.match_descriptors(t(dq), t(dr), t(qv), t(rv), ratio=0.8, mutual=mutual)
    _assert_same(got, ref)
    assert n(got.idx)[0] == 3 and n(got.ok)[0]        # first of the tied rows
    for r_valid in (np.array([True]), np.array([False])):   # R = 1
        ref = match_pallas(
            *map(jnp.asarray, (dq, dr[3:4], qv, r_valid)), ratio=0.8, mutual=mutual,
            interpret=True,
        )
        got = tmatch.match_descriptors(t(dq), t(dr[3:4]), t(qv), t(r_valid), ratio=0.8, mutual=mutual)
        _assert_same(got, ref)


def test_plain_reductions_follow_the_tie_rules():
    """match_scores_plain on a hand-made score matrix (reference = identity,
    so the scores are the query rows): first index on ties with v2 == v1,
    -1e9 everywhere on an invalid row and for R = 1, first row on column
    ties, and a closed gate."""
    s = np.array(
        [[0.5, 0.9, 0.9, 0.1],
         [0.7, 0.3, 0.3, 0.95],
         [0.7, 0.1, 0.2, 0.3],
         [0.7, 0.6, 0.2, 0.3]], np.float32,
    )
    eye = np.eye(4, dtype=np.float32)
    qv = np.array([True, True, False, True])
    i1, v1, v2, cb = tkm.match_scores_plain(t(s), t(eye), t(qv), t(np.ones(4, bool)))
    assert n(i1).tolist() == [1, 3, 0, 0]
    np.testing.assert_array_equal(n(v1), np.float32([0.9, 0.95, -1e9, 0.7]))
    np.testing.assert_array_equal(n(v2), np.float32([0.9, 0.7, -1e9, 0.6]))
    assert n(i1).dtype == np.int32 and n(cb).dtype == np.int32
    assert n(cb).tolist() == [1, 0, 0, 1]
    i1, v1, v2, cb = tkm.match_scores_plain(t(s), t(eye[:1]), t(qv), t(np.ones(1, bool)))
    assert n(i1).tolist() == [0, 0, 0, 0] and n(v2).tolist() == [-1e9] * 4
    xy = np.zeros((4, 2), np.float32)
    far = np.full((4, 2), 100.0, np.float32)
    _, v1, _, cb = tkm.match_scores_plain(
        t(s), t(eye), t(qv), t(np.ones(4, bool)), t(xy), t(far), gate_px=10.0, mutual=False,
    )
    assert cb is None and n(v1).tolist() == [-1e9] * 4


@pytest.mark.parametrize(
    "q,r",
    [(512, 256), (512, 2048), (512, 4096), (512, 32768), (70, 1), (33, 130), (1, 129), (65, 128)],
)
def test_grid_scores_every_pair_exactly_once(q, r):
    """The kernel's grid at the four main-path shapes and ragged ones: chunks
    are whole 128-row tiles, every CTA has a tile, and the tiles cover every
    (query, column) pair exactly once."""
    n_qb, chunk, n_chunks = tkm.grid(q, r)
    assert chunk % tkm.TR == 0 and (n_chunks - 1) * chunk < r <= n_chunks * chunk
    assert (n_qb - 1) * tkm.QB < q <= n_qb * tkm.QB
    count = np.zeros((q, r), np.uint8)
    ctas = set()
    for (qb, ch), rows, cols in tkm.cta_tiles(q, r):
        assert rows.start == qb * tkm.QB and len(rows) <= tkm.QB
        assert (cols.start - ch * chunk) % tkm.TR == 0 and ch * chunk <= cols.start
        assert cols.stop <= min(r, (ch + 1) * chunk) and len(cols) <= tkm.TR
        count[rows.start:rows.stop, cols.start:cols.stop] += 1
        ctas.add((qb, ch))
    assert (count == 1).all()
    assert ctas == {(qb, ch) for qb in range(n_qb) for ch in range(n_chunks)}


def test_grid_sizes_at_the_path_shapes():
    """About two CTAs per SM of an H100 (132 SMs) at the keyframe
    relocalization shape, and one wave at the tracking shape."""
    n_qb, _, n_chunks = tkm.grid(512, 32768)
    assert 132 < n_qb * n_chunks <= 264
    n_qb, _, n_chunks = tkm.grid(512, 256)
    assert n_qb * n_chunks <= 132
