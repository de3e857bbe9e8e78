"""Kernel D on the CPU: the port's Cholesky (``kernels.cholesky``, whose
plain version is ``torch.linalg.cholesky_ex``) against the TPU kernel's body
``ptzjax.kernels.cholesky_pallas._chol_kernel`` in interpret mode, called as
tests/test_kernels.py calls it, and the one departure from that kernel: a
non-PD input is reported, not clamped."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import ptzjax.kernels.cholesky_pallas as cp
from ptzjax_torch.kernels import cholesky as tch
from tests._torch_port import n as host
from tests._torch_port import t

torch.set_num_threads(2)


def _tpu_kernel(s: np.ndarray) -> np.ndarray:
    """The TPU kernel's lower factor, in interpret mode."""
    n = s.shape[0]
    u = pl.pallas_call(
        cp._chol_kernel,
        out_shape=jax.ShapeDtypeStruct((n, n), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((n, n), jnp.float32)],
        interpret=True,
    )(jnp.asarray(s))
    return np.asarray(u).T


def _spd(n, seed=0):
    a = np.random.default_rng(seed).normal(size=(n, n)).astype(np.float32)
    return a @ a.T + n * np.eye(n, dtype=np.float32)


@pytest.mark.parametrize("n", [64, 128, 192])
def test_factor_matches_tpu_kernel(n):
    """L within 1e-4 of its largest entry. An elementwise rtol would fail on
    entries near zero, where the two packages' fp32 summation orders differ
    by ~1e-6 absolute (each is within ~4e-6 of a float64 factor)."""
    s = _spd(n)
    ref = _tpu_kernel(s)
    lower, info = tch.cholesky(t(s))
    got = host(lower)
    assert int(info) == 0
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())
    assert not np.triu(got, 1).any()                         # zeros above the diagonal
    assert np.abs(got @ got.T - s).max() / np.abs(s).max() < 1e-5


def test_only_the_lower_triangle_is_read():
    s = _spd(40, seed=1)
    junk = s + np.triu(np.full_like(s, 7.0), 1)
    np.testing.assert_array_equal(host(tch.cholesky(t(junk))[0]), host(tch.cholesky(t(s))[0]))


def test_non_pd_is_reported_where_the_tpu_kernel_clamps():
    """The TPU kernel clamps a non-positive pivot at 1e-30 and raises no
    flag: its factor stays finite before the panel that holds the bad pivot
    and, once the clamped pivot overflows the block inverse, is NaN from
    that panel on. The port reports the first bad pivot (1-based, as LAPACK
    does), and the EKF turns the whole factor into NaN from that flag (the
    LOST no-op of tests/test_torch_state.py::test_non_pd_innovation_is_a_lost_no_op)."""
    s = _spd(64, seed=2)
    s[37, 37] = -5.0
    ref = _tpu_kernel(s)
    assert np.isfinite(ref[:32]).all() and np.isnan(ref[32:]).any()
    _, info = tch.cholesky(t(s))
    first_bad = np.nonzero(
        [np.linalg.eigvalsh(s[:k, :k].astype(np.float64)).min() <= 0 for k in range(1, 65)]
    )[0][0] + 1
    assert int(info) == first_bad


@pytest.mark.parametrize("n", [1, 33, 64, 256, 300, 512, 900, 1024, 4096])
def test_plan_owns_every_block_row_once_with_balanced_counts(n):
    """The cluster's launch plan: each 32-row block row has exactly one
    owner, the CTAs hold counts that differ by at most one, and slot s of a
    CTA holds a block row of round s (the kernel's `block_of`)."""
    p = tch.plan(n)
    assert p.blocks == -(-n // tch.PANEL) and len(p.rows) == tch.CLUSTER
    assert sorted(b for rows in p.rows for b in rows) == list(range(p.blocks))
    counts = [len(rows) for rows in p.rows]
    assert max(counts) - min(counts) <= 1
    for cta, rows in enumerate(p.rows):
        for slot, b in enumerate(rows):
            assert p.owner[b] == cta and b // tch.CLUSTER == slot
            assert tch.block_of(cta, slot) == b


def _largest_share(owner, blocks):
    """Trailing 32 x 32 tile updates of the busiest CTA: block row b takes
    b - k of them at step k < b, b (b + 1) / 2 in all."""
    work = [0] * tch.CLUSTER
    for b in range(blocks):
        work[owner[b]] += b * (b + 1) // 2
    return max(work), sum(work)


@pytest.mark.parametrize("n", [256, 512, 1024])
def test_reflected_dealing_balances_the_trailing_update(n):
    """Dealing the block rows 0..7, 7..0, ... gives the busiest CTA no more
    trailing work than dealing them b mod 8, and less from two rounds on
    (at n = 512: 120 of 680 tile updates, against 148)."""
    p = tch.plan(n)
    reflected, total = _largest_share(p.owner, p.blocks)
    cyclic, _ = _largest_share([b % tch.CLUSTER for b in range(p.blocks)], p.blocks)
    assert total == sum(b * (b + 1) // 2 for b in range(p.blocks))
    assert reflected <= cyclic and (p.blocks <= tch.CLUSTER or reflected < cyclic)
    if n == 512:
        assert (reflected, cyclic, total) == (120, 148, 680)


@pytest.mark.parametrize(
    "n,smem", [(1, True), (33, True), (256, True), (512, True), (513, False), (900, False), (1024, False)]
)
def test_plan_keeps_the_rows_in_shared_memory_up_to_n_512(n, smem):
    """On an H100 (227 KB a block) the owned rows and the panel copy fit up
    to the EKF's n = 512; beyond, the rows stay in L and the panel goes to a
    global workspace. A smaller opt-in moves n = 512 to the global branch."""
    p = tch.plan(n)
    assert p.smem == smem
    if smem:
        assert 0 < p.smem_bytes + tch._STATIC_SMEM <= tch.H100_SMEM_OPTIN and p.work_floats == 0
    else:
        assert p.smem_bytes == 0 and p.work_floats == p.blocks * tch.PANEL * tch.PANEL
    assert not tch.plan(512, smem_optin=100_000).smem


@pytest.mark.parametrize("n, k", [(24, 1), (64, 70), (512, 518)])
def test_solve_is_the_cholesky_solve(n, k):
    """``solve`` (two triangular solves, the EKF's gain and the BA's step)
    against ``torch.cholesky_solve`` and a float64 solve, at the EKF's
    shape (S 512 x 512, 518 right-hand sides) and the windowed BA's (24, one
    right-hand side): within 1e-5 relative to the float64 solution, where
    ``cholesky_solve`` lands; a NaN factor gives NaN."""
    s = _spd(n, seed=n)
    b = np.random.default_rng(k).normal(size=(n, k)).astype(np.float32)
    factor = torch.linalg.cholesky(t(s))
    got = host(tch.solve(factor, t(b)))
    want = np.linalg.solve(s.astype(np.float64), b.astype(np.float64))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * scale
    assert np.abs(host(torch.cholesky_solve(t(b), factor)) - want).max() <= 1e-5 * scale
    assert torch.isnan(tch.solve(torch.full_like(factor, float("nan")), t(b))).all()
