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
