"""Cholesky factor of one SPD matrix: the Hopper kernel and its plain version.

Replaces the TPU kernel ``ptzjax/kernels/cholesky_pallas.py:cholesky_pallas``
with ``csrc/cholesky.cu``: one CTA factors the matrix right-looking over
32-wide panels, in one launch. The EKF factors its innovation matrix S
(n = 2N, 512 at the default caps) through it every tracked frame.

Both versions return ``(L, info)`` as ``torch.linalg.cholesky_ex`` does: the
lower factor (zeros above the diagonal; only the lower triangle of ``s`` is
read) and ``info`` = 0, or the 1-based index of the first pivot that is not
positive. Unlike the TPU kernel, which clamps such a pivot and raises no
flag, a failed factor is reported, so the EKF's NaN contract for a non-PD S
holds on both paths.

``cholesky`` takes the plain version for a tensor on the CPU and launches
the kernel for a CUDA tensor; it never falls back from one to the other.
"""

from __future__ import annotations

import torch

from ptzjax_torch.kernels import _build

launches = 0   # kernel launches since the last reset (plain calls not counted)


def cholesky_plain(s: torch.Tensor):
    """(L, info) with ``torch.linalg.cholesky_ex``: the kernel's
    specification."""
    return torch.linalg.cholesky_ex(s)


def cholesky(s: torch.Tensor):
    """(L (n, n), info () int32) for a symmetric positive definite (n, n)
    fp32 matrix ``s``."""
    if s.device.type == "cpu":
        return cholesky_plain(s)
    if s.device.type != "cuda":
        raise ValueError(f"cholesky: unsupported device {s.device}")
    if s.dtype != torch.float32 or s.dim() != 2 or s.shape[0] != s.shape[1]:
        raise ValueError(
            f"cholesky: need a square 2-D float32 matrix, got {s.dtype} {tuple(s.shape)}"
        )
    if not s.is_contiguous():
        raise ValueError("cholesky: matrix must be contiguous")
    n = s.shape[0]
    if n < 1:
        raise ValueError("cholesky: empty matrix")
    factor = torch.empty_like(s)
    info = torch.empty((), dtype=torch.int32, device=s.device)
    lib = _build.load()
    err = lib.ptz_cholesky(
        s.data_ptr(), factor.data_ptr(), info.data_ptr(), n, s.device.index,
        torch.cuda.current_stream(s.device).cuda_stream,
    )
    _build.check(err, "cholesky")
    global launches
    launches += 1
    return factor, info
