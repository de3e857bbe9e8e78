"""Cholesky factor and solve in plain torch (``torch.linalg.cholesky_ex``
and two triangular solves). A frozen copy of the plain version in
``ptzjax_torch/kernels/cholesky.py``, which the port's kernel D
(``csrc/cholesky.cu``) is held to.
"""

from __future__ import annotations


import torch


def cholesky_plain(s: torch.Tensor):
    """(L, info) with ``torch.linalg.cholesky_ex``: the kernel's
    specification."""
    return torch.linalg.cholesky_ex(s)


def cholesky(s: torch.Tensor):
    """(L, info): ``torch.linalg.cholesky_ex`` on any device."""
    return cholesky_plain(s)


def solve(factor: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with L L^T x = b for the lower factor L = ``factor`` (n, n) and b
    (n, k): ``torch.cholesky_solve(b, factor)`` as two triangular solves
    (cuBLAS trsm on the card). ``torch.cholesky_solve`` goes through
    cuSOLVER, whose own allocations a CUDA-graph capture records as memory
    nodes, which the body of a conditional graph node refuses
    (``_graphs.py``)."""
    y = torch.linalg.solve_triangular(factor, b, upper=False)
    return torch.linalg.solve_triangular(factor.mT, y, upper=True)
