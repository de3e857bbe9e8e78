"""Cholesky factor of one SPD matrix: the Hopper kernel and its plain version.

Replaces the TPU kernel ``ptzjax/kernels/cholesky_pallas.py:cholesky_pallas``
with ``csrc/cholesky.cu``: one launch of one cluster of ``CLUSTER`` CTAs,
right-looking over 32-wide panels, which hold the matrix's 32-row block
rows in their shared memory and exchange each panel through distributed
shared memory. The EKF factors its innovation matrix S (n = 2N, 512 at the
default caps) through it every tracked frame. ``plan`` is the host's part
of the launch in pure Python (block-row ownership, and whether the rows fit
in shared memory), so the CPU tests check it; the kernel deals the rows by
the same rule.

Both versions return ``(L, info)`` as ``torch.linalg.cholesky_ex`` does: the
lower factor (zeros above the diagonal; only the lower triangle of ``s`` is
read) and ``info`` = 0, or the 1-based index of the first pivot that is not
positive. Unlike the TPU kernel, which clamps such a pivot and raises no
flag, a failed factor is reported, so the EKF's NaN contract for a non-PD S
holds on both paths.

``cholesky`` takes the plain version for a tensor on the CPU and launches
the kernel for a CUDA tensor; it never falls back from one to the other,
and raises where the cluster cannot be launched.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from ptzjax_torch.kernels import _build

launches = 0   # kernel launches since the last reset (plain calls not counted)

PANEL = 32                 # panel width = block-row height (csrc/cholesky.cu)
CLUSTER = 8                # CTAs in the cluster: the portable cluster size
H100_SMEM_OPTIN = 232_448  # shared memory a block may opt in to on an H100
_STATIC_SMEM = 4 * (PANEL * PANEL + PANEL + 1)   # diagonal block, its reciprocals, flag
_NO_CLUSTER = 1000         # the C entry point's code for "cannot be resident"
_smem_optin: dict[int, int] = {}


@dataclass(frozen=True)
class Plan:
    blocks: int                        # 32-row block rows, ceil(n / 32)
    owner: tuple[int, ...]             # owner[b]: the CTA that holds block row b
    rows: tuple[tuple[int, ...], ...]  # rows[c]: CTA c's block rows, by slot
    smem: bool                         # rows and panel copy in shared memory
    smem_bytes: int                    # dynamic shared memory per CTA
    work_floats: int                   # global panel workspace (global branch)


def block_of(cta: int, slot: int) -> int:
    """The block row in ``slot`` of CTA ``cta``: dealt cyclically, reflected
    every other round (0..7, 7..0, ...), so the CTA holding the last, largest
    rows does not also hold the last rows of every other round."""
    return slot * CLUSTER + (cta if slot % 2 == 0 else CLUSTER - 1 - cta)


@functools.lru_cache(maxsize=64)
def plan(n: int, smem_optin: int = H100_SMEM_OPTIN) -> Plan:
    """How the kernel lays out an (n, n) factor: who owns which block row,
    and whether the owned rows (stride blocks * 32 + 8) and the panel copy
    (stride 36) fit in ``smem_optin`` bytes of shared memory per CTA; if not,
    the rows stay in L and the panel in a (blocks * 32, 32) workspace."""
    if n < 1:
        raise ValueError(f"cholesky: n must be >= 1, got {n}")
    blocks = -(-n // PANEL)
    slots = -(-blocks // CLUSTER)
    rows = tuple(
        tuple(b for b in (block_of(c, s) for s in range(slots)) if b < blocks)
        for c in range(CLUSTER)
    )
    owner = [0] * blocks
    for c, bs in enumerate(rows):
        for b in bs:
            owner[b] = c
    lda = blocks * PANEL + 8
    smem_bytes = 4 * (slots * PANEL * lda + blocks * PANEL * 36)
    smem = smem_bytes + _STATIC_SMEM <= smem_optin
    return Plan(
        blocks, tuple(owner), rows, smem, smem_bytes if smem else 0,
        0 if smem else blocks * PANEL * PANEL,
    )


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
    dev = s.device.index
    lib = _build.load()
    if dev not in _smem_optin:
        _smem_optin[dev] = lib.ptz_smem_optin(dev)
    p = plan(n, _smem_optin[dev])
    factor = torch.empty_like(s)
    info = torch.empty((), dtype=torch.int32, device=s.device)
    work = None if p.smem else torch.empty(p.work_floats, dtype=torch.float32, device=s.device)
    err = lib.ptz_cholesky(
        s.data_ptr(), factor.data_ptr(), info.data_ptr(),
        None if work is None else work.data_ptr(), n, int(p.smem), dev,
        torch.cuda.current_stream(s.device).cuda_stream,
    )
    if err == _NO_CLUSTER:
        raise RuntimeError(
            f"cholesky: a cluster of {CLUSTER} CTAs with {p.smem_bytes} bytes of dynamic "
            f"shared memory each cannot be resident on {torch.cuda.get_device_name(dev)}"
        )
    _build.check(err, "cholesky")
    global launches
    launches += 1
    return factor, info


def solve(factor: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with L L^T x = b for the lower factor L = ``factor`` (n, n) and b
    (n, k): ``torch.cholesky_solve(b, factor)`` as two triangular solves
    (cuBLAS trsm on the card). ``torch.cholesky_solve`` goes through
    cuSOLVER, whose own allocations a CUDA-graph capture records as memory
    nodes, which the body of a conditional graph node refuses
    (``_graphs.py``)."""
    y = torch.linalg.solve_triangular(factor, b, upper=False)
    return torch.linalg.solve_triangular(factor.mT, y, upper=True)
