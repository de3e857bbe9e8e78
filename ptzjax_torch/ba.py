"""Bundle adjustment: Levenberg-Marquardt with the ray-landmark Schur
complement. Port of ``ptzjax/ba.py``: the block-tensor formulation (the
readable specification the tests hold the fast path to), the
component-wise fast path that ``run`` iterates, and the Huber-IRLS
``run_robust``.

Cameras are 3-vectors (pan, tilt, focal), rays 2-vectors; rays are
eliminated with closed-form 2x2 inverses and the small dense (3K x 3K)
reduced camera system is solved by Cholesky (``cholesky_ex`` + two
triangular solves, ``kernels.cholesky.solve``; a failed factor becomes
NaN, so the step is rejected as in the reference). The focal enters the
parameters as f * focal_scale.

Data layout is ray-major: an (M, C) table of observations per ray; the
flat observation order is c-major (n = c * M + m). Each ray's blocks live in
its own row, so sharding the rays over processes (``dist.run_sharded``)
needs one sum across them per LM step: ``group`` (a ``torch.distributed``
process group) makes ``run``, ``run_robust``, ``init_lm_state`` and
``run_lm`` all-reduce the camera system and the costs where the reference
calls ``psum``. With ``group=None`` nothing is reduced.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ptzjax_torch import _device
from ptzjax_torch.config import SLAMConfig
from ptzjax_torch.geometry import ANGLE_CLIP, Intrinsics, project_jacobians, project_rays
from ptzjax_torch.kernels.cholesky import solve


class BAProblem(NamedTuple):
    """Padded ray-major BA problem.

    Attributes:
      cams: (K, 3) initial keyframe poses (pan, tilt, f) — f unscaled pixels.
      rays: (M, 2) initial ray angles.
      obs_pix: (M, C, 2) observed pixel positions.
      obs_cam: (M, C) int32 camera index per observation (0 for padding).
      obs_w: (M, C) fp32 weight, 0 for padding/invalid.
      cam_free: (K,) bool — False freezes a camera (gauge fixing / padding).
    """

    cams: torch.Tensor
    rays: torch.Tensor
    obs_pix: torch.Tensor
    obs_cam: torch.Tensor
    obs_w: torch.Tensor
    cam_free: torch.Tensor


class BAResult(NamedTuple):
    cams: torch.Tensor
    rays: torch.Tensor
    cost: torch.Tensor           # final weighted SSE (px^2)
    initial_cost: torch.Tensor
    iterations: torch.Tensor     # LM iterations run
    accepted: torch.Tensor       # number of accepted steps


# --- block-tensor formulation --------------------------------------------------
#
# The normal equations written with explicit (M, C, 2, 3) camera and
# (M, C, 2, 2) ray Jacobian blocks. ``run`` does not use it: it is the
# specification the component-wise fast path below is tested against.


def _gather_obs(cams, rays, prob: BAProblem, intr: Intrinsics):
    """Weighted residuals and Jacobian blocks for every (ray, slot)
    observation: r (M, C, 2), A (M, C, 2, 3) wrt (pan, tilt, f), B (M, C,
    2, 2) wrt the ray."""
    m, c = prob.obs_cam.shape
    cam_per_obs = cams[prob.obs_cam.long()]                       # (M, C, 3)
    pix, j_cam, j_ray = project_jacobians(
        cam_per_obs.reshape(m * c, 3), rays[:, None, :].expand(m, c, 2).reshape(m * c, 1, 2), intr
    )
    r = pix.reshape(m, c, 2) - prob.obs_pix
    w = prob.obs_w[..., None]
    return r * w, j_cam.reshape(m, c, 2, 3) * w[..., None], j_ray.reshape(m, c, 2, 2) * w[..., None]


def _scale_jac(a: torch.Tensor, focal_scale: float) -> torch.Tensor:
    """Rescale the focal column for the scaled parameterization."""
    return torch.cat([a[..., :2], a[..., 2:] / focal_scale], -1)


def compute_cost(cams, rays, prob: BAProblem, intr: Intrinsics) -> torch.Tensor:
    """Weighted SSE, Jacobian-free."""
    cam_per_obs = cams[prob.obs_cam.long()]                       # (M, C, 3)
    rays_b = rays[:, None, None, :].expand(*prob.obs_cam.shape, 1, 2)
    pix = project_rays(cam_per_obs, rays_b, intr)[..., 0, :]      # (M, C, 2)
    r = (pix - prob.obs_pix) * prob.obs_w[..., None]
    return (r * r).sum()


def _cam_onehot(obs_cam: torch.Tensor, num_cams: int, dtype=torch.float32) -> torch.Tensor:
    """(M, C) camera ids -> (M, C, K) one-hot selector (padding observations
    carry weight 0, so their camera-0 rows add nothing)."""
    ids = torch.arange(num_cams, dtype=obs_cam.dtype, device=obs_cam.device)
    return (obs_cam[..., None] == ids).to(dtype)


def normal_terms(cams, rays, prob: BAProblem, intr: Intrinsics, focal_scale: float):
    """Per-shard LM normal-equation terms.

    Returns:
      u (K, 3, 3) camera blocks, g_c (K, 3), v (M, 2, 2) ray blocks,
      g_r (M, 2), w_blk (M, C, 3, 2) = A^T B.
    """
    k = cams.shape[0]
    r, a, b = _gather_obs(cams, rays, prob, intr)
    a = _scale_jac(a, focal_scale)
    e = _cam_onehot(prob.obs_cam, k, a.dtype)                     # (M, C, K)
    ata = torch.einsum("mcab,mcad->mcbd", a, a)                   # (M, C, 3, 3)
    atr = torch.einsum("mcab,mca->mcb", a, r)                     # (M, C, 3)
    u = torch.einsum("mck,mcbd->kbd", e, ata)                     # (K, 3, 3)
    g_c = torch.einsum("mck,mcb->kb", e, atr)                     # (K, 3)
    v = torch.einsum("mcab,mcad->mbd", b, b)                      # (M, 2, 2)
    g_r = torch.einsum("mcab,mca->mb", b, r)                      # (M, 2)
    w_blk = torch.einsum("mcab,mcad->mcbd", a, b)                 # (M, C, 3, 2)
    return u, g_c, v, g_r, w_blk


def _inv2x2(v: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Batched closed-form 2x2 inverse; padding rows (zero blocks) -> ~0."""
    a, b_ = v[..., 0, 0], v[..., 0, 1]
    c, d = v[..., 1, 0], v[..., 1, 1]
    det = a * d - b_ * c + eps
    return torch.stack([torch.stack([d, -b_], -1), torch.stack([-c, a], -1)], -2) / det[..., None, None]


def schur_local(v, g_r, w_blk, obs_cam, num_cams: int, lam):
    """Shard-local Schur-correction contributions: only this shard's ray
    rows are touched, so a sharded solve sums the returned (K, K, 3, 3) and
    (K, 3) blocks across shards. Returns (s_corr, rhs_corr, v_inv); v_inv
    is reused by ``back_substitute``."""
    v_inv = _inv2x2(_damp(v, lam))                                # (M, 2, 2)
    y = torch.einsum("mcab,mbd->mcad", w_blk, v_inv)              # (M, C, 3, 2)
    e = _cam_onehot(obs_cam, num_cams, w_blk.dtype)               # (M, C, K)
    gy = torch.einsum("mck,mcae->mkae", e, y)                     # (M, K, 3, 2)
    gw = torch.einsum("mck,mcae->mkae", e, w_blk)
    s_corr = torch.einsum("mkae,mlbe->klab", gy, gw)              # (K, K, 3, 3)
    rhs_corr = torch.einsum("mkae,me->ka", gy, g_r)               # (K, 3)
    return s_corr, rhs_corr, v_inv


def schur_reduce(u, g_c, v, g_r, w_blk, obs_cam, cam_free, lam):
    """Single-shard convenience: local contributions + assembly."""
    s_corr, rhs_corr, _ = schur_local(v, g_r, w_blk, obs_cam, u.shape[0], lam)
    return schur_assemble(u, g_c, s_corr, rhs_corr, cam_free, lam)


def back_substitute(v_inv, g_r, w_blk, obs_cam, dc):
    """Per-ray updates dr_j = V_j^-1 (-g_rj - sum_c W_jc^T dc_cam)."""
    dc_blocks = dc.reshape(-1, 3)
    wt_dc = torch.einsum("mcab,mca->mb", w_blk, dc_blocks[obs_cam.long()])   # (M, 2)
    return torch.einsum("mab,mb->ma", v_inv, -g_r - wt_dc)


def lm_iteration(cams, rays, lam, prob: BAProblem, intr: Intrinsics, cfg: SLAMConfig, group=None):
    """One damped step (the fast path, its invariants rebuilt): the
    candidate parameters; the caller decides acceptance."""
    return _lm_iteration_fast(cams, rays, lam, prob, precompute(prob), intr, cfg, group=group)


def _all_reduce(tensors, group):
    """The sum of each tensor over ``group``, as one all-reduce of their
    concatenation; the tensors themselves where ``group`` is None."""
    if group is None:
        return tensors
    import torch.distributed as tdist

    flat = torch.cat([t.reshape(-1) for t in tensors])
    tdist.all_reduce(flat, op=tdist.ReduceOp.SUM, group=group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape))
        at += t.numel()
    return out


# --- fast path -----------------------------------------------------------------


class BAPrecomp(NamedTuple):
    """LM-loop invariants (functions of the observation tables only).

    Attributes:
      e_flat: (N, K) one-hot camera selector, N = C * M.
      obs_cam_t: (C, M) int32; obs_x_t, obs_y_t, w_t: (C, M) fp32.
    """

    e_flat: torch.Tensor
    obs_cam_t: torch.Tensor
    obs_x_t: torch.Tensor
    obs_y_t: torch.Tensor
    w_t: torch.Tensor


def precompute(prob: BAProblem) -> BAPrecomp:
    k = prob.cams.shape[0]
    obs_cam_t = prob.obs_cam.T.contiguous()                      # (C, M)
    cam_ids = torch.arange(k, dtype=torch.int32, device=obs_cam_t.device)
    return BAPrecomp(
        e_flat=(obs_cam_t.reshape(-1)[:, None] == cam_ids).to(torch.float32),
        obs_cam_t=obs_cam_t,
        obs_x_t=prob.obs_pix[..., 0].T.contiguous(),
        obs_y_t=prob.obs_pix[..., 1].T.contiguous(),
        w_t=prob.obs_w.T.contiguous(),
    )


def _per_obs_cam_params(cams: torch.Tensor, pre: BAPrecomp):
    """(pan, tilt, f) per observation as three (C, M) arrays, via one
    (3, K) x (K, N) matmul against the one-hot selector."""
    c, m = pre.obs_cam_t.shape
    camt = (cams.T @ pre.e_flat.T).reshape(3, c, m)
    return camt[0], camt[1], camt[2]


def _projection_comps(cams, rays, pre: BAPrecomp, intr: Intrinsics):
    """Residual and trig components, all (C, M) elementwise."""
    pan, tilt, f = _per_obs_cam_params(cams, pre)
    u = (rays[None, :, 0] - pan).clamp(-ANGLE_CLIP, ANGLE_CLIP)
    v = (rays[None, :, 1] - tilt).clamp(-ANGLE_CLIP, ANGLE_CLIP)
    tu = torch.tan(u)
    tv = torch.tan(v)
    su = 1.0 / torch.cos(u)
    sv = 1.0 / torch.cos(v)
    w = pre.w_t
    r0 = (f * tu + float(intr.cx) - pre.obs_x_t) * w
    r1 = (-f * tv * su + float(intr.cy) - pre.obs_y_t) * w
    return f, tu, tv, su, sv, w, r0, r1


def fast_cost(cams, rays, prob: BAProblem, pre: BAPrecomp, intr) -> torch.Tensor:
    *_, r0, r1 = _projection_comps(cams, rays, pre, intr)
    return (r0 * r0 + r1 * r1).sum()


def _damp(h: torch.Tensor, lam: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """LM damping: H + lam * diag(H) + eps I (Marquardt scaling)."""
    eye = torch.eye(h.shape[-1], dtype=h.dtype, device=h.device)
    return h + lam * (h * eye) + eps * eye


def _fast_terms(cams, rays, lam, prob: BAProblem, pre: BAPrecomp, intr, fs: float):
    """All LM normal-equation terms, component-wise (B = -A[:, :2]): the
    camera blocks, the Schur corrections, and the per-ray pieces that back
    substitution needs."""
    k = cams.shape[0]
    c, m = pre.obs_cam_t.shape
    f, tu, tv, su, sv, w, r0, r1 = _projection_comps(cams, rays, pre, intr)

    # weighted Jacobian components; col 2 carries the focal scaling
    a00 = -f * su * su * w
    a02 = tu * w / fs
    a10 = f * tv * su * tu * w
    a11 = f * sv * sv * su * w
    a12 = -tv * su * w / fs

    q00 = a00 * a00 + a10 * a10
    q01 = a10 * a11
    q02 = a00 * a02 + a10 * a12
    q11 = a11 * a11
    q12 = a11 * a12
    q22 = a02 * a02 + a12 * a12
    atr0 = a00 * r0 + a10 * r1
    atr1 = a11 * r1
    atr2 = a02 * r0 + a12 * r1

    # camera system: one (9, N) x (N, K) matmul replaces both segment sums
    p9 = torch.stack([q00, q01, q02, q11, q12, q22, atr0, atr1, atr2]).reshape(9, c * m)
    ug = p9 @ pre.e_flat                                         # (9, K)
    u = torch.stack(
        [
            torch.stack([ug[0], ug[1], ug[2]], -1),
            torch.stack([ug[1], ug[3], ug[4]], -1),
            torch.stack([ug[2], ug[4], ug[5]], -1),
        ],
        -2,
    )                                                            # (K, 3, 3)
    g_c = ug[6:9].T                                              # (K, 3)

    # per-ray 2x2 system and its damped closed-form inverse
    v00 = q00.sum(0)
    v01 = q01.sum(0)
    v11 = q11.sum(0)
    gr0 = -atr0.sum(0)
    gr1 = -atr1.sum(0)
    d00 = v00 * (1.0 + lam) + 1e-8
    d11 = v11 * (1.0 + lam) + 1e-8
    det = d00 * d11 - v01 * v01 + 1e-10
    i00 = d11 / det
    i01 = -v01 / det
    i11 = d00 / det

    # per-obs W = -q[:, :2] and Y = W V^-1 (6 components each)
    w_col0 = (-q00, -q01, -q02)
    w_col1 = (-q01, -q11, -q12)
    y = []
    for a in range(3):
        y.append(w_col0[a] * i00[None, :] + w_col1[a] * i01[None, :])
        y.append(w_col0[a] * i01[None, :] + w_col1[a] * i11[None, :])

    # project Y and W onto camera columns: gy/gw (6, M, K)
    e3 = pre.e_flat.reshape(c, m, k)
    wl = [w_col0[0], w_col1[0], w_col0[1], w_col1[1], w_col0[2], w_col1[2]]
    ys = torch.stack(y)                                          # (6, C, M)
    ws = torch.stack(wl)
    gy = torch.einsum("pcm,cmk->pmk", ys, e3)
    gw = torch.einsum("pcm,cmk->pmk", ws, e3)

    # Schur correction: one (6K, M) x (M, 6K) product, then fold the inner
    # 2-dim pairs: s_corr[k,l,a,b] = sum_e z[(a,e),k,(b,e),l]
    z = torch.einsum("pmk,qml->pkql", gy, gw)                    # (6,K,6,K)
    z6 = z.reshape(3, 2, k, 3, 2, k)
    s_corr = (z6[:, 0, :, :, 0, :] + z6[:, 1, :, :, 1, :]).permute(1, 3, 0, 2)

    grs = torch.stack([gr0, gr1, gr0, gr1, gr0, gr1])            # (6, M)
    rhs6 = torch.einsum("pmk,pm->pk", gy, grs)                   # (6, K)
    rhs_corr = rhs6.reshape(3, 2, k).sum(1).T                    # (K, 3)

    local = (w_col0, w_col1, (gr0, gr1), (i00, i01, i11))
    return u, g_c, s_corr, rhs_corr, local


def schur_assemble(u, g_c, s_corr, rhs_corr, cam_free, lam):
    """The damped, gauge-fixed reduced (3K, 3K) system and its rhs; frozen
    cameras get identity rows/cols and zero rhs."""
    k = u.shape[0]
    ar = torch.arange(k, device=u.device)
    s = torch.zeros((k, k, 3, 3), dtype=u.dtype, device=u.device)
    s[ar, ar] = _damp(u, lam)
    s = s - s_corr
    rhs = -g_c + rhs_corr                                        # (K, 3)

    free = cam_free.to(u.dtype)
    s = s * free[:, None, None, None] * free[None, :, None, None]
    eye3 = torch.eye(3, dtype=u.dtype, device=u.device)
    s[ar, ar] = s[ar, ar] + (1.0 - free)[:, None, None] * eye3
    rhs = rhs * free[:, None]
    return s.permute(0, 2, 1, 3).reshape(3 * k, 3 * k), rhs.reshape(-1)


def _fast_back_substitute(dc, pre: BAPrecomp, local):
    """dr_j = V_j^{-1}(-g_rj - sum W^T dc) from the component arrays."""
    (w_col0, w_col1, (gr0, gr1), (i00, i01, i11)) = local
    c, m = pre.obs_cam_t.shape
    dct = (dc.reshape(-1, 3).T @ pre.e_flat.T).reshape(3, c, m)  # (3, C, M)
    wt0 = (w_col0[0] * dct[0] + w_col0[1] * dct[1] + w_col0[2] * dct[2]).sum(0)
    wt1 = (w_col1[0] * dct[0] + w_col1[1] * dct[1] + w_col1[2] * dct[2]).sum(0)
    rhs0 = -gr0 - wt0
    rhs1 = -gr1 - wt1
    return torch.stack([i00 * rhs0 + i01 * rhs1, i01 * rhs0 + i11 * rhs1], -1)


def _lm_iteration_fast(cams, rays, lam, prob: BAProblem, pre: BAPrecomp, intr, cfg: SLAMConfig, group=None):
    """One damped step: build, reduce (over ``group``'s ray shards), solve,
    back-substitute. Returns the candidate parameters (the caller decides
    acceptance)."""
    fs = cfg.ba_focal_scale
    u, g_c, s_corr, rhs_corr, local = _fast_terms(cams, rays, lam, prob, pre, intr, fs)
    u, g_c, s_corr, rhs_corr = _all_reduce((u, g_c, s_corr, rhs_corr), group)
    s, rhs = schur_assemble(u, g_c, s_corr, rhs_corr, prob.cam_free, lam)
    chol, info = torch.linalg.cholesky_ex(s)
    chol = torch.where(info == 0, chol, torch.full_like(chol, float("nan")))
    dc = solve(chol, rhs[:, None])[:, 0]
    dr = _fast_back_substitute(dc, pre, local)
    scale = _device.const((1.0, 1.0, 1.0 / fs), dc.device)
    new_cams = cams + dc.reshape(-1, 3) * scale * prob.cam_free[:, None]
    return new_cams, rays + dr


class LMState(NamedTuple):
    """LM-loop carry."""

    cams: torch.Tensor
    rays: torch.Tensor
    lam: torch.Tensor
    cost: torch.Tensor
    accepted: torch.Tensor
    iterations: torch.Tensor


def init_lm_state(prob: BAProblem, intr: Intrinsics, cfg: SLAMConfig, group=None) -> LMState:
    pre = precompute(prob)
    dev = prob.cams.device
    (cost0,) = _all_reduce((fast_cost(prob.cams, prob.rays, prob, pre, intr),), group)
    return LMState(
        cams=prob.cams,
        rays=prob.rays,
        lam=torch.full((), cfg.ba_lambda0, dtype=prob.cams.dtype, device=dev),
        cost=cost0,
        accepted=torch.zeros((), dtype=torch.int32, device=dev),
        iterations=torch.zeros((), dtype=torch.int32, device=dev),
    )


def run_lm(
    prob: BAProblem, intr: Intrinsics, cfg: SLAMConfig, lm: LMState, num_iters: int | None = None,
    group=None,
) -> LMState:
    """Advance the LM loop ``num_iters`` damped steps from ``lm``: rejected
    steps keep the parameters and raise lambda, accepted ones lower it. Runs
    without host syncs (accept/reject is a device-side select). With
    ``group``, ``prob`` holds this process's ray shard: the camera system
    and the costs are summed over the group, the camera solve is the same on
    every process, rays stay local."""
    pre = precompute(prob)
    n = cfg.ba_iters if num_iters is None else num_iters
    for _ in range(n):
        cand_cams, cand_rays = _lm_iteration_fast(lm.cams, lm.rays, lm.lam, prob, pre, intr, cfg, group)
        (cand_cost,) = _all_reduce((fast_cost(cand_cams, cand_rays, prob, pre, intr),), group)
        ok = cand_cost < lm.cost
        lm = LMState(
            cams=torch.where(ok, cand_cams, lm.cams),
            rays=torch.where(ok, cand_rays, lm.rays),
            lam=torch.where(ok, lm.lam * cfg.ba_lambda_down, lm.lam * cfg.ba_lambda_up).clamp(
                1e-10, 1e6
            ),
            cost=torch.where(ok, cand_cost, lm.cost),
            accepted=lm.accepted + ok.to(torch.int32),
            iterations=lm.iterations + 1,
        )
    return lm


def run(prob: BAProblem, intr: Intrinsics, cfg: SLAMConfig, group=None) -> BAResult:
    """Full LM loop with accept/reject, ``cfg.ba_iters`` iterations (over
    ``group``'s ray shards where it is given)."""
    lm0 = init_lm_state(prob, intr, cfg, group)
    lm = run_lm(prob, intr, cfg, lm0, group=group)
    return BAResult(
        cams=lm.cams,
        rays=lm.rays,
        cost=lm.cost,
        initial_cost=lm0.cost,
        iterations=lm.iterations,
        accepted=lm.accepted,
    )


def huber_factors(cams, rays, prob: BAProblem, intr: Intrinsics, huber_px: float) -> torch.Tensor:
    """(M, C) Huber IRLS factors from the current residual norms: 1 inside
    ``huber_px``, sqrt(huber/|r|) beyond (0 for padding), so an outlier's
    squared term has linear, not quadratic, influence."""
    pre = precompute(prob)
    *_, w, r0, r1 = _projection_comps(cams, rays, pre, intr)
    rn = torch.sqrt(r0 * r0 + r1 * r1) / w.clamp_min(1e-9)     # unweighted |r|
    wh = torch.sqrt((huber_px / rn.clamp_min(1e-9)).clamp(max=1.0))
    return torch.where(w > 0, wh, 0.0).T                       # (M, C)


def run_robust(
    prob: BAProblem, intr: Intrinsics, cfg: SLAMConfig, rounds: int | None = None, group=None
) -> BAResult:
    """Huber-IRLS robust BA: ``rounds`` (default ``cfg.ba_irls_rounds``)
    times, reweight every observation by the Huber factor
    (``cfg.ba_huber_px``) of its residual at the current parameters, then run
    the LM solve from them. The first weights come from the initial
    parameters. ``initial_cost`` is the first round's starting cost, ``cost``
    the last round's final cost under its own weights. rounds=0 is ``run``.
    With ``group``, each process weights its own rays and every round's LM
    solve is summed over the group."""
    rounds = cfg.ba_irls_rounds if rounds is None else rounds
    if rounds <= 0:
        return run(prob, intr, cfg, group)
    base_w = prob.obs_w
    init_cost = None
    for _ in range(rounds):
        wh = huber_factors(prob.cams, prob.rays, prob._replace(obs_w=base_w), intr, cfg.ba_huber_px)
        prob = prob._replace(obs_w=base_w * wh)
        res = run(prob, intr, cfg, group)
        if init_cost is None:
            init_cost = res.initial_cost
        prob = prob._replace(cams=res.cams, rays=res.rays)
    return res._replace(initial_cost=init_cost)
