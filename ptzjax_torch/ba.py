"""Bundle adjustment: Levenberg-Marquardt with the ray-landmark Schur
complement. Port of ``ptzjax/ba.py``'s ``run`` (the component-wise fast
path) and its Huber-IRLS ``run_robust``; the sharded path is not here.

Cameras are 3-vectors (pan, tilt, focal), rays 2-vectors; rays are
eliminated with closed-form 2x2 inverses and the small dense (3K x 3K)
reduced camera system is solved by Cholesky (``cholesky_ex`` +
``cholesky_solve``; a failed factor becomes NaN, so the step is rejected as
in the reference). The focal enters the parameters as f * focal_scale.

Data layout is ray-major: an (M, C) table of observations per ray; the
flat observation order is c-major (n = c * M + m).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ptzjax_torch import _device
from ptzjax_torch.config import SLAMConfig
from ptzjax_torch.geometry import ANGLE_CLIP, Intrinsics


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


def _lm_iteration_fast(cams, rays, lam, prob: BAProblem, pre: BAPrecomp, intr, cfg: SLAMConfig):
    """One damped step: build, reduce, solve, back-substitute. Returns the
    candidate parameters (the caller decides acceptance)."""
    fs = cfg.ba_focal_scale
    u, g_c, s_corr, rhs_corr, local = _fast_terms(cams, rays, lam, prob, pre, intr, fs)
    s, rhs = schur_assemble(u, g_c, s_corr, rhs_corr, prob.cam_free, lam)
    chol, info = torch.linalg.cholesky_ex(s)
    chol = torch.where(info == 0, chol, torch.full_like(chol, float("nan")))
    dc = torch.cholesky_solve(rhs[:, None], chol)[:, 0]
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


def init_lm_state(prob: BAProblem, intr: Intrinsics, cfg: SLAMConfig) -> LMState:
    pre = precompute(prob)
    dev = prob.cams.device
    return LMState(
        cams=prob.cams,
        rays=prob.rays,
        lam=torch.full((), cfg.ba_lambda0, dtype=prob.cams.dtype, device=dev),
        cost=fast_cost(prob.cams, prob.rays, prob, pre, intr),
        accepted=torch.zeros((), dtype=torch.int32, device=dev),
        iterations=torch.zeros((), dtype=torch.int32, device=dev),
    )


def run_lm(
    prob: BAProblem, intr: Intrinsics, cfg: SLAMConfig, lm: LMState, num_iters: int | None = None
) -> LMState:
    """Advance the LM loop ``num_iters`` damped steps from ``lm``: rejected
    steps keep the parameters and raise lambda, accepted ones lower it. Runs
    without host syncs (accept/reject is a device-side select)."""
    pre = precompute(prob)
    n = cfg.ba_iters if num_iters is None else num_iters
    for _ in range(n):
        cand_cams, cand_rays = _lm_iteration_fast(lm.cams, lm.rays, lm.lam, prob, pre, intr, cfg)
        cand_cost = fast_cost(cand_cams, cand_rays, prob, pre, intr)
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


def run(prob: BAProblem, intr: Intrinsics, cfg: SLAMConfig) -> BAResult:
    """Full LM loop with accept/reject, ``cfg.ba_iters`` iterations."""
    lm0 = init_lm_state(prob, intr, cfg)
    lm = run_lm(prob, intr, cfg, lm0)
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


def run_robust(prob: BAProblem, intr: Intrinsics, cfg: SLAMConfig, rounds: int | None = None) -> BAResult:
    """Huber-IRLS robust BA: ``rounds`` (default ``cfg.ba_irls_rounds``)
    times, reweight every observation by the Huber factor
    (``cfg.ba_huber_px``) of its residual at the current parameters, then run
    the LM solve from them. The first weights come from the initial
    parameters. ``initial_cost`` is the first round's starting cost, ``cost``
    the last round's final cost under its own weights. rounds=0 is ``run``."""
    rounds = cfg.ba_irls_rounds if rounds is None else rounds
    if rounds <= 0:
        return run(prob, intr, cfg)
    base_w = prob.obs_w
    init_cost = None
    for _ in range(rounds):
        wh = huber_factors(prob.cams, prob.rays, prob._replace(obs_w=base_w), intr, cfg.ba_huber_px)
        prob = prob._replace(obs_w=base_w * wh)
        res = run(prob, intr, cfg)
        if init_cost is None:
            init_cost = res.initial_cost
        prob = prob._replace(cams=res.cams, rays=res.rays)
    return res._replace(initial_cost=init_cost)
