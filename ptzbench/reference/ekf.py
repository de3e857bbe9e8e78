"""MonoSLAM-style EKF over the PTZ camera with joint ray landmarks. Port of
``ptzjax/ekf.py``.

State layout, BLOCKED as in the reference:
    x = (pan, tilt, f, d_pan, d_tilt, d_f, theta_1..theta_N, phi_1..phi_N)
with dense covariance P of size (6 + 2N)^2, and the measurement space
blocked the same way: residual = (x_1..x_N, y_1..y_N). Every per-slot 2x2
ray Jacobian is then a diagonal of an (N, N) block, so the measurement
algebra is broadcasting plus (*, 3) matmuls.

Masking: an inactive or unobserved slot has its H rows and innovation
zeroed, so the update is exactly the update of the observed subproblem;
inactive P blocks are kept at identity.

The innovation matrix S is factored by ``kernels.cholesky.cholesky`` (the
Hopper kernel on the card, ``torch.linalg.cholesky_ex`` on the CPU) and
solved by two triangular solves (``kernels.cholesky.solve``), in full
fp32. The reference's blocked factor-and-invert
(``_inv_chol`` / ``_inv_lower``) and its matmul precision tiers are TPU
workarounds and are not ported. A non-PD innovation matrix does not raise:
its factor is set to NaN, the NaN reaches the finiteness check and the
frame becomes a no-op flagged LOST, as with ``jnp.linalg.cholesky``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ptzbench.reference import _device
from ptzbench.reference.config import SLAMConfig
from ptzbench.reference.geometry import Intrinsics, back_project_pixels, project_jacobians
from ptzbench.reference.kernels.cholesky import cholesky, solve


class EKFState(NamedTuple):
    """Padded EKF state. N = ray-slot capacity; dim D = 6 + 2N.

    Attributes:
      cam: (6,) pan, tilt, f, and their per-frame velocities.
      rays: (N, 2) slot ray angles (theta, phi); garbage where inactive.
      cov: (D, D) joint covariance.
      active: (N,) bool slot validity.
      missed: (N,) int32 consecutive frames without an observation.
      rej: (N,) int32 consecutive frames whose matched observation failed
        the motion-consensus gate.
      ray_ids: (N,) int32 global map ray id per slot (-1 = empty).
    """

    cam: torch.Tensor
    rays: torch.Tensor
    cov: torch.Tensor
    active: torch.Tensor
    missed: torch.Tensor
    rej: torch.Tensor
    ray_ids: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.rays.shape[0]

    @property
    def pose(self) -> torch.Tensor:
        """(pan, tilt, f) 3-vector."""
        return self.cam[:3]


def init_state(pose, cfg: SLAMConfig, device=None) -> EKFState:
    """Fresh state around a known initial pose; the camera starts nearly
    exactly known, velocities get the init prior."""
    pose = torch.as_tensor(pose, dtype=torch.float32, device=device)
    dev = pose.device
    n = cfg.max_rays
    d = 6 + 2 * n
    cam = torch.cat([pose, torch.zeros(3, dtype=torch.float32, device=dev)])
    cam_prior = (1e-6, 1e-6, 1e-6, cfg.init_vel_std**2, cfg.init_vel_std**2, cfg.init_vel_std_f**2)
    diag = torch.cat(
        [_device.const(cam_prior, dev), torch.ones(2 * n, dtype=torch.float32, device=dev)]
    )
    return EKFState(
        cam=cam,
        rays=torch.zeros((n, 2), dtype=torch.float32, device=dev),
        cov=torch.diag(diag),
        active=torch.zeros(n, dtype=torch.bool, device=dev),
        missed=torch.zeros(n, dtype=torch.int32, device=dev),
        rej=torch.zeros(n, dtype=torch.int32, device=dev),
        ray_ids=torch.full((n,), -1, dtype=torch.int32, device=dev),
    )


def _process_noise(n: int, cfg: SLAMConfig, device=None) -> torch.Tensor:
    """(D,) diagonal of the constant-velocity process noise (fp32 products,
    as in the reference), kept on the device."""
    accel = np.array([cfg.sigma_pan**2, cfg.sigma_tilt**2, cfg.sigma_focal**2], np.float32)
    pos = accel * np.float32(cfg.dt**2)
    values = tuple(float(v) for v in np.concatenate([pos, accel])) + (0.0,) * (2 * n)
    return _device.const(values, torch.device(device or "cpu"))


def predict(state: EKFState, cfg: SLAMConfig) -> EKFState:
    """Constant-velocity predict; rays are static. F = I with dt coupling on
    the camera block, applied structurally."""
    cam = state.cam.clone()
    cam[0:3] = cam[0:3] + cfg.dt * state.cam[3:6]
    p = state.cov.clone()
    p[0:3, :] = p[0:3, :] + cfg.dt * p[3:6, :]
    p[:, 0:3] = p[:, 0:3] + cfg.dt * p[:, 3:6]
    p.diagonal().add_(_process_noise(state.capacity, cfg, p.device))
    return state._replace(cam=cam, cov=p)


class UpdateStats(NamedTuple):
    num_used: torch.Tensor        # observations that passed gating
    num_observed: torch.Tensor    # observations offered (active slot + valid)
    innovation_rms: torch.Tensor  # gated-innovation RMS in pixels
    lost: torch.Tensor            # bool: too few inliers => tracking lost
    used_mask: torch.Tensor       # (N,) bool: slot's observation passed the gate


def _nan_if_failed(factor: torch.Tensor, info: torch.Tensor) -> torch.Tensor:
    """A failed Cholesky factor becomes all-NaN (``jnp.linalg.cholesky``'s
    behaviour), without a host sync."""
    return torch.where(info == 0, factor, torch.full_like(factor, float("nan")))


def update(
    state: EKFState,
    obs: torch.Tensor,
    obs_mask: torch.Tensor,
    intr: Intrinsics,
    cfg: SLAMConfig,
) -> tuple[EKFState, UpdateStats]:
    """Joint EKF measurement update from slot-aligned pixel observations
    obs (N, 2), obs_mask (N,): Mahalanobis gate with the gate rescue, joint
    gain, Joseph-form covariance, a 1e-8 floor on the diagonal, and a
    one-frame no-op on a non-finite posterior."""
    n = state.capacity
    d = 6 + 2 * n
    dev = state.cam.device
    pose = state.cam[:3]
    offered = obs_mask & state.active

    pred_pix, j_cam, j_ray = project_jacobians(pose, state.rays, intr)
    innov = obs - pred_pix  # (N, 2)

    jcx = j_cam[:, 0, :]                                 # (N, 3)
    jcy = j_cam[:, 1, :]
    jra = j_ray[:, 0, 0]                                 # (N,) dx/dtheta
    jrb = j_ray[:, 0, 1]                                 # dx/dphi
    jrc = j_ray[:, 1, 0]                                 # dy/dtheta
    jrd = j_ray[:, 1, 1]                                 # dy/dphi

    def pht_of(cov, jc, a, b):
        """P H_c^T for one measurement component: (D, N)."""
        return cov[:, 0:3] @ jc.T + cov[:, 6 : 6 + n] * a[None, :] + cov[:, 6 + n :] * b[None, :]

    pht_x = pht_of(state.cov, jcx, jra, jrb)             # (D, N)
    pht_y = pht_of(state.cov, jcy, jrc, jrd)

    def s_diag(pht, jc, a, b):
        """diag(H_c (P H_e^T)): the per-slot entry of one 2x2 gate block."""
        return (
            (jc * pht[0:3].T).sum(1)
            + a * torch.diagonal(pht[6 : 6 + n])
            + b * torch.diagonal(pht[6 + n :])
        )

    # Mahalanobis gate against the predicted per-slot innovation covariance
    sig2 = cfg.sigma_obs**2
    s00 = s_diag(pht_x, jcx, jra, jrb) + sig2
    s01 = s_diag(pht_y, jcx, jra, jrb)
    s11 = s_diag(pht_y, jcy, jrc, jrd) + sig2
    ix, iy = innov[:, 0], innov[:, 1]
    det = s00 * s11 - s01 * s01
    maha2 = (s11 * ix**2 - 2.0 * s01 * ix * iy + s00 * iy**2) / det.clamp_min(1e-12)
    px_ok = torch.linalg.vector_norm(innov, dim=-1) < cfg.innovation_gate_px
    used = offered & (maha2 < cfg.gate_maha2) & px_ok

    # gate rescue: a coherent acceleration past the tight gate with a large
    # consistent set inside a widened gate is trusted, not declared lost
    used_wide = offered & (maha2 < cfg.gate_rescue_factor * cfg.gate_maha2) & px_ok
    rescue = (used.sum() < cfg.min_inliers) & (used_wide.sum() >= 3 * cfg.min_inliers)
    used = torch.where(rescue, used_wide, used)
    u1 = used.to(torch.float32)                          # (N,)
    innov = torch.where(used[:, None], innov, torch.zeros_like(innov))

    # apply the gate: zero unused Jacobian rows
    jcx = jcx * u1[:, None]
    jcy = jcy * u1[:, None]
    jra = jra * u1
    jrb = jrb * u1
    jrc = jrc * u1
    jrd = jrd * u1

    ph_t = torch.cat([pht_x, pht_y], dim=1) * torch.cat([u1, u1])[None, :]  # (D, 2N)
    pht_c = ph_t[0:3]
    pht_t = ph_t[6 : 6 + n]
    pht_p = ph_t[6 + n :]
    sx = jcx @ pht_c + jra[:, None] * pht_t + jrb[:, None] * pht_p
    sy = jcy @ pht_c + jrc[:, None] * pht_t + jrd[:, None] * pht_p
    s = torch.cat([sx, sy], dim=0)                       # (2N, 2N)
    s = 0.5 * (s + s.T)
    r_diag = torch.full((2 * n,), sig2, dtype=torch.float32, device=dev)
    s = s + torch.diag(r_diag)
    # K = PHT S^-1 through the Cholesky factor of S
    chol, info = cholesky(s)
    chol = _nan_if_failed(chol, info)
    k = solve(chol, ph_t.T.contiguous()).T  # (D, 2N)

    dx = k @ torch.cat([innov[:, 0], innov[:, 1]])
    cam = state.cam + dx[:6]
    rays = state.rays + torch.stack([dx[6 : 6 + n], dx[6 + n :]], dim=-1)

    # Joseph-form covariance update; K H reuses the blocked structure
    kx = k[:, :n]
    ky = k[:, n:]
    kh = torch.cat(
        [
            kx @ jcx + ky @ jcy,
            torch.zeros((d, 3), dtype=torch.float32, device=dev),
            kx * jra[None, :] + ky * jrc[None, :],
            kx * jrb[None, :] + ky * jrd[None, :],
        ],
        dim=1,
    )
    ikh = torch.eye(d, dtype=torch.float32, device=dev) - kh
    cov = (ikh @ state.cov) @ ikh.T + (k * r_diag[None, :]) @ k.T
    cov = 0.5 * (cov + cov.T)
    # floor the diagonal: a negative variance would silently disable every
    # chi-square test downstream
    dg = torch.diagonal(cov).clone()
    cov = cov + torch.diag(dg.clamp_min(1e-8) - dg)

    num_used = used.sum()
    num_obs = offered.sum()
    rms = torch.sqrt((innov**2).sum() / (2.0 * num_used.to(torch.float32)).clamp_min(1.0))
    # a non-finite posterior becomes a ONE-FRAME NO-OP flagged lost
    finite = torch.isfinite(cam).all() & torch.isfinite(dg).all() & torch.isfinite(rays).all()
    cam = torch.where(finite, cam, state.cam)
    rays = torch.where(finite, rays, state.rays)
    cov = torch.where(finite, cov, state.cov)
    stats = UpdateStats(
        num_used=num_used,
        num_observed=num_obs,
        innovation_rms=rms,
        lost=(num_used < cfg.min_inliers) | ~finite,
        used_mask=used & finite,
    )
    missed = torch.where(stats.used_mask, 0, state.missed + state.active.to(torch.int32))
    return state._replace(cam=cam, rays=rays, cov=cov, missed=missed), stats


def retire_lost(state: EKFState, cfg: SLAMConfig) -> EKFState:
    """Free slots unobserved for too long or rejected too often."""
    drop = state.active & ((state.missed > cfg.max_missed) | (state.rej >= cfg.max_rejected))
    return _clear_slots(state, drop)


def _slot_rows(sel: torch.Tensor) -> torch.Tensor:
    """(D,) bool: the state rows of the selected slots (6+i and 6+N+i)."""
    return torch.cat([torch.zeros(6, dtype=torch.bool, device=sel.device), sel, sel])


def _clear_slots(state: EKFState, drop: torch.Tensor) -> EKFState:
    keep = ~drop
    full = _slot_rows(drop)
    # reset dropped slots' covariance to identity, zero cross terms
    cov = torch.where(full[:, None] | full[None, :], 0.0, state.cov)
    cov = cov + torch.diag(full.to(torch.float32))
    return state._replace(
        active=state.active & keep,
        ray_ids=torch.where(keep, state.ray_ids, -1),
        cov=cov,
        missed=torch.where(keep, state.missed, 0),
        rej=torch.where(keep, state.rej, 0),
    )


class SlotClaim(NamedTuple):
    """Candidate -> free-slot assignment: the j-th accepted candidate claims
    the j-th free slot.

    Attributes:
      cand_ok: (K,) candidate accepted (masked in and a free slot exists).
      target: (K,) slot index per candidate (n where rejected).
      newly: (N,) bool slot claimed in this call.
      cand_of_slot: (N,) claiming candidate per slot (k where none).
    """

    cand_ok: torch.Tensor
    target: torch.Tensor
    newly: torch.Tensor
    cand_of_slot: torch.Tensor


def claim_slots(active: torch.Tensor, cand_mask: torch.Tensor) -> SlotClaim:
    """Assign accepted candidates to free slots (rank -> index maps via
    searchsorted over the rank cumsums)."""
    n = active.shape[0]
    k = cand_mask.shape[0]
    dev = active.device
    free = ~active
    csf = torch.cumsum(free.to(torch.int64), 0)          # (N,) nondecreasing
    free_rank = csf - 1
    cand_csum = torch.cumsum(cand_mask.to(torch.int64), 0)
    cand_rank = cand_csum - 1
    num_free = csf[-1]
    cand_ok = cand_mask & (cand_rank < num_free)
    num_ok = cand_ok.sum()
    slot_of_rank = torch.searchsorted(csf, torch.arange(1, k + 1, device=dev))
    target = torch.where(cand_ok, slot_of_rank[cand_rank.clamp(0, k - 1)], n)
    newly = free & (free_rank < num_ok)
    idx_by_rank = torch.searchsorted(cand_csum, torch.arange(1, n + 1, device=dev))
    cand_of_slot = torch.where(newly, idx_by_rank[free_rank.clamp(0, n - 1)], k)
    return SlotClaim(cand_ok, target, newly, cand_of_slot)


def _back_project_jacobians(pose: torch.Tensor, pixels: torch.Tensor, intr: Intrinsics):
    """Closed-form Jacobians of ``back_project_pixels`` wrt the pose
    (K, 2, 3) and the pixel (K, 2, 2); the reference takes them with
    ``jax.jacfwd`` of the same function."""
    f = pose[2]
    dxp = pixels[:, 0] - float(intr.cx)
    dyp = pixels[:, 1] - float(intr.cy)
    u = torch.atan2(dxp, f)
    r2 = dxp * dxp + f * f
    du_dx = f / r2
    du_df = -dxp / r2
    a = -dyp * torch.cos(u)
    q2 = a * a + f * f
    da_du = dyp * torch.sin(u)
    one = torch.ones_like(dxp)
    zero = torch.zeros_like(dxp)
    dphi_df = (f * (da_du * du_df) - a) / q2
    dphi_dx = f * (da_du * du_dx) / q2
    dphi_dy = f * (-torch.cos(u)) / q2
    g_cam = torch.stack(
        [torch.stack([one, zero, du_df], -1), torch.stack([zero, one, dphi_df], -1)], -2
    )
    g_pix = torch.stack(
        [torch.stack([du_dx, zero], -1), torch.stack([dphi_dx, dphi_dy], -1)], -2
    )
    return g_cam, g_pix


def insert_rays(
    state: EKFState,
    pixels: torch.Tensor,
    cand_mask: torch.Tensor,
    cand_ids: torch.Tensor,
    intr: Intrinsics,
    cfg: SLAMConfig,
) -> EKFState:
    """Back-project fresh keypoints into free slots, MonoSLAM-style: the new
    ray is g(pose, pixel), with covariance G_c P_cc G_c^T + G_p R G_p^T and
    full cross-covariance G_c P_c,* against the existing state.

    Args:
      pixels: (K, 2) candidate keypoint positions.
      cand_mask: (K,) bool — candidate is real.
      cand_ids: (K,) int32 global ray ids to record.
    """
    n = state.capacity
    k = pixels.shape[0]
    d = 6 + 2 * n
    dev = pixels.device
    pose = state.cam[:3]
    new_rays = back_project_pixels(pose, pixels, intr)   # (K, 2)
    g_cam, g_pix = _back_project_jacobians(pose, pixels, intr)

    claim = claim_slots(state.active, cand_mask)
    sel = claim.newly                                     # (N,)
    safe = claim.cand_of_slot.clamp(0, k - 1)             # (N,) gather index

    rays = torch.where(sel[:, None], new_rays[safe], state.rays)
    active = state.active | sel
    ray_ids = torch.where(sel, cand_ids[safe].to(torch.int32), state.ray_ids)
    missed = torch.where(sel, 0, state.missed)
    rej = torch.where(sel, 0, state.rej)

    # --- covariance augmentation (slot-major, blocked) ---
    zero2 = sel[:, None, None].to(torch.float32)
    g_cam_s = g_cam[safe] * zero2                         # (N,2,3), 0 if old
    g_pix_s = g_pix[safe] * zero2                         # (N,2,2)
    g_t = g_cam_s[:, 0, :]                                # (N,3) d theta/d pose
    g_p = g_cam_s[:, 1, :]                                # (N,3) d phi/d pose

    # 1) clear the claimed slots' rows/cols
    full = _slot_rows(sel)
    cov = torch.where(full[:, None] | full[None, :], 0.0, state.cov)

    # 2) cross-covariance of new rays vs the whole (cleared) state
    zeros6 = torch.zeros((6, d), dtype=torch.float32, device=dev)
    cross_full = torch.cat([zeros6, g_t @ cov[0:3, :], g_p @ cov[0:3, :]])  # (D, D)
    cov = torch.where(full[:, None], cross_full, cov)
    cov = torch.where(full[None, :], cross_full.T, cov)

    # 3) new-new blocks: G_ci P_cc G_cj^T + delta_ij (G_p R G_p^T + prior)
    pcc = state.cov[0:3, 0:3]
    gt_p = g_t @ pcc                                      # (N, 3)
    gp_p = g_p @ pcc
    b_tt = gt_p @ g_t.T                                   # (N, N)
    b_tp = gt_p @ g_p.T
    b_pp = gp_p @ g_p.T
    sig2 = cfg.sigma_obs**2
    prior = (cfg.init_ray_std**2) * sel.to(torch.float32)
    d_tt = sig2 * (g_pix_s[:, 0, 0] ** 2 + g_pix_s[:, 0, 1] ** 2) + prior
    d_tp = sig2 * (g_pix_s[:, 0, 0] * g_pix_s[:, 1, 0] + g_pix_s[:, 0, 1] * g_pix_s[:, 1, 1])
    d_pp = sig2 * (g_pix_s[:, 1, 0] ** 2 + g_pix_s[:, 1, 1] ** 2) + prior
    eye_n = torch.eye(n, dtype=torch.float32, device=dev)
    b_tt = b_tt + eye_n * d_tt[:, None]
    b_tp = b_tp + eye_n * d_tp[:, None]
    b_pp = b_pp + eye_n * d_pp[:, None]
    zn6 = torch.zeros((n, 6), dtype=torch.float32, device=dev)
    blocks_full = torch.cat(
        [zeros6, torch.cat([zn6, b_tt, b_tp], 1), torch.cat([zn6, b_tp.T, b_pp], 1)]
    )
    cov = torch.where(full[:, None] & full[None, :], blocks_full, cov)

    return state._replace(
        rays=rays, active=active, ray_ids=ray_ids, missed=missed, rej=rej, cov=cov
    )


def step(
    state: EKFState, obs: torch.Tensor, obs_mask: torch.Tensor, intr: Intrinsics, cfg: SLAMConfig
) -> tuple[EKFState, UpdateStats]:
    """Predict + update: one frame of slot-aligned observations."""
    return update(predict(state, cfg), obs, obs_mask, intr, cfg)
