"""The port's library remainders against the reference on the CPU: the BA
block-tensor formulation (tests/test_ba.py's problems), ``ekf.step`` /
``scan_track`` (tests/test_ekf.py's uses), the EKF update against the fp64
dense-H oracle of tests/test_ekf.py and benchmarks/bench_suite.py (rebuilt
here), and ``frontend.extract_sequence``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptzjax import ba as jba
from ptzjax import ekf as jekf
from ptzjax.config import SLAMConfig
from ptzjax.frontend import extract_sequence as j_extract_sequence
from ptzjax.geometry import Intrinsics, project_jacobians, project_rays
from ptzjax_torch import ba as tba
from ptzjax_torch import ekf as tekf
from ptzjax_torch import frontend as tfront
from tests._torch_port import n, port_cfg, port_intr, render, small_cfg, t
from tests.test_ba import build_problem
from tests.test_ekf import make_test_problem

torch.set_num_threads(2)


def _port_problem(prob) -> tba.BAProblem:
    return tba.BAProblem(*(t(v) for v in prob))


def close(got, want, rtol=1e-5):
    """Within ``rtol`` of each entry, plus ``rtol`` of the array's largest
    entry (entries near zero are sums with cancellation)."""
    want = np.asarray(want)
    np.testing.assert_allclose(n(got), want, rtol=rtol, atol=rtol * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def block():
    """tests/test_ba.py's fast-vs-block problem (5 keyframes, 80 rays), the
    reference's block terms at lambda 3e-3, and the port's."""
    prob, intr, _, _, _ = build_problem(noise=0.5, seed=6, num_kf=5, num_rays_cap=80)
    fs = SLAMConfig().ba_focal_scale
    lam = 3e-3
    ref = jba.normal_terms(prob.cams, prob.rays, prob, intr, fs)
    p = _port_problem(prob)
    got = tba.normal_terms(p.cams, p.rays, p, port_intr(intr), fs)
    return prob, intr, p, fs, lam, ref, got


@pytest.mark.parametrize("i, name", list(enumerate(["u", "g_c", "v", "g_r", "w_blk"])))
def test_normal_terms_match_reference(block, i, name):
    *_, ref, got = block
    assert got[i].shape == ref[i].shape
    close(got[i], ref[i])


def test_gather_obs_and_helpers_match_reference(block):
    prob, intr, p, fs, *_ = block
    for got, want in zip(tba._gather_obs(p.cams, p.rays, p, port_intr(intr)), jba._gather_obs(prob.cams, prob.rays, prob, intr)):
        close(got, want)
    a = np.random.default_rng(0).normal(size=(4, 3, 2, 3)).astype(np.float32)
    np.testing.assert_array_equal(n(tba._scale_jac(t(a), fs)), np.asarray(jba._scale_jac(jnp.asarray(a), fs)))
    np.testing.assert_array_equal(n(tba._cam_onehot(p.obs_cam, 5)), np.asarray(jba._cam_onehot(prob.obs_cam, 5)))
    v = a[..., :2, :2] @ np.swapaxes(a[..., :2, :2], -1, -2)
    close(tba._inv2x2(t(v)), jba._inv2x2(jnp.asarray(v)))
    close(tba.compute_cost(p.cams, p.rays, p, port_intr(intr)), jba.compute_cost(prob.cams, prob.rays, prob, intr))


def test_schur_and_back_substitution_match_reference(block):
    prob, intr, p, fs, lam, ref, got = block
    k = prob.cams.shape[0]
    lam_j, lam_t = jnp.asarray(lam, jnp.float32), torch.tensor(lam)
    s_corr_j, rhs_corr_j, v_inv_j = jba.schur_local(ref[2], ref[3], ref[4], prob.obs_cam, k, lam_j)
    s_corr_t, rhs_corr_t, v_inv_t = tba.schur_local(got[2], got[3], got[4], p.obs_cam, k, lam_t)
    for a, b in ((s_corr_t, s_corr_j), (rhs_corr_t, rhs_corr_j), (v_inv_t, v_inv_j)):
        close(a, b)
    s_j, rhs_j = jba.schur_reduce(*ref, prob.obs_cam, prob.cam_free, lam_j)
    s_t, rhs_t = tba.schur_reduce(*got, p.obs_cam, p.cam_free, lam_t)
    close(s_t, s_j)
    close(rhs_t, rhs_j)
    # the same camera step on both sides isolates the back substitution
    dc = np.linalg.solve(np.asarray(s_j, np.float64), np.asarray(rhs_j, np.float64)).astype(np.float32)
    close(
        tba.back_substitute(v_inv_t, got[3], got[4], p.obs_cam, t(dc)),
        jba.back_substitute(v_inv_j, ref[3], ref[4], prob.obs_cam, jnp.asarray(dc)),
        rtol=1e-4,
    )


def test_lm_iteration_matches_reference(block):
    prob, intr, p, _, lam, *_ = block
    cfg = SLAMConfig()
    cams_j, rays_j = jba.lm_iteration(prob.cams, prob.rays, jnp.asarray(lam, jnp.float32), prob, intr, cfg)
    cams_t, rays_t = tba.lm_iteration(p.cams, p.rays, torch.tensor(lam), p, port_intr(intr), port_cfg(cfg))
    np.testing.assert_allclose(n(cams_t), np.asarray(cams_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(n(rays_t), np.asarray(rays_j), rtol=1e-4, atol=1e-6)


def test_fast_path_matches_block_formulation(block):
    """Inside the port, tests/test_ba.py's check: the component-wise fast
    path reproduces the block formulation's terms, step and cost."""
    _, intr, p, fs, lam, _, (u_b, g_c_b, v_b, g_r_b, w_blk) = block
    lam = torch.tensor(lam)
    k = p.cams.shape[0]
    s_corr_b, rhs_corr_b, v_inv = tba.schur_local(v_b, g_r_b, w_blk, p.obs_cam, k, lam)
    pre = tba.precompute(p)
    u_f, g_c_f, s_corr_f, rhs_corr_f, local = tba._fast_terms(p.cams, p.rays, lam, p, pre, port_intr(intr), fs)
    torch.testing.assert_close(u_f, u_b, rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(g_c_f, g_c_b, rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(s_corr_f, s_corr_b, rtol=1e-4, atol=1e-2)
    torch.testing.assert_close(rhs_corr_f, rhs_corr_b, rtol=1e-4, atol=1e-2)
    s, rhs = tba.schur_assemble(u_b, g_c_b, s_corr_b, rhs_corr_b, p.cam_free, lam)
    dc = torch.cholesky_solve(rhs[:, None], torch.linalg.cholesky(s))[:, 0]
    dr_b = tba.back_substitute(v_inv, g_r_b, w_blk, p.obs_cam, dc)
    torch.testing.assert_close(tba._fast_back_substitute(dc, pre, local), dr_b, rtol=1e-4, atol=1e-5)
    c_b = float(tba.compute_cost(p.cams, p.rays, p, port_intr(intr)))
    c_f = float(tba.fast_cost(p.cams, p.rays, p, pre, port_intr(intr)))
    np.testing.assert_allclose(c_f, c_b, rtol=1e-5)


def test_schur_equals_dense_solve():
    """tests/test_ba.py's check on the port's block terms: the Schur-reduced
    camera step equals the full dense fp64 normal-equation solve."""
    prob, intr, _, _, _ = build_problem(noise=0.5, seed=4, num_kf=4, num_rays_cap=60)
    p = _port_problem(prob)
    lam = 1e-3
    u, g_c, v, g_r, w_blk = tba.normal_terms(p.cams, p.rays, p, port_intr(intr), SLAMConfig().ba_focal_scale)
    s, rhs = tba.schur_reduce(u, g_c, v, g_r, w_blk, p.obs_cam, p.cam_free, torch.tensor(lam))
    dc = np.linalg.solve(n(s).astype(np.float64), n(rhs).astype(np.float64))
    k, m = p.cams.shape[0], p.rays.shape[0]
    nc = 3 * k
    h = np.zeros((nc + 2 * m, nc + 2 * m))
    g = np.concatenate([-n(g_c).reshape(-1), -n(g_r).reshape(-1)]).astype(np.float64)

    def damp(hb):
        return hb + lam * np.diag(np.diag(hb)) + 1e-8 * np.eye(hb.shape[0])

    for i in range(k):
        h[3 * i:3 * i + 3, 3 * i:3 * i + 3] = damp(n(u)[i].astype(np.float64))
    oc, w64 = n(p.obs_cam), n(w_blk).astype(np.float64)
    for j in range(m):
        h[nc + 2 * j:nc + 2 * j + 2, nc + 2 * j:nc + 2 * j + 2] = damp(n(v)[j].astype(np.float64))
        for c in range(oc.shape[1]):
            i = oc[j, c]
            h[3 * i:3 * i + 3, nc + 2 * j:nc + 2 * j + 2] += w64[j, c]
            h[nc + 2 * j:nc + 2 * j + 2, 3 * i:3 * i + 3] += w64[j, c].T
    for i in np.flatnonzero(~n(p.cam_free)):
        h[3 * i:3 * i + 3, :] = 0
        h[:, 3 * i:3 * i + 3] = 0
        h[3 * i:3 * i + 3, 3 * i:3 * i + 3] = np.eye(3)
        g[3 * i:3 * i + 3] = 0
    np.testing.assert_allclose(dc, np.linalg.solve(h, g)[:nc], rtol=2e-3, atol=2e-5)


def _init_both(seq, subset, obs0, mask0, cfg):
    """The same frame-0 state in both packages: init + insert the frame's
    slot observations."""
    s_j = jekf.init_state(jnp.asarray(seq.cameras[0]), cfg)
    s_j = jekf.insert_rays(s_j, jnp.asarray(obs0), jnp.asarray(mask0), jnp.asarray(subset, jnp.int32), seq.intr, cfg)
    pc, pi = port_cfg(cfg), port_intr(seq.intr)
    s_t = tekf.init_state(seq.cameras[0], pc, device="cpu")
    s_t = tekf.insert_rays(s_t, t(obs0), t(mask0), t(np.asarray(subset, np.int32)), pi, pc)
    return s_j, s_t


@pytest.mark.parametrize(
    "noise, outlier_frac, blackout",
    [(0.0, 0.0, None), (0.5, 0.0, None), (0.5, 0.1, None), (0.5, 0.0, 15)],
)
def test_scan_track_matches_reference(noise, outlier_frac, blackout):
    """tests/test_ekf.py's tracking runs (noiseless, noisy, 10% outliers,
    and every observation gone from frame 15): poses within 5e-4 rad and
    2 px of the reference, the same lost flags, and the reference test's
    bounds; the final covariance finite and symmetric."""
    t_len = 30 if blackout else 90
    seq, subset, obs, mask = make_test_problem(T=t_len, noise=noise, outlier_frac=outlier_frac)
    cfg = SLAMConfig(max_rays=96, sigma_obs=max(noise, 0.3), min_inliers=12 if blackout else 10)
    if blackout:
        mask[blackout:] = False
    s_j, s_t = _init_both(seq, subset, obs[0], mask[0], cfg)
    fin_j, (poses_j, st_j) = jax.jit(lambda s, o, m: jekf.scan_track(s, o, m, seq.intr, cfg))(
        s_j, jnp.asarray(obs[1:]), jnp.asarray(mask[1:])
    )
    fin_t, (poses_t, st_t) = tekf.scan_track(s_t, t(obs[1:]), t(mask[1:]), port_intr(seq.intr), port_cfg(cfg))
    np.testing.assert_array_equal(n(st_t.lost), np.asarray(st_j.lost))
    d = np.abs(n(poses_t) - np.asarray(poses_j))
    assert d[:, :2].max() < 5e-4 and d[:, 2].max() < 2.0, d.max(0)
    err = np.abs(n(poses_t) - seq.cameras[1:])
    lost = n(st_t.lost)
    if blackout:
        assert not lost[:10].any() and lost[blackout:].all()
    elif noise == 0:
        assert not lost.any() and err[:, :2].max() < 2e-4 and err[:, 2].max() < 2.0, err.max(0)
    else:
        # the outliers may triple the clean run's pan error at most
        pan_bound = 3e-4 * (3 if outlier_frac else 1)
        assert not lost.any() and err[:, 0].mean() < pan_bound and err[:, 2].mean() < 6.0, err.mean(0)
    cov = n(fin_t.cov)
    assert np.isfinite(cov).all()
    np.testing.assert_allclose(cov, cov.T, atol=1e-5)


def test_step_retires_unobserved_slots():
    """tests/test_ekf.py's lifecycle through ``step``: every slot missed for
    more than ``max_missed`` frames is retired, as in the reference."""
    from ptzjax import synth

    seq = synth.make_sequence(num_frames=4, num_rays=300, seed=1)
    cfg = SLAMConfig(max_rays=16, max_missed=3)
    pix, _, ids = synth.render_frame(seq, 0, noise_px=0.0, seed=0)
    s_j, s_t = _init_both(seq, ids[:10], pix[:10], np.ones(10, bool), cfg)
    empty_obs, empty_mask = np.zeros((16, 2), np.float32), np.zeros(16, bool)
    pc, pi = port_cfg(cfg), port_intr(seq.intr)
    for _ in range(cfg.max_missed + 1):
        s_j, st_j = jekf.step(s_j, jnp.asarray(empty_obs), jnp.asarray(empty_mask), seq.intr, cfg)
        s_t, st_t = tekf.step(s_t, t(empty_obs), t(empty_mask), pi, pc)
        assert bool(st_t.lost) == bool(st_j.lost)
        np.testing.assert_array_equal(n(s_t.missed), np.asarray(s_j.missed))
        np.testing.assert_allclose(n(s_t.cam), np.asarray(s_j.cam), rtol=1e-6, atol=1e-6)
    s_t = tekf.retire_lost(s_t, pc)
    assert int(s_t.active.sum()) == 0 and (n(s_t.ray_ids) == -1).all()


@pytest.mark.parametrize("n_rays, seed", [(24, 0), (256, 1)])
def test_update_matches_dense_fp64_oracle(n_rays, seed):
    """The port's structured update against the textbook dense-H Joseph
    update in fp64 NumPy, with the same gate decisions (tests/test_ekf.py's
    oracle at 24 rays with 3 inactive slots and one unobserved; at the
    product's 256 rays, benchmarks/bench_suite.py's). Tolerances are
    tests/test_ekf.py's: cam and rays rtol 1e-4 / atol 1e-5, cov rtol 2e-3 /
    atol 2e-4."""
    cfg = port_cfg(SLAMConfig(max_rays=n_rays, sigma_obs=1.0, min_inliers=2, innovation_gate_px=1e6, gate_maha2=1e9))
    d = 6 + 2 * n_rays
    intr = Intrinsics.create(640.0, 360.0)
    rng = np.random.default_rng(seed)
    rays = np.stack([rng.uniform(0.0, 0.2, n_rays), rng.uniform(-0.15, 0.0, n_rays)], -1).astype(np.float32)
    a = rng.normal(size=(d, d)).astype(np.float32) * 0.01
    cov = a @ a.T + np.diag(rng.uniform(0.3, 1.0, d)).astype(np.float32)
    cov = (0.5 * (cov + cov.T)).astype(np.float32)
    active = np.ones(n_rays, bool)
    obs_mask = np.ones(n_rays, bool)
    if n_rays == 24:
        active[-3:] = False
        obs_mask[0] = False
    state = tekf.init_state(np.array([0.1, -0.05, 2000.0], np.float32), cfg, device="cpu")
    state = state._replace(
        rays=t(rays), cov=t(cov), active=t(active),
        ray_ids=torch.where(t(active), torch.arange(n_rays, dtype=torch.int32), -1),
    )
    pose = np.array([0.1, -0.05, 2000.0], np.float32)
    pred = np.asarray(project_rays(jnp.asarray(pose), jnp.asarray(rays), intr))
    obs = (pred + rng.normal(0, 1.0, pred.shape)).astype(np.float32)
    new, stats = tekf.update(state, t(obs), t(obs_mask), port_intr(intr), cfg)
    used = n(stats.used_mask)
    assert used.sum() >= n_rays - 5

    _, j_cam, j_ray = project_jacobians(jnp.asarray(pose), jnp.asarray(rays), intr)
    jc = np.asarray(j_cam, np.float64) * used[:, None, None]
    jr = np.asarray(j_ray, np.float64) * used[:, None, None]
    idx = np.arange(n_rays)
    h = np.zeros((2 * n_rays, d))
    h[idx, 0:3] = jc[:, 0]
    h[n_rays + idx, 0:3] = jc[:, 1]
    h[idx, 6 + idx] = jr[:, 0, 0]
    h[idx, 6 + n_rays + idx] = jr[:, 0, 1]
    h[n_rays + idx, 6 + idx] = jr[:, 1, 0]
    h[n_rays + idx, 6 + n_rays + idx] = jr[:, 1, 1]
    p = cov.astype(np.float64)
    r = np.eye(2 * n_rays)
    innov2 = np.where(used[:, None], obs - pred, 0.0)
    k = p @ h.T @ np.linalg.inv(h @ p @ h.T + r)
    dx = k @ np.concatenate([innov2[:, 0], innov2[:, 1]])
    ikh = np.eye(d) - k @ h
    np.testing.assert_allclose(n(new.cam)[:3], pose.astype(np.float64) + dx[:3], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(n(new.rays), rays + np.stack([dx[6:6 + n_rays], dx[6 + n_rays:]], -1), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(n(new.cov), ikh @ p @ ikh.T + k @ r @ k.T, rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("masked", [False, True])
def test_extract_sequence_matches_reference(masked):
    """``extract_sequence`` over 3 frames (with and without masks): the
    reference's tables (xy within 1e-3 px, descriptors within 1e-5, valid
    equal), and each frame's ``extract_features`` bitwise."""
    imgs, _, _ = render(3, seed=4)
    cfg = small_cfg()
    masks = None
    if masked:
        masks = np.ones(imgs.shape, bool)
        masks[:, 100:200, 300:500] = False
    want = j_extract_sequence(imgs, cfg, masks=masks, use_pallas=False)
    got = tfront.extract_sequence(imgs, port_cfg(cfg), masks=masks, device="cpu")
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    np.testing.assert_array_equal(n(got[2]), np.asarray(want[2]))
    np.testing.assert_allclose(n(got[0]), np.asarray(want[0]), atol=1e-3)
    np.testing.assert_allclose(n(got[1]), np.asarray(want[1]), atol=1e-5)
    for k in range(3):
        one = tfront.extract_features(t(imgs[k]), port_cfg(cfg), mask=None if masks is None else t(masks[k]))
        for a, b in zip(got, one):
            assert torch.equal(a[k], b)
