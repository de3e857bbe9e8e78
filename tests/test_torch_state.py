"""ptzjax_torch parity on the CPU from a shared SLAM state: the JAX package
tracks a short rendered sequence (with keyframe inserts, so the map holds
several keyframes), its state is carried into the port with
``ptzjax_torch.convert``, and the EKF update, the BA problem assembly, the
LM solver, the windowed BA and relocalization (map and nearest-keyframe)
then run in both packages on the same inputs."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptzjax import ba as jba
from ptzjax import ekf as jekf
from ptzjax import mapstore as jmap
from ptzjax import reloc as jreloc
from ptzjax import slam as jslam
from ptzjax.frontend import extract_features as j_extract
from ptzjax_torch import ba as tba
from ptzjax_torch import convert
from ptzjax_torch import ekf as tekf
from ptzjax_torch import mapstore as tmap
from ptzjax_torch import reloc as treloc
from ptzjax_torch import slam as tslam
from tests._torch_port import n, port_cfg, port_intr, render, small_cfg, t

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def shared():
    """(cfg, intr, frames, cams, host copy of the JAX state, the same state
    as jax arrays) after 14 frames with a keyframe every 4 frames."""
    imgs, cams, intr = render(30, seed=3)   # the 30-frame sweep: its per-frame motion tracks
    cfg = small_cfg(keyframe_interval=4)
    slam = jslam.PTZSlam(cfg, intr)
    state = slam.init(*j_extract(jnp.asarray(imgs[0]), cfg, use_pallas=False), cams[0])
    state, infos = slam.run_segment_pixels(state, jnp.asarray(imgs[1:15]), use_pallas=False)
    host = jax.device_get(state)
    assert not np.asarray(infos.lost).any() and int(host.kf.count) >= 3
    return slam.cfg, intr, imgs, cams, host, jax.tree_util.tree_map(jnp.asarray, host)


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def test_convert_round_trip_is_bitwise(shared):
    host = shared[4]
    back = convert.state_to_numpy(convert.state_from_jax_numpy(host, "cpu"))
    for a, b in zip(_leaves(host), _leaves(tuple(back))):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert len(_leaves(host)) == len(_leaves(tuple(back)))


def _observations(ekf_host, intr, seed=0):
    """Slot-aligned pixels: the projections of the active slots plus 1-px
    noise, with 10% gross outliers and 20% of the slots unobserved."""
    rng = np.random.default_rng(seed)
    from ptzjax.geometry import project_rays

    pix = np.asarray(project_rays(jnp.asarray(ekf_host.cam[:3]), jnp.asarray(ekf_host.rays), intr))
    nslot = pix.shape[0]
    obs = pix + rng.normal(scale=1.0, size=pix.shape) + np.array([0.8, -0.5])
    obs[rng.random(nslot) < 0.1] += 30.0
    mask = rng.random(nslot) > 0.2
    return obs.astype(np.float32), mask


def test_ekf_predict_update(shared):
    cfg, intr, _, _, host, jstate = shared
    obs, mask = _observations(host.ekf, intr)
    s_j, st_j = jekf.update(jekf.predict(jstate.ekf, cfg), jnp.asarray(obs), jnp.asarray(mask), intr, cfg)
    state_t = convert.state_from_jax_numpy(host, "cpu")
    pc = port_cfg(cfg)
    s_t, st_t = tekf.update(tekf.predict(state_t.ekf, pc), t(obs), t(mask), port_intr(intr), pc)
    assert int(st_j.num_used) > 30
    np.testing.assert_array_equal(n(st_t.used_mask), n(st_j.used_mask))
    assert bool(st_t.lost) == bool(st_j.lost)
    np.testing.assert_allclose(n(s_t.cam)[[0, 1, 3, 4]], n(s_j.cam)[[0, 1, 3, 4]], atol=1e-5)
    np.testing.assert_allclose(n(s_t.cam)[[2, 5]], n(s_j.cam)[[2, 5]], atol=1e-3)
    np.testing.assert_allclose(n(s_t.rays), n(s_j.rays), atol=1e-5)
    np.testing.assert_array_equal(n(s_t.missed), n(s_j.missed))

    cov_t, cov_j = n(s_t.cov), n(s_j.cov)
    focal = np.zeros(cov_t.shape[0], bool)
    focal[[2, 5]] = True                       # focal and its velocity, in px
    other = ~(focal[:, None] | focal[None, :])
    np.testing.assert_allclose(cov_t[other], cov_j[other], rtol=1e-4, atol=1e-9)
    # Focal rows/columns: a focal variance of ~1 px^2 against ray variances
    # of ~1e-6 rad^2. Measured against a float64 run, the fp32 Joseph-form
    # rounding of the focal x ray cross terms is ~1e-6 of their correlation
    # scale sqrt(P_ii P_jj) in BOTH packages (about 1e-9 absolute, beyond a
    # uniform atol of 1e-9), so these entries are held to rtol 1e-4 plus
    # 1e-5 of the correlation scale instead.
    scale = np.sqrt(np.outer(np.diag(cov_j), np.diag(cov_j)))
    err = np.abs(cov_t - cov_j) - 1e-4 * np.abs(cov_j) - 1e-5 * scale
    assert err[~other].max() <= 0, err[~other].max()

    # the port in float64 (same code, promoted) as an independent reference
    e64 = tekf.EKFState(*(v.double() if v.is_floating_point() else v for v in state_t.ekf))
    s_d, st_d = tekf.update(tekf.predict(e64, pc), t(obs).double(), t(mask), port_intr(intr), pc)
    assert s_d.cov.dtype == torch.float64
    np.testing.assert_array_equal(n(st_d.used_mask), n(st_t.used_mask))
    scale64 = np.sqrt(np.outer(np.diag(n(s_d.cov)), np.diag(n(s_d.cov))))
    assert (np.abs(cov_t - n(s_d.cov)) / scale64).max() < 1e-5


def test_non_pd_innovation_is_a_lost_no_op():
    """A non-PD S (negative ray variances) NaNs the Cholesky in both
    packages: the frame keeps the predicted state and is flagged LOST."""
    cfg = small_cfg(max_rays=16)
    from ptzjax.geometry import Intrinsics, back_project_pixels

    intr = Intrinsics.create(320.0, 180.0)
    nr = cfg.max_rays
    cam = np.array([0.05, -0.02, 1200.0, 0, 0, 0], np.float32)
    pix = np.random.default_rng(1).uniform([50, 50], [590, 310], (nr, 2)).astype(np.float32)
    rays = np.asarray(back_project_pixels(jnp.asarray(cam[:3]), jnp.asarray(pix), intr))
    cov = np.eye(6 + 2 * nr, dtype=np.float32) * 1e-6
    cov[6:, 6:] *= -1e4                                  # indefinite ray block
    fields = dict(
        cam=cam, rays=rays, cov=cov, active=np.ones(nr, bool),
        missed=np.zeros(nr, np.int32), rej=np.zeros(nr, np.int32),
        ray_ids=np.arange(nr, dtype=np.int32),
    )
    st_jax = jekf.EKFState(**{k: jnp.asarray(v) for k, v in fields.items()})
    st_port = tekf.EKFState(**{k: t(v) for k, v in fields.items()})
    new_j, stats_j = jekf.update(st_jax, jnp.asarray(pix), jnp.ones(nr, bool), intr, cfg)
    new_t, stats_t = tekf.update(st_port, t(pix), torch.ones(nr, dtype=torch.bool), port_intr(intr), port_cfg(cfg))
    for new, stats in ((new_j, stats_j), (new_t, stats_t)):
        assert bool(stats.lost)
        assert not n(stats.used_mask).any()
        np.testing.assert_array_equal(n(new.cam), cam)
        np.testing.assert_array_equal(n(new.cov), cov)
        np.testing.assert_array_equal(n(new.rays), rays)


def _perturbed_problem(shared):
    """The whole-map BA problem of the shared state with the free cameras
    and the rays perturbed, so that LM has work to do."""
    cfg, _, _, _, _, jstate = shared
    prob_j = jmap.build_ba_problem(jstate.kf, jstate.rays, max_views_per_ray=cfg.ba_max_views_per_ray)
    rng = np.random.default_rng(5)
    cams = np.asarray(prob_j.cams).copy()
    free = np.asarray(prob_j.cam_free)
    cams[free] += rng.normal(scale=[2e-3, 2e-3, 8.0], size=(free.sum(), 3)).astype(np.float32)
    rays = np.asarray(prob_j.rays) + rng.normal(scale=5e-4, size=prob_j.rays.shape).astype(np.float32)
    return prob_j._replace(cams=jnp.asarray(cams), rays=jnp.asarray(rays))


def test_build_ba_problem_tables_equal(shared):
    cfg, _, _, _, host, jstate = shared
    state_t = convert.state_from_jax_numpy(host, "cpu")
    for anchor_first in (True, False):
        ref = jmap.build_ba_problem(jstate.kf, jstate.rays, cfg.ba_max_views_per_ray, anchor_first)
        got = tmap.build_ba_problem(state_t.kf, state_t.rays, cfg.ba_max_views_per_ray, anchor_first)
        assert n(ref.obs_w).sum() > 100
        for a, b in zip(ref, got):
            assert n(a).dtype == n(b).dtype
            np.testing.assert_array_equal(n(b), n(a))


def test_ba_cost_at_every_lm_iteration(shared):
    cfg, intr, _, _, _, _ = shared
    cfg = cfg.replace(ba_iters=8)
    prob_j = _perturbed_problem(shared)
    prob_t = tba.BAProblem(*(t(x) for x in prob_j))
    pc, pi = port_cfg(cfg), port_intr(intr)
    step_j = jax.jit(lambda p, lm: jba.run_lm(p, intr, cfg, lm, num_iters=1))
    lm_j = jba.init_lm_state(prob_j, intr, cfg)
    lm_t = tba.init_lm_state(prob_t, pi, pc)
    costs_j, costs_t = [float(lm_j.cost)], [float(lm_t.cost)]
    for _ in range(cfg.ba_iters):
        lm_j = step_j(prob_j, lm_j)
        lm_t = tba.run_lm(prob_t, pi, pc, lm_t, num_iters=1)
        costs_j.append(float(lm_j.cost))
        costs_t.append(float(lm_t.cost))
    assert costs_j[-1] < 0.1 * costs_j[0]
    np.testing.assert_allclose(costs_t, costs_j, rtol=1e-4)
    res = tba.run(prob_t, pi, pc)
    assert float(res.cost) == costs_t[-1] and int(res.iterations) == cfg.ba_iters
    assert int(res.accepted) == int(lm_j.accepted)
    np.testing.assert_allclose(n(res.cams), n(lm_j.cams), atol=1e-4, rtol=1e-6)


def test_windowed_ba(shared):
    cfg, intr, _, _, host, jstate = shared
    wba = jax.jit(partial(jslam._windowed_ba, cfg=cfg, intr=intr))
    ref = jax.device_get(wba(jstate))
    got = tslam._windowed_ba(convert.state_from_jax_numpy(host, "cpu"), cfg=port_cfg(cfg), intr=port_intr(intr))
    np.testing.assert_allclose(n(got.kf.poses)[:, :2], ref.kf.poses[:, :2], atol=1e-5)
    np.testing.assert_allclose(n(got.kf.poses)[:, 2], ref.kf.poses[:, 2], atol=1e-2)
    np.testing.assert_allclose(n(got.rays.rays), ref.rays.rays, atol=1e-5)
    np.testing.assert_allclose(n(got.ekf.cam), ref.ekf.cam, atol=1e-3)
    assert bool(got.lost) == bool(ref.lost)


def test_relocalize(shared):
    """A frame further along the sequence, relocalized against the map."""
    cfg, intr, imgs, cams, host, jstate = shared
    focal = jnp.asarray(cams[15][2])
    xy, desc, valid = j_extract(jnp.asarray(imgs[15]), cfg, use_pallas=False, focal=focal)
    ref = jreloc.relocalize(desc, xy, valid, jstate.rays, intr, cfg)
    state_t = convert.state_from_jax_numpy(host, "cpu")
    got = treloc.relocalize(t(desc), t(xy), t(valid), state_t.rays, port_intr(intr), port_cfg(cfg))
    assert bool(ref.success) and bool(got.success)
    np.testing.assert_allclose(n(got.pose)[:2], n(ref.pose)[:2], atol=1e-4)
    np.testing.assert_allclose(n(got.pose)[2], n(ref.pose)[2], atol=0.5)
    assert abs(int(got.inliers) - int(ref.inliers)) <= 2
    err = np.abs(n(got.pose) - cams[15])
    assert err[0] < 2e-3 and err[1] < 2e-3 and err[2] < 30.0, err


def test_relocalize_branch_rebuilds_the_filter(shared):
    """The lost-frame branch of the loop (``slam._relocalize``): on success
    both packages re-initialize the EKF at the recovered pose and seed the
    same slots with the same map rays and descriptors."""
    cfg, intr, imgs, cams, host, jstate = shared
    xy, desc, valid = j_extract(jnp.asarray(imgs[15]), cfg, use_pallas=False, focal=jnp.asarray(cams[15][2]))
    reloc_j = jax.jit(partial(jslam._relocalize, cfg=cfg, intr=intr))
    ref_state, ref_info = jax.device_get(reloc_j(jstate._replace(lost=jnp.asarray(True)), xy, desc, valid))
    lost_t = convert.state_from_jax_numpy(host, "cpu")._replace(lost=torch.tensor(True))
    got_state, got_info, _ = tslam._relocalize(
        lost_t, t(xy), t(desc), t(valid), cfg=port_cfg(cfg), intr=port_intr(intr)
    )
    assert bool(ref_info.reloc_success) and bool(got_info.reloc_success)
    assert int(got_info.event) == int(ref_info.event) == 1
    assert not bool(got_state.lost) and int(got_state.frame_idx) == int(ref_state.frame_idx)
    np.testing.assert_allclose(n(got_info.pose)[:2], ref_info.pose[:2], atol=1e-4)
    np.testing.assert_allclose(n(got_info.pose)[2], ref_info.pose[2], atol=0.5)
    np.testing.assert_array_equal(n(got_state.ekf.ray_ids), ref_state.ekf.ray_ids)
    np.testing.assert_array_equal(n(got_state.ekf.active), ref_state.ekf.active)
    np.testing.assert_array_equal(n(got_state.ekf.rays), ref_state.ekf.rays)
    np.testing.assert_allclose(n(got_state.slot_desc), ref_state.slot_desc, atol=1e-6)


def test_relocalize_keyframes(shared):
    """The nearest-keyframe backend on a frame further along the sequence:
    the flat (Q, K*F) one-way match, the per-keyframe vote, the keyframe-pose
    seed and the focal-grid fallback give the same result in both packages."""
    cfg, intr, imgs, cams, host, jstate = shared
    xy, desc, valid = j_extract(jnp.asarray(imgs[15]), cfg, use_pallas=False, focal=jnp.asarray(cams[15][2]))
    ref = jreloc.relocalize_keyframes(desc, xy, valid, jstate.kf, jstate.rays, intr, cfg)
    state_t = convert.state_from_jax_numpy(host, "cpu")
    got = treloc.relocalize_keyframes(
        t(desc), t(xy), t(valid), state_t.kf, state_t.rays, port_intr(intr), port_cfg(cfg)
    )
    assert bool(ref.success) and bool(got.success)
    np.testing.assert_allclose(n(got.pose)[:2], n(ref.pose)[:2], atol=1e-4)
    np.testing.assert_allclose(n(got.pose)[2], n(ref.pose)[2], atol=0.5)
    assert int(got.inliers) == int(ref.inliers)
    np.testing.assert_array_equal(n(got.matched_ray_ids), n(ref.matched_ray_ids))
    np.testing.assert_array_equal(n(got.matched_ok), n(ref.matched_ok))
    err = np.abs(n(got.pose) - cams[15])
    assert err[0] < 2e-3 and err[1] < 2e-3 and err[2] < 30.0, err


def test_keyframe_reloc_mode_rebuilds_the_filter(shared):
    """``PTZSlam`` accepts ``reloc_mode="keyframe"``, and the lost-frame branch
    dispatches to the nearest-keyframe backend in both packages."""
    cfg, intr, imgs, cams, host, jstate = shared
    cfg = cfg.replace(reloc_mode="keyframe")
    assert tslam.PTZSlam(port_cfg(cfg), port_intr(intr), device="cpu").cfg.reloc_mode == "keyframe"
    xy, desc, valid = j_extract(jnp.asarray(imgs[15]), cfg, use_pallas=False, focal=jnp.asarray(cams[15][2]))
    reloc_j = jax.jit(partial(jslam._relocalize, cfg=cfg, intr=intr))
    ref_state, ref_info = jax.device_get(reloc_j(jstate._replace(lost=jnp.asarray(True)), xy, desc, valid))
    lost_t = convert.state_from_jax_numpy(host, "cpu")._replace(lost=torch.tensor(True))
    got_state, got_info, _ = tslam._relocalize(
        lost_t, t(xy), t(desc), t(valid), cfg=port_cfg(cfg), intr=port_intr(intr)
    )
    assert bool(ref_info.reloc_success) and bool(got_info.reloc_success)
    assert int(got_info.num_used) == int(ref_info.num_used)
    np.testing.assert_allclose(n(got_info.pose)[:2], ref_info.pose[:2], atol=1e-4)
    np.testing.assert_array_equal(n(got_state.ekf.ray_ids), ref_state.ekf.ray_ids)
    np.testing.assert_array_equal(n(got_state.ekf.rays), ref_state.ekf.rays)
    np.testing.assert_allclose(n(got_state.slot_desc), ref_state.slot_desc, atol=1e-6)
