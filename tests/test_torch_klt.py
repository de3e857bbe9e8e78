"""KLT mode and whole-map BA in the port against the JAX package, on the CPU:
``frontend.track_features``, ``PTZSlam.run_segment_pixels_klt``,
``ba.huber_factors`` / ``run_robust``, ``mapstore.apply_ba_result`` and
``PTZSlam.bundle_adjust``.

Tolerances: keypoint positions within 1e-3 px and descriptors within 1e-5
(the flow and descriptor tests' own); flags equal and poses within 5e-4 rad
and 2 px over a run (the re-detect slice test's); BA costs within rtol 1e-4
at every IRLS round (the LM test's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptzjax import ba as jba
from ptzjax import mapstore as jmap
from ptzjax.frontend import extract_features as j_extract
from ptzjax.frontend import track_features as j_track
from ptzjax.slam import PTZSlam as JaxSlam
from ptzjax_torch import ba as tba
from ptzjax_torch import frontend as tfront
from ptzjax_torch import mapstore as tmap
from ptzjax_torch import slam as tslam
from tests._torch_port import n, port_cfg, port_intr, render, small_cfg, t

torch.set_num_threads(2)

FRAMES = 20


@pytest.fixture(scope="module")
def seq():
    """21 frames of a slow pan/zoom sweep (pan_amp 0.02, f_amp 8, seed 4)."""
    return render(FRAMES + 1, pan_amp=0.02, f_amp=8.0, seed=4)


def test_track_features_matches():
    """Five KLT steps over a 6-frame render of the sweep, each package
    carrying its own table: ``tracked`` and ``valid`` equal, positions within
    1e-3 px, descriptors within 1e-5."""
    imgs, cams, _ = render(6, pan_amp=0.02, f_amp=8.0, seed=4)
    cfg = small_cfg(descriptor_f_ref=float(cams[0][2]))
    pc = port_cfg(cfg)
    xy_j, _, v_j = j_extract(jnp.asarray(imgs[0]), cfg, use_pallas=False)
    v_j = v_j.at[-30:].set(False)        # free rows for the refill to pack into
    xy_t, v_t = t(xy_j), t(v_j)
    for i in range(1, 6):
        f = np.float32(cams[i][2])
        xy_j, d_j, v_j, tr_j = j_track(
            jnp.asarray(imgs[i - 1]), jnp.asarray(imgs[i]), xy_j, v_j, cfg,
            use_pallas=False, focal=jnp.asarray(f),
        )
        xy_t, d_t, v_t, tr_t = tfront.track_features(t(imgs[i - 1]), t(imgs[i]), xy_t, v_t, pc, focal=torch.tensor(f))
        np.testing.assert_array_equal(n(tr_t), n(tr_j))
        np.testing.assert_array_equal(n(v_t), n(v_j))
        np.testing.assert_allclose(n(xy_t), n(xy_j), atol=1e-3, rtol=0)
        np.testing.assert_allclose(n(d_t), n(d_j), atol=1e-5, rtol=0)
        assert n(tr_t).sum() > 100                       # tracks survive
        if i == 1:
            assert n(v_t).sum() > n(tr_t).sum() + 10     # refills land in the free rows


def test_track_features_mask_restricts_the_refill(seq):
    """A refill mask keeps fresh detections out of the masked boxes; tracked
    rows keep their tracks wherever they are."""
    imgs, cams, _ = seq
    cfg = port_cfg(small_cfg(descriptor_f_ref=float(cams[0][2])))
    xy0, _, v0 = tfront.extract_features(t(imgs[0]), cfg)
    mask = np.ones(imgs[1].shape, bool)
    mask[:, 320:] = False
    xy, _, valid, tracked = tfront.track_features(t(imgs[0]), t(imgs[1]), xy0, v0, cfg, mask=t(mask))
    fresh = n(valid) & ~n(tracked)
    assert fresh.sum() > 0 and (n(xy)[fresh, 0] < 320).all()


@pytest.fixture(scope="module")
def klt_runs(seq):
    """The JAX package's and the port's KLT runs over the 20 frames after
    the ``init`` frame, each seeded with its own frame-0 features; a keyframe
    every 6 frames so inserts and windowed BA run inside the loop."""
    imgs, cams, intr = seq
    cfg = small_cfg(keyframe_interval=6)
    jslam = JaxSlam(cfg, intr)
    xy0, d0, v0 = j_extract(jnp.asarray(imgs[0]), cfg, use_pallas=False)
    jstate = jslam.init(xy0, d0, v0, cams[0])
    jstate, jinfos, jxy, jvalid = jslam.run_segment_pixels_klt(
        jstate, jnp.asarray(imgs[1:]), jnp.asarray(imgs[0]), xy0, v0, use_pallas=False
    )
    ref = (jax.device_get(jstate), jax.device_get(jinfos), np.asarray(jxy), np.asarray(jvalid))

    slam = tslam.PTZSlam(port_cfg(cfg), port_intr(intr), device="cpu")
    xy0, d0, v0 = tfront.extract_features(t(imgs[0]), slam.cfg)
    state = slam.init(xy0, d0, v0, cams[0])
    got = slam.run_segment_pixels_klt(state, t(imgs[1:]), t(imgs[0]), xy0, v0)
    return ref, got, (slam, state, xy0, v0)


def test_klt_segment_matches_reference(seq, klt_runs):
    _, cams, _ = seq
    (jstate, jinfos, jxy, jvalid), (state, infos, xy, valid), _ = klt_runs
    got = tslam.FrameInfo(*(n(v) for v in infos))
    np.testing.assert_array_equal(got.lost, jinfos.lost)
    np.testing.assert_array_equal(got.event, jinfos.event)
    np.testing.assert_array_equal(got.keyframe, jinfos.keyframe)
    assert got.keyframe.sum() >= 2                          # windowed BA ran in the loop
    dpose = np.abs(got.pose - jinfos.pose)
    assert dpose[:, :2].max() < 5e-4 and dpose[:, 2].max() < 2.0, dpose.max(0)
    np.testing.assert_array_equal(n(valid), jvalid)
    np.testing.assert_allclose(n(xy)[jvalid], jxy[jvalid], atol=1e-3)
    np.testing.assert_array_equal(n(state.rays.valid), jstate.rays.valid)
    np.testing.assert_array_equal(n(state.kf.valid), jstate.kf.valid)
    # the port alone tracks the sequence
    assert not got.lost.any()
    assert np.abs(got.pose[:, 0] - cams[1:, 0]).mean() < 2.5e-3


def test_klt_padding_frames_pass_state_and_carry_through(seq, klt_runs):
    """Frames marked False are no-ops for the state AND the carried table:
    a run with padding frames equals the run of its real frames alone."""
    imgs, _, _ = seq
    slam, state, xy0, v0 = klt_runs[2]
    ok = np.array([True, False, True, False, True])
    out, infos, xy, valid = slam.run_segment_pixels_klt(state, t(imgs[1:6]), t(imgs[0]), xy0, v0, frame_ok=ok)
    assert n(infos.event).tolist() == [0, 2, 0, 2, 0]
    np.testing.assert_array_equal(n(infos.pose)[1], n(infos.pose)[0])
    real, r_infos, r_xy, r_valid = slam.run_segment_pixels_klt(state, t(imgs[[1, 3, 5]]), t(imgs[0]), xy0, v0)
    np.testing.assert_array_equal(n(infos.pose)[ok], n(r_infos.pose))
    assert torch.equal(xy, r_xy) and torch.equal(valid, r_valid)
    assert torch.equal(out.ekf.cam, real.ekf.cam) and int(out.frame_idx) == int(real.frame_idx) == 3
    # a trailing padding frame: the table of the last REAL frame rides out
    _, _, xy_p, valid_p = slam.run_segment_pixels_klt(
        state, t(imgs[[1, 3, 5, 6]]), t(imgs[0]), xy0, v0, frame_ok=np.array([True, True, True, False])
    )
    assert torch.equal(xy_p, r_xy) and torch.equal(valid_p, r_valid)


def test_klt_numpy_inputs_match_the_tensor_run(seq, klt_runs):
    imgs, _, _ = seq
    slam, state, xy0, v0 = klt_runs[2]
    a = slam.run_segment_pixels_klt(state, t(imgs[1:4]), t(imgs[0]), xy0, v0)
    b = slam.run_segment_pixels_klt(
        state, imgs[1:4], imgs[0], n(xy0), n(v0), masks=np.ones(imgs[1:4].shape, bool)
    )
    for u, v in zip(a[1], b[1]):
        assert torch.equal(u, v)
    assert torch.equal(a[2], b[2]) and torch.equal(a[3], b[3])


# --- whole-map BA -------------------------------------------------------------


def _outlier_problem(klt_runs):
    """The whole-map BA problem of the JAX run's final state with the free
    cameras and the rays perturbed, and ~5% of the observations moved 30 px."""
    jstate = klt_runs[0][0]
    cfg = small_cfg()
    prob = jmap.build_ba_problem(
        jax.tree_util.tree_map(jnp.asarray, jstate.kf), jax.tree_util.tree_map(jnp.asarray, jstate.rays),
        max_views_per_ray=cfg.ba_max_views_per_ray,
    )
    rng = np.random.default_rng(11)
    cams = np.asarray(prob.cams).copy()
    free = np.asarray(prob.cam_free)
    cams[free] += rng.normal(scale=[1e-3, 1e-3, 4.0], size=(free.sum(), 3)).astype(np.float32)
    rays = np.asarray(prob.rays) + rng.normal(scale=3e-4, size=prob.rays.shape).astype(np.float32)
    pix = np.asarray(prob.obs_pix).copy()
    w = np.asarray(prob.obs_w)
    moved = (w > 0) & (rng.random(w.shape) < 0.05)
    ang = rng.uniform(0, 2 * np.pi, w.shape)
    pix[moved] += 30.0 * np.stack([np.cos(ang), np.sin(ang)], -1)[moved]
    assert w.sum() > 200 and moved.sum() > 10
    return prob._replace(cams=jnp.asarray(cams), rays=jnp.asarray(rays), obs_pix=jnp.asarray(pix.astype(np.float32)))


def test_huber_factors_and_robust_ba_at_every_round(seq, klt_runs):
    """Each IRLS round in both packages: the Huber factors, then the LM
    costs at its start and end; then ``run_robust`` end to end."""
    intr = seq[2]
    cfg = small_cfg(ba_huber_px=2.0, ba_iters=8)
    pc, pi = port_cfg(cfg), port_intr(intr)
    prob_j = _outlier_problem(klt_runs)
    prob_t = tba.BAProblem(*(t(x) for x in prob_j))
    base_j, base_t = prob_j.obs_w, prob_t.obs_w
    run_j = jax.jit(lambda p: jba.run(p, intr, cfg))
    for _ in range(cfg.ba_irls_rounds):
        wh_j = jba.huber_factors(prob_j.cams, prob_j.rays, prob_j._replace(obs_w=base_j), intr, cfg.ba_huber_px)
        wh_t = tba.huber_factors(prob_t.cams, prob_t.rays, prob_t._replace(obs_w=base_t), pi, cfg.ba_huber_px)
        np.testing.assert_allclose(n(wh_t), n(wh_j), rtol=1e-4, atol=1e-6)
        assert (n(wh_t) < 1).sum() > 10                  # the moved observations are down-weighted
        prob_j = prob_j._replace(obs_w=base_j * wh_j)
        prob_t = prob_t._replace(obs_w=base_t * wh_t)
        res_j, res_t = run_j(prob_j), tba.run(prob_t, pi, pc)
        np.testing.assert_allclose(
            [float(res_t.initial_cost), float(res_t.cost)], [float(res_j.initial_cost), float(res_j.cost)], rtol=1e-4
        )
        prob_j = prob_j._replace(cams=res_j.cams, rays=res_j.rays)
        prob_t = prob_t._replace(cams=res_t.cams, rays=res_t.rays)

    p0 = _outlier_problem(klt_runs)
    ref = jba.run_robust(p0, intr, cfg)
    got = tba.run_robust(tba.BAProblem(*(t(x) for x in p0)), pi, pc)
    np.testing.assert_allclose(float(got.initial_cost), float(ref.initial_cost), rtol=1e-4)
    np.testing.assert_allclose(float(got.cost), float(ref.cost), rtol=1e-4)
    np.testing.assert_allclose(n(got.cams)[:, :2], n(ref.cams)[:, :2], atol=1e-5)
    np.testing.assert_allclose(n(got.rays), n(ref.rays), atol=1e-5)
    # rounds=0 is the plain LM solve
    plain = tba.run_robust(tba.BAProblem(*(t(x) for x in p0)), pi, pc, rounds=0)
    assert float(plain.cost) == float(tba.run(tba.BAProblem(*(t(x) for x in p0)), pi, pc).cost)


def test_apply_ba_result_matches(klt_runs):
    jstate = klt_runs[0][0]
    jkf, jrays = (jax.tree_util.tree_map(jnp.asarray, x) for x in (jstate.kf, jstate.rays))
    rng = np.random.default_rng(2)
    k, m = jstate.kf.poses.shape[0], jstate.rays.rays.shape[0]
    cams = rng.normal(size=(k, 3)).astype(np.float32)
    rays = rng.normal(size=(m, 2)).astype(np.float32)
    obs_w = (rng.random((m, 8)) < 0.05).astype(np.float32)
    ref = jmap.apply_ba_result(jkf, jrays, jnp.asarray(cams), jnp.asarray(rays), jnp.asarray(obs_w))
    kf_t = tmap.KeyframeStore(*(t(x) for x in jstate.kf))
    rays_t = tmap.RayStore(*(t(x) for x in jstate.rays))
    got = tmap.apply_ba_result(kf_t, rays_t, t(cams), t(rays), t(obs_w))
    for r, g in zip(ref, got):
        for a, b in zip(r, g):
            np.testing.assert_array_equal(n(b), n(a))
    assert 0 < n(got[0].valid).sum() < k                 # some keyframes keep their poses


@pytest.mark.parametrize("huber_px", [0.0, 2.0])
def test_bundle_adjust_after_the_run(seq, klt_runs, huber_px):
    """``PTZSlam.bundle_adjust`` on each package's own final state of the
    20-frame run: the same costs, and the refined keyframe poses agree."""
    _, _, intr = seq
    jstate = jax.tree_util.tree_map(jnp.asarray, klt_runs[0][0])
    cfg = small_cfg(keyframe_interval=6, ba_huber_px=huber_px)
    jslam = JaxSlam(cfg, intr)
    jout, jcost = jslam.bundle_adjust(jstate)
    slam = tslam.PTZSlam(port_cfg(cfg), port_intr(intr), device="cpu")
    out, cost = slam.bundle_adjust(klt_runs[1][0])
    assert set(cost) == {"ba_cost_before", "ba_cost_after"}
    assert all(isinstance(v, float) and np.isfinite(v) for v in cost.values())
    assert cost["ba_cost_after"] <= cost["ba_cost_before"]
    np.testing.assert_allclose(cost["ba_cost_before"], jcost["ba_cost_before"], rtol=2e-2)
    np.testing.assert_allclose(cost["ba_cost_after"], jcost["ba_cost_after"], rtol=2e-2)
    np.testing.assert_allclose(n(out.kf.poses)[:, :2], np.asarray(jout.kf.poses)[:, :2], atol=5e-4)
    np.testing.assert_allclose(n(out.kf.poses)[:, 2], np.asarray(jout.kf.poses)[:, 2], atol=2.0)
    np.testing.assert_array_equal(n(out.kf.poses)[0], n(klt_runs[1][0].kf.poses)[0])   # the gauge
